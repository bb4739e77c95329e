"""Checkpoints on ``torch.save`` / ``torch.load`` (port of
``dgnn_tpu/utils/checkpoint.py``, which wraps orbax).

``CheckpointManager`` keeps the JAX package's interface: periodic saves of
a state (nested dicts, lists and tuples of tensors and plain values) under
a step, the newest ``max_to_keep`` steps kept, and restore of the latest
step into a template of the same structure.  Each step is one file,
``step_<step>.pt`` in the directory, written to a temporary name and
renamed, so a reader never sees half a checkpoint.  Saves are synchronous:
``wait`` has nothing to wait for, and ``close`` nothing to release.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Optional

import torch

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"step_(\d+)\.pt")


def _like(value, template, where: str = "state"):
    """``value`` in the structure of ``template``: each tensor on the
    template tensor's device and dtype, its shape checked."""
    if isinstance(template, torch.Tensor):
        if not isinstance(value, torch.Tensor) \
                or value.shape != template.shape:
            got = (tuple(value.shape) if isinstance(value, torch.Tensor)
                   else type(value).__name__)
            raise ValueError(f"checkpoint {where}: {got}, template "
                             f"{tuple(template.shape)}")
        return value.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        if not isinstance(value, dict) or value.keys() != template.keys():
            raise ValueError(f"checkpoint {where}: keys differ from the "
                             "template's")
        return {k: _like(value[k], t, f"{where}[{k!r}]")
                for k, t in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(value, (list, tuple)) \
                or len(value) != len(template):
            raise ValueError(f"checkpoint {where}: length differs from the "
                             "template's")
        return type(template)(_like(v, t, f"{where}[{i}]")
                              for i, (v, t) in enumerate(zip(value,
                                                             template)))
    return value


class CheckpointManager:
    """Step-numbered checkpoints of a state in one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        if max_to_keep < 1 or save_interval_steps < 1:
            raise ValueError("max_to_keep and save_interval_steps must be "
                             "at least 1")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def all_steps(self) -> list:
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(
            _NAME.fullmatch, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save ``state`` under ``step`` when ``force`` or when the step is
        a multiple of ``save_interval_steps``; returns whether it saved.
        Steps beyond the newest ``max_to_keep`` are deleted."""
        if not force and step % self.save_interval_steps:
            return False
        path = self._path(step)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            self._path(old).unlink(missing_ok=True)
        return True

    def restore_latest(self, template: Any) -> Optional[tuple]:
        """(step, state) of the newest checkpoint, or None if there is none.

        ``template`` has the saved state's structure: each restored tensor
        takes its template tensor's device and dtype; a shape or structure
        that differs raises."""
        step = self.latest_step()
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        return step, _like(state, template)

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing held open."""
