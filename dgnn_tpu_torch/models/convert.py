"""Flax GAT parameters (as numpy) -> ``models.GAT`` state dict.

Maps ``params["gat_<l>"]`` / ``params["gat_out"]`` of a
``dgnn_tpu.models.GAT`` onto ``convs.gat_<l>`` / ``convs.gat_out``:
``W/kernel`` [in, out] is transposed into ``nn.Linear``'s [out, in] weight,
``attn_l``, ``attn_r`` and ``bias`` keep their (1, H, F) shape.  With the
result loaded, both packages compute the same function.  Reads arrays
through ``numpy.asarray`` only, so it needs no JAX import.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flax_gat_state_dict", "load_flax_gat"]


def flax_gat_state_dict(params) -> dict:
    """State dict for ``models.GAT`` from flax GAT params (the dict that
    ``model.init`` returns, or its ``"params"`` entry)."""
    if "params" in params:
        params = params["params"]
    sd = {}
    for name, layer in params.items():
        unknown = set(layer) - {"W", "attn_l", "attn_r", "bias"}
        if unknown:
            raise ValueError(f"{name}: parameters {sorted(unknown)} have no "
                             "counterpart in dgnn_tpu_torch's GATConv")
        pre = f"convs.{name}."
        kernel = np.asarray(layer["W"]["kernel"], np.float32)
        sd[pre + "W.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
        for key in ("attn_l", "attn_r", "bias"):
            if key in layer:
                sd[pre + key] = torch.from_numpy(
                    np.array(layer[key], np.float32))
    return sd


def load_flax_gat(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load flax GAT params into ``model`` (strict: every key must match)."""
    model.load_state_dict(flax_gat_state_dict(params), strict=True)
    return model
