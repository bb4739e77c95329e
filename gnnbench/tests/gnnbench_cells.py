"""Cells of the benchmark at a size the CPU holds, for the tests: the
benchmark's own configurations, references, metrics and limits copied
into a temporary folder beside traffic files cut to a tiny graph."""

import json
import shutil
import sys
import time
from pathlib import Path

import torch

FOLDER = Path(__file__).resolve().parents[1]
ROOT = FOLDER.parent
sys.path.insert(0, str(ROOT))
torch.set_num_threads(2)

from gnnbench.harness import Bench, run_cell  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# the graphs the CPU holds: R-MAT cut to a tiny graph, which keeps a hub
# block; the citation graph at its own size, which keeps none (cut, it
# would keep one)
TINY = {"rmat": dict(num_nodes=300, edge_draws=6000), "citation": {}}


def tiny_bench(tmp: Path, dense=..., gather_dtype=None,
               extra_cells=()) -> Bench:
    """The benchmark's cells over tiny graphs in ``tmp``; ``dense`` and
    ``gather_dtype``, where given, replace every configuration's and
    traffic's (dense None: no hub block)."""
    for d in ("configs", "reference", "metrics", "limits"):
        shutil.copytree(FOLDER / d, tmp / d, dirs_exist_ok=True)
    (tmp / "traffic").mkdir(exist_ok=True)
    spec = json.loads(json.dumps(SPEC))
    for w in spec["workloads"]:
        t = json.loads((FOLDER / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        t.pop("num_edges")  # a graph of other sizes or classes
        t.update(TINY[t["generator"]], n_feats=24, n_classes=5)
        if gather_dtype is not None:
            t["gather_dtype"] = gather_dtype
        (tmp / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
    if dense is not ...:
        for c in spec["configs"]:
            cfg = json.loads((ROOT / c["file"]).read_text())
            cfg["dense"] = dense
            c["file"] = str(tmp / "configs" / f"{c['name']}.json")
            Path(c["file"]).write_text(json.dumps(cfg))
    spec["workloads"] += list(extra_cells)
    return Bench(spec, ROOT, tmp)


def run(bench: Bench, cell: str, seed: int = 2 ** 31 + 5,
        seconds: float = 0.3) -> dict:
    """A run of ``cell`` on the CPU, past the harness's look for a card."""
    return run_cell(bench, cell, seed, seconds, False, "cpu",
                    bench.folder / ".cache", time.time())
