"""GAT as ``configs/gat_reddit.json`` states it: dgNN's Reddit training
run, whose model and widths are those of ``configs/gat.json``, so its
weights, model and counts are ``configs/gat.py``'s."""

from pathlib import Path

from gnnbench.harness import load_module

_gat = load_module(Path(__file__).with_name("gat.py"), "gnnbench_config_gat")

__all__ = ["leaves", "Program", "mp_passes", "model_flops", "layer_dims"]

leaves, Program, mp_passes, model_flops, layer_dims = (
    _gat.leaves, _gat.Program, _gat.mp_passes, _gat.model_flops,
    _gat.layer_dims)
