"""Flax GAT, MoNet and DGCNN parameters (as numpy) -> the port's state
dicts.

GAT: maps ``params["gat_<l>"]`` / ``params["gat_out"]`` of a
``dgnn_tpu.models.GAT`` onto ``convs.gat_<l>`` / ``convs.gat_out``:
``W/kernel`` and ``res_fc/kernel`` [in, out] are transposed into
``nn.Linear``'s [out, in] weight, ``attn_l``, ``attn_r`` and ``bias`` keep
their (1, H, F) shape.

MoNet: maps ``params["gmm_<i>"]`` of a ``dgnn_tpu.models.MoNet`` onto
``convs.gmm_<i>``: ``fc/kernel`` [in, K*F] and ``res_fc/kernel`` are
transposed into ``nn.Linear`` weights; ``mu``, ``inv_sigma`` [K, D], the
node and binned modes' ``pseudo_w`` [Din, D] and ``pseudo_b`` [D], and
``bias`` [F] keep their shapes.  The flat mode's ``params["pseudo_proj_<i>"]``
Dense (``kernel`` [Din, D], ``bias`` [D]) becomes
``pseudo_projs.pseudo_proj_<i>``, its kernel transposed.

DGCNN: maps ``params`` and ``batch_stats`` of a ``dgnn_tpu.models.DGCNN``
onto ``convs.conv_<i>.{theta,phi}``, ``proj``, ``embs.emb_<i>``,
``bns.bn_<i>`` and ``head``: every Dense ``kernel`` [in, out] is transposed,
batch norm ``scale`` / ``bias`` (params) and ``mean`` / ``var``
(batch_stats) keep their names; an EdgeConv's own ``BatchNorm_0`` becomes
``convs.conv_<i>.bn``.

With the result loaded, both packages compute the same function.  Reads
arrays through ``numpy.asarray`` only, so it needs no JAX import.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flax_gat_state_dict", "load_flax_gat", "flax_monet_state_dict",
           "load_flax_monet", "flax_dgcnn_state_dict", "load_flax_dgcnn"]


def flax_gat_state_dict(params) -> dict:
    """State dict for ``models.GAT`` given flax GAT params (the dict that
    ``model.init`` returns, or its ``"params"`` entry)."""
    if "params" in params:
        params = params["params"]
    sd = {}
    for name, layer in params.items():
        unknown = set(layer) - {"W", "res_fc", "attn_l", "attn_r", "bias"}
        if unknown:
            raise ValueError(f"{name}: parameters {sorted(unknown)} have no "
                             "counterpart in dgnn_tpu_torch's GATConv")
        pre = f"convs.{name}."
        for key in ("W", "res_fc"):
            if key in layer:
                kernel = np.asarray(layer[key]["kernel"], np.float32)
                sd[pre + key + ".weight"] = torch.from_numpy(
                    np.ascontiguousarray(kernel.T))
        for key in ("attn_l", "attn_r", "bias"):
            if key in layer:
                sd[pre + key] = torch.from_numpy(
                    np.array(layer[key], np.float32))
    return sd


def load_flax_gat(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load flax GAT params into ``model`` (strict: every key must match)."""
    model.load_state_dict(flax_gat_state_dict(params), strict=True)
    return model


def flax_monet_state_dict(params) -> dict:
    """State dict for ``models.MoNet`` given flax MoNet params (the dict that
    ``model.init`` returns, or its ``"params"`` entry)."""
    if "params" in params:
        params = params["params"]
    sd = {}
    for name, layer in params.items():
        if name.startswith("pseudo_proj_"):
            sd.update(_dense_entries(f"pseudo_projs.{name}.", layer))
            continue
        if not name.startswith("gmm_"):
            raise ValueError(f"{name}: only MoNet layers (gmm_<i>) and the "
                             "flat mode's projections (pseudo_proj_<i>) have "
                             "a counterpart in dgnn_tpu_torch")
        unknown = set(layer) - {"fc", "res_fc", "mu", "inv_sigma", "pseudo_w",
                                "pseudo_b", "bias"}
        if unknown:
            raise ValueError(f"{name}: parameters {sorted(unknown)} have no "
                             "counterpart in dgnn_tpu_torch's GMMConv")
        pre = f"convs.{name}."
        for key in ("fc", "res_fc"):
            if key in layer:
                kernel = np.asarray(layer[key]["kernel"], np.float32)
                sd[pre + key + ".weight"] = torch.from_numpy(
                    np.ascontiguousarray(kernel.T))
        for key in ("mu", "inv_sigma", "pseudo_w", "pseudo_b", "bias"):
            if key in layer:
                sd[pre + key] = torch.from_numpy(
                    np.array(layer[key], np.float32))
    return sd


def load_flax_monet(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load flax MoNet params into ``model`` (strict: every key must
    match)."""
    model.load_state_dict(flax_monet_state_dict(params), strict=True)
    return model


def _array(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _dense_entries(pre: str, layer) -> dict:
    sd = {pre + "weight": torch.from_numpy(np.ascontiguousarray(
        np.asarray(layer["kernel"], np.float32).T))}
    if "bias" in layer:
        sd[pre + "bias"] = _array(layer["bias"])
    return sd


def _bn_entries(pre: str, params, stats) -> dict:
    return {pre + "scale": _array(params["scale"]),
            pre + "bias": _array(params["bias"]),
            pre + "mean": _array(stats["mean"]),
            pre + "var": _array(stats["var"])}


def flax_dgcnn_state_dict(params, batch_stats=None) -> dict:
    """State dict for ``models.DGCNN`` given flax DGCNN variables: either
    ``params`` and ``batch_stats``, or the one dict holding both that
    ``model.init`` returns."""
    if "params" in params:
        batch_stats = params.get("batch_stats", batch_stats)
        params = params["params"]
    batch_stats = batch_stats or {}
    sd = {}
    for name, layer in params.items():
        if name.startswith("conv_"):
            unknown = set(layer) - {"theta", "phi", "BatchNorm_0"}
            if unknown:
                raise ValueError(f"{name}: parameters {sorted(unknown)} have "
                                 "no counterpart in dgnn_tpu_torch's EdgeConv")
            pre = f"convs.{name}."
            for key in ("theta", "phi"):
                sd.update(_dense_entries(pre + key + ".", layer[key]))
            if "BatchNorm_0" in layer:
                sd.update(_bn_entries(pre + "bn.", layer["BatchNorm_0"],
                                      batch_stats[name]["BatchNorm_0"]))
        elif name.startswith("emb_"):
            sd.update(_dense_entries(f"embs.{name}.", layer))
        elif name.startswith("bn_"):
            sd.update(_bn_entries(f"bns.{name}.", layer, batch_stats[name]))
        elif name in ("proj", "head"):
            sd.update(_dense_entries(name + ".", layer))
        else:
            raise ValueError(f"{name}: no counterpart in dgnn_tpu_torch's "
                             "DGCNN")
    return sd


def load_flax_dgcnn(model: torch.nn.Module, params,
                    batch_stats=None) -> torch.nn.Module:
    """Load flax DGCNN params and batch stats into ``model`` (strict: every
    key must match)."""
    model.load_state_dict(flax_dgcnn_state_dict(params, batch_stats),
                          strict=True)
    return model
