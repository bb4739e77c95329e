#!/usr/bin/env python
"""Own device time of the four bin kernels, K1 (``bin_gat_fwd``), K2
(``bin_gat_bwd``), K3 (``bin_gmm_node_fwd``) and K4 (``bin_gmm_node_bwd``),
over every bin of synthetic pubmed, and of the four dense hub-block kernels,
K5 (``dense_gat_fwd``), K6 (``dense_gat_bwd``), K7 (``dense_gmm_fwd``) and
K8 (``dense_gmm_bwd``), over synthetic cora's blocks, at both layers'
widths of the bench models, from a torch.profiler trace.

    python scripts/bin_kernel_times_torch.py [--tree DIR] [--calls 50]

``--tree`` names the checkout whose ``dgnn_tpu_torch`` is imported (the
default: this one), so that two checkouts can be timed in turns in one
process call each on the same card.  A bin kernel whose list wrapper the
tree has (``bin_gat_fwd_list``, ``bin_gat_bwd_list``,
``bin_gmm_node_fwd_list``, ``bin_gmm_node_bwd_list``) is timed through it,
one launch for every bin; otherwise one launch a bin.  GAT: (H, F) =
(4, 64) and (1, 3) on pubmed, (4, 64) and (1, 7) on cora, attention
dropout 0.3, the forward with the sign-split partials; MoNet: (K, F) =
(3, 64) and (3, 3) on pubmed, (3, 64) and (3, 7) on cora, D = 2, tanh; the
dense kernels in bfloat16 (the models' default).  Prints the card and one
JSON object: per case the kernel's device ms per call (summed over its
launches), the launches per call and whether a list wrapper ran.  Needs a
CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    from dgnn_tpu_torch.data import synthetic_citation
    from dgnn_tpu_torch.graph import structure
    from dgnn_tpu_torch.ops import _build, bins, dense

    if not torch.cuda.is_available():
        print("bin_kernel_times_torch: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    _build.load()
    dev = torch.device("cuda")
    d = synthetic_citation("pubmed")
    graph = structure.build_graph(d.src, d.dst, d.num_nodes, dense="auto",
                                  edge_tables=False).to(dev)
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    n = d.num_nodes
    fsegs = [(nbr, row, count) for _w, nbr, _e, row, count
             in graph.fwd.bins()]
    bsegs = [(nbr, row, count) for _w, nbr, _e, row, count
             in graph.bwd.bins()]

    def case(name, trace_key, list_args, bin_args, kw):
        """One kernel over every bin: through its list wrapper where the
        tree has one, else one launch a bin.  ``trace_key``: the kernel's
        name in a trace."""
        fn_list = getattr(bins, name + "_list", None)
        if fn_list is not None:
            return (lambda: fn_list(*list_args, **kw)), trace_key, True
        fn = getattr(bins, name)
        return (lambda: [fn(*a, **kw) for a in bin_args]), trace_key, False

    def per_bin(head, segs, tail=()):
        return [(*head, *seg, *tail) for seg in segs]

    cases = {}
    for h, f in ((4, 64), (1, 3)):
        x, ac, ar = t(n, h, f), t(n, h), t(n, h)
        g, M, Linv, ws = t(n, h, f, scale=1 / 16), t(n, h), t(n, h), t(n, h)
        head = (x, ac, ar)
        cases[f"bin_gat_fwd H={h} F={f}"] = case(
            "bin_gat_fwd", "bin_gat_fwd", (*head, fsegs),
            per_bin(head, fsegs),
            dict(slope=0.2, with_pos=True, p=0.3, seed=12345))
        head = (g, ar, M, Linv, ws, ac, x)
        cases[f"bin_gat_bwd H={h} F={f}"] = case(
            "bin_gat_bwd", "bin_gat_bwd", (*head, bsegs),
            per_bin(head, bsegs), dict(slope=0.2, p=0.3, seed=12345))
    for k, f in ((3, 64), (3, 3)):
        g, beta, dfeat, alpha, x, sfeat = (
            t(n, k, f, scale=1 / 16), t(n, 2), t(n, 1), t(n, 2), t(n, k, f),
            t(n, 1))
        par = (t(k, 2), torch.from_numpy(
            (rng.random((k, 2)) + 0.5).astype(np.float32)).to(dev))
        head = (x, alpha, beta)
        # the kernels' names in a trace: bin_gmm_fwd_kernel, bin_gmm_bwd_kernel
        cases[f"bin_gmm_node_fwd K={k} F={f}"] = case(
            "bin_gmm_node_fwd", "bin_gmm_fwd", (*head, fsegs, *par),
            per_bin(head, fsegs, par), dict(use_tanh=True))
        head = (g, beta, dfeat, alpha, x, sfeat)
        cases[f"bin_gmm_node_bwd K={k} F={f}"] = case(
            "bin_gmm_node_bwd", "bin_gmm_bwd", (*head, bsegs, *par),
            per_bin(head, bsegs, par), dict(use_tanh=True))
    dc = synthetic_citation("cora")
    cora = structure.build_graph(dc.src, dc.dst, dc.num_nodes, dense="auto",
                                 edge_tables=False).to(dev)
    nc = dc.num_nodes
    fdb, bdb = cora.fwd.dense, cora.bwd.dense
    for h, f in ((4, 64), (1, 7)):
        x, ac, ar = t(nc, h, f), t(nc, h), t(nc, h)
        g, M, ws = t(nc, h, f, scale=1 / 16), t(nc, h) + 2.0, t(nc, h)
        Linv = torch.rand((nc, h), device=dev) + 0.1
        cases[f"dense_gat_fwd H={h} F={f}"] = (
            lambda a=(fdb, ar, ac, x): dense.dense_gat_fwd(
                *a, slope=0.2, with_pos=True, p=0.3, seed=12345),
            "dense_gat_fwd", False)
        cases[f"dense_gat_bwd H={h} F={f}"] = (
            lambda a=(bdb, g, ar, M, Linv, ws, ac, x): dense.dense_gat_bwd(
                *a, slope=0.2, p=0.3, seed=12345), "dense_gat_bwd", False)
    for k, f in ((3, 64), (3, 7)):
        g, beta, dfeat, alpha, x = (t(nc, k, f, scale=1 / 16), t(nc, 2),
                                    t(nc, 1), t(nc, 2), t(nc, k, f))
        par = (t(k, 2), torch.from_numpy(
            (rng.random((k, 2)) + 0.5).astype(np.float32)).to(dev))
        cases[f"dense_gmm_fwd K={k} F={f}"] = (
            lambda a=(fdb, beta, alpha, x, *par): dense.dense_gmm_fwd(
                *a, use_tanh=True), "dense_gmm_fwd", False)
        cases[f"dense_gmm_bwd K={k} F={f}"] = (
            lambda a=(bdb, g, beta, dfeat, alpha, x, *par):
            dense.dense_gmm_bwd(*a, use_tanh=True), "dense_gmm_bwd", False)
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, (fn, key, listed) in cases.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and key in e.name]
        out[name] = dict(ms_per_call=sum(us) / 1e3 / args.calls,
                         launches_per_call=len(us) / args.calls, list=listed)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"tree": os.path.abspath(args.tree), "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
