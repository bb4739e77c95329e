#!/usr/bin/env python
"""Own device time of the bin kernels K1 (``bin_gat_fwd``) and K4
(``bin_gmm_node_bwd``) over every bin of synthetic pubmed, at both layers'
widths of the bench models, from a torch.profiler trace.

    python scripts/bin_kernel_times_torch.py [--tree DIR] [--calls 50]

``--tree`` names the checkout whose ``dgnn_tpu_torch`` is imported (the
default: this one), so that two checkouts can be timed in turns in one
process call each on the same card.  A tree that has the list wrappers
(``bin_gat_fwd_list``, ``bin_gmm_node_bwd_list``) is timed through them,
one launch for every bin; an older tree one launch a bin.  GAT: (H, F) =
(4, 64) and (1, 3), attention dropout 0.3, with the sign-split partials;
MoNet: (K, F) = (3, 64) and (3, 3), D = 2, tanh.  Prints the card and one
JSON object: per case the kernels' device ms per call (summed over its
launches) and the launches per call.  Needs a CUDA device.
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
    from dgnn_tpu_torch.ops import _build, bins

    if not torch.cuda.is_available():
        print("bin_kernel_times_torch: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    _build.load()
    dev = torch.device("cuda")
    d = synthetic_citation("pubmed")
    g = structure.build_graph(d.src, d.dst, d.num_nodes, dense="auto",
                              edge_tables=False).to(dev)
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    n = d.num_nodes
    fsegs = [(nbr, row, count) for _w, nbr, _e, row, count in g.fwd.bins()]
    bsegs = [(nbr, row, count) for _w, nbr, _e, row, count in g.bwd.bins()]
    has_list = hasattr(bins, "bin_gat_fwd_list")
    cases = {}
    for h, f in ((4, 64), (1, 3)):
        a = (t(n, h, f), t(n, h), t(n, h))
        kw = dict(slope=0.2, with_pos=True, p=0.3, seed=12345)
        if has_list:
            fn = (lambda a=a, kw=kw:
                  bins.bin_gat_fwd_list(*a, fsegs, **kw))
        else:
            fn = (lambda a=a, kw=kw:
                  [bins.bin_gat_fwd(*a, *s, **kw) for s in fsegs])
        cases[f"bin_gat_fwd H={h} F={f}"] = (fn, "bin_gat_fwd")
    for k, f in ((3, 64), (3, 3)):
        a = (t(n, k, f, scale=1 / 16), t(n, 2), t(n, 1), t(n, 2),
             t(n, k, f), t(n, 1))
        par = (t(k, 2), torch.from_numpy(
            (rng.random((k, 2)) + 0.5).astype(np.float32)).to(dev))
        if has_list:
            fn = (lambda a=a, par=par:
                  bins.bin_gmm_node_bwd_list(*a, bsegs, *par, use_tanh=True))
        else:
            fn = (lambda a=a, par=par:
                  [bins.bin_gmm_node_bwd(*a, *s, *par, use_tanh=True)
                   for s in bsegs])
        # the kernel's name in a trace: bin_gmm_bwd_kernel
        cases[f"bin_gmm_node_bwd K={k} F={f}"] = (fn, "bin_gmm_bwd")
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, (fn, key) in cases.items():
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
                         launches_per_call=len(us) / args.calls)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"tree": os.path.abspath(args.tree), "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
