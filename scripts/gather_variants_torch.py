#!/usr/bin/env python
"""Variants of ``gather_rows_sum`` (K9), timed in turns on one card beside
other trees of the package (the parent commit's, say).

    python scripts/gather_variants_torch.py [--tree NAME=DIR ...]
        [--variants NAME ...] [--out DIR] [--calls 20]

Copies this checkout's ``dgnn_tpu_torch/`` into ``DIR/<variant>/`` (by
default ``_checkout/variants``, which .gitignore lists) with lines of
``csrc/gather.cu`` rewritten per variant (VARIANTS: the column slice's
width, the rows a lane keeps in flight, an L2 ``evict_last`` hint on the
table loads), builds every copy and every ``--tree`` at once, then times
``gather_rows_sum`` in each, one process a tree, in turns (the list, then
the list reversed): at the study's four (W, row) shapes (2^20 ids into
65,536 rows) and with the same ids into L2_ROWS rows, a table the L2 holds
whole.  Each result is first held against the plain version
(``rows_tol``).  Prints the card, per tree ptxas' registers and spills of
``gather_rows_sum_kernel``, and ms per call, then one JSON object with
every number.  Needs a CUDA device and nvcc.

    python scripts/gather_variants_torch.py --time-tree DIR

times the tree under DIR alone and prints one JSON line (what the first
form runs for each tree).
"""

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

from dense_variants_torch import ROOT, build_trees, make_tree, ptxas

CU = "csrc/gather.cu"
SLICE_LINE = "constexpr int kRowsSlice4 = 8;"
UNROLL_LINE = "constexpr int kRowsUnroll = 8;"
LOAD_LINE = "        v[u] = __ldg(src + static_cast<size_t>(id) * row4);"
# the same load with an L2 evict_last policy on every table line
HINT_LOAD = """        {
          uint64_t pol;
          asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
              : "=l"(pol));
          asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
              : "=f"(v[u].x), "=f"(v[u].y), "=f"(v[u].z), "=f"(v[u].w)
              : "l"(src + static_cast<size_t>(id) * row4), "l"(pol));
        }"""
# variant name -> [(file under dgnn_tpu_torch/, the line as built, the
# variant's line)]
VARIANTS = {
    "as built": [],
    "slices of 64": [(CU, SLICE_LINE, "constexpr int kRowsSlice4 = 16;")],
    "slices of 128": [(CU, SLICE_LINE, "constexpr int kRowsSlice4 = 32;")],
    "unroll 4": [(CU, UNROLL_LINE, "constexpr int kRowsUnroll = 4;")],
    "slices of 128, unroll 4": [
        (CU, SLICE_LINE, "constexpr int kRowsSlice4 = 32;"),
        (CU, UNROLL_LINE, "constexpr int kRowsUnroll = 4;")],
    "evict_last hint": [(CU, LOAD_LINE, HINT_LOAD)],
    "unroll 4, evict_last hint": [
        (CU, UNROLL_LINE, "constexpr int kRowsUnroll = 4;"),
        (CU, LOAD_LINE, HINT_LOAD)],
}
# a table the L2 holds whole: 16.8 MB at the study's 4 KB rows
L2_ROWS = 4096
KERNEL = re.compile(r"gather_rows_sum_kernel\w*")


def time_tree(tree, calls):
    """{case: ms per call} of the tree's gather_rows_sum, each result held
    against the plain version first."""
    sys.path.insert(0, tree)
    import torch

    from dgnn_tpu_torch.ops import gather
    from dgnn_tpu_torch.utils import time_calls

    spec = importlib.util.spec_from_file_location(
        "microbench_gather_torch",
        os.path.join(ROOT, "scripts", "microbench_gather_torch.py"))
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    assert gather.__file__.startswith(tree), gather.__file__
    dev = torch.device("cuda")
    out = {}
    for width, sub in study.ROWS_CASES:
        for n in (65536, L2_ROWS):
            feat, nbr = study.rows_inputs(dev, n=n, sub=sub, width=width,
                                          seed=9)
            torch.testing.assert_close(gather.gather_rows_sum(feat, nbr),
                                       gather.gather_rows_sum_plain(feat, nbr),
                                       **study.rows_tol(width))
            s = time_calls(lambda: gather.gather_rows_sum(feat, nbr), dev,
                           iters=calls, warmup=3)
            out[f"W={width} row={sub * 512}B N={n}"] = s * 1e3
            del feat, nbr
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "_checkout",
                                                  "variants"))
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: another checkout's dgnn_tpu_torch, timed "
                         "as it is")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gather_variants_torch: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    if args.time_tree:
        print(json.dumps(time_tree(os.path.abspath(args.time_tree),
                                   args.calls)))
        return 0
    trees = {name: make_tree(args.out, name, VARIANTS[name])
             for name in args.variants}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = os.path.abspath(path)
    build_trees(trees.values())
    runs = {name: [] for name in trees}
    for name in list(trees) + list(trees)[::-1]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--time-tree", trees[name], "--calls",
                              str(args.calls)], check=True,
                             capture_output=True, text=True).stdout
        runs[name].append(json.loads(out.strip().splitlines()[-1]))
        print(f"[{name}] {json.dumps(runs[name][-1])}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    result = {}
    for name, tree in trees.items():
        result[name] = dict(ptxas=ptxas(tree, KERNEL), ms=runs[name])
        print(f"{name}: {result[name]['ptxas']}")
        for case in runs[name][0]:
            print(f"  {case}: " + "; ".join(f"{r[case]:.4f}"
                                            for r in runs[name]))
    print(json.dumps({"card": smi, "variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
