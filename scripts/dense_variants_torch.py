#!/usr/bin/env python
"""Variants of the four dense hub-block kernels, K5 (``dense_gat_fwd``), K6
(``dense_gat_bwd``), K7 (``dense_gmm_fwd``) and K8 (``dense_gmm_bwd``),
timed in turns on one card.

    python scripts/dense_variants_torch.py [--kernels K6 K7] [--out DIR]
        [--calls 50]

Copies this checkout's ``dgnn_tpu_torch/`` into ``DIR/<variant>/`` (by
default ``_checkout/variants``, which .gitignore lists) with one line of
``csrc/dense_gat.cu`` or ``csrc/dense_gmm.cu`` rewritten per variant (a
register cap, a prefetch depth, an unroll count: VARIANTS) for the kernels
named by ``--kernels`` (default K6 and K7), builds every copy at once, then
runs ``scripts/bin_kernel_times_torch.py --tree`` on each copy in turns
(the list, then the list reversed).  Prints the card, per variant ptxas'
registers and spills at the models' instances of the four kernels, and the
four dense kernels' own ms per call over cora's blocks at both layers'
widths, then one JSON object with every number.  Needs a CUDA device and
nvcc.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAT, GMM = "csrc/dense_gat.cu", "csrc/dense_gmm.cu"
# variant name (its kernel first) -> [(file under dgnn_tpu_torch/, the line
# as built, the variant's line)]
VARIANTS = {
    "as built": [],
    "K5 no register cap": [(GAT, "constexpr int kGatFwdMinBlocks = 5;",
                            "constexpr int kGatFwdMinBlocks = 1;")],
    "K5 4 blocks an SM": [(GAT, "constexpr int kGatFwdMinBlocks = 5;",
                           "constexpr int kGatFwdMinBlocks = 4;")],
    "K5 16 prefetched values": [(GAT, "constexpr int kGatFwdPrefetch = 8;",
                                 "constexpr int kGatFwdPrefetch = 16;")],
    "K6 no register cap": [(GAT, "constexpr int kGatBwdMinBlocks = 5;",
                            "constexpr int kGatBwdMinBlocks = 1;")],
    "K6 4 blocks an SM": [(GAT, "constexpr int kGatBwdMinBlocks = 5;",
                           "constexpr int kGatBwdMinBlocks = 4;")],
    "K6 16 prefetched values": [(GAT, "constexpr int kGatBwdPrefetch = 8;",
                                 "constexpr int kGatBwdPrefetch = 16;")],
    "K7 no register cap": [(GMM, "constexpr int kGmmFwdMinBlocks = 4;",
                            "constexpr int kGmmFwdMinBlocks = 1;")],
    "K7 5 blocks an SM": [(GMM, "constexpr int kGmmFwdMinBlocks = 4;",
                           "constexpr int kGmmFwdMinBlocks = 5;")],
    "K7 16 prefetched values": [(GMM, "constexpr int kGmmFwdPrefetch = 8;",
                                 "constexpr int kGmmFwdPrefetch = 16;")],
    "K8 no register cap": [(GMM, "constexpr int kGmmBwdMinBlocks = 4;",
                            "constexpr int kGmmBwdMinBlocks = 1;")],
    "K8 5 blocks an SM": [(GMM, "constexpr int kGmmBwdMinBlocks = 4;",
                           "constexpr int kGmmBwdMinBlocks = 5;")],
    "K8 two edges at 8 columns": [(GMM, "#pragma unroll(NC == 1 ? 2 : 1)",
                                   "#pragma unroll 2")],
}
# the models' instances in ptxas' report
INSTANCES = re.compile(r"(dense_gat_(?:fwd|bwd)_kernelILi4ELi(?:8|1)E|"
                       r"dense_gmm_fwd_kernelILi4ELi2ELi(?:8|1)E|"
                       r"dense_gmm_bwd_kernelILi4ELi2ELi2ELi(?:8|1)E)")


def make_tree(out, name, edits):
    """A copy of this checkout's dgnn_tpu_torch/ under ``out`` with each
    (file, old, new) of ``edits`` applied; ``old`` must occur once."""
    tree = os.path.join(out, re.sub(r"\W+", "_", name).strip("_"))
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "dgnn_tpu_torch"),
                    os.path.join(tree, "dgnn_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src, old, new in edits:
        path = os.path.join(tree, "dgnn_tpu_torch", src)
        text = open(path).read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not one line of {src}")
        open(path, "w").write(text.replace(old, new))
    return tree


def build_trees(trees):
    """Builds the kernels of every tree at once."""
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from dgnn_tpu_torch.ops import _build; _build.load()")
    procs = [subprocess.Popen([sys.executable, "-c", build, tree])
             for tree in trees]
    if any(p.wait() for p in procs):
        raise RuntimeError("a tree failed to build")


def ptxas(tree, instances=INSTANCES):
    """{instance: "N registers, S bytes spilled"} from the tree's build log,
    for the kernels ``instances`` matches."""
    log_dir = os.path.join(tree, "build", "dgnn_tpu_torch")
    (sub,) = os.listdir(log_dir)
    lines = open(os.path.join(log_dir, sub, "build.log")).read().splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = instances.search(line)
        if m and "Compiling entry" in line:
            after = "\n".join(lines[i + 1:i + 5])
            spill = re.search(r"(\d+) bytes spill stores", after)
            regs = re.search(r"Used (\d+) registers", after)
            out[m.group(0)] = (f"{regs.group(1) if regs else '?'} registers, "
                               f"{spill.group(1) if spill else '?'} bytes "
                               "spilled")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "_checkout",
                                                  "variants"))
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--kernels", nargs="+", default=["K6", "K7"],
                    choices=["K5", "K6", "K7", "K8"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dense_variants_torch: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    trees = {name: make_tree(args.out, name, edits)
             for name, edits in VARIANTS.items()
             if not edits or name.split()[0] in args.kernels}
    build_trees(trees.values())
    script = os.path.join(ROOT, "scripts", "bin_kernel_times_torch.py")
    runs = {name: [] for name in trees}
    for name in list(trees) + list(trees)[::-1]:
        out = subprocess.run([sys.executable, script, "--tree", trees[name],
                              "--calls", str(args.calls)], check=True,
                             capture_output=True, text=True).stdout
        cases = json.loads(out.strip().splitlines()[-1])["cases"]
        runs[name].append({k: v["ms_per_call"] for k, v in cases.items()
                           if k.startswith("dense")})
        print(f"[{name}] {json.dumps(runs[name][-1])}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    result = {}
    for name, tree in trees.items():
        result[name] = dict(ptxas=ptxas(tree), ms=runs[name])
        print(f"{name}: {result[name]['ptxas']}")
        for case in runs[name][0]:
            print(f"  {case}: " + "; ".join(f"{r[case]:.4f}"
                                            for r in runs[name]))
    print(json.dumps({"card": smi, "variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
