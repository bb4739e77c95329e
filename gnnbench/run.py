"""Run one cell of the port's benchmark on the card this process sees.

    python3 gnnbench/run.py --workload gat.reddit.train --seed 7 \\
        --seconds 30 --trace 0

Prints the set-up stages, the window and the check on standard error,
then each number the check compares beside its limit as the last lines
there, and the result as one JSON line, last on standard output.  With
``--trace 1`` the metrics are the cell's per-layer ones, read from a
profiler trace of a short stretch after the window.  Without a CUDA
card, with fewer cards than the cell asks for, or with JAX loaded in the
process once the window has closed, it prints no result and exits with
another code than 0.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FOLDER = Path(__file__).resolve().parent
ROOT = FOLDER.parent
CACHE = FOLDER / ".cache"
# every cache at a fixed path inside the checkout, set before torch loads
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in the process: JAX and
# the JAX package (compared whole: the port's name starts with its name)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dgnn_tpu")


def forbidden_modules() -> list:
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
              f"{seen}", file=sys.stderr)
        return 2
    from gnnbench.harness import Bench, run_cell

    result = run_cell(Bench(spec, ROOT, FOLDER), args.workload, args.seed,
                      args.seconds, bool(args.trace), "cuda", CACHE,
                      T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
