#!/usr/bin/env python
"""Build and cache the raw reddit-scale R-MAT arrays (CSR / CSC / permute)
with the PyTorch port's host layer (counterpart of
scripts/build_reddit_raw.py, which needs the JAX package).

The arrays do not depend on the binned layout, so the port's trainers
(``--dataset reddit``) read them from this file and build and cache the
binned graph beside it (dgnn_tpu_torch/data/reddit.py).  Prints each
stage's seconds from the start.

    python scripts/build_reddit_raw_torch.py [--scale S] [out.npz]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

from dgnn_tpu_torch.data.reddit import CACHE_DIR, build_raw, reddit_size

__all__ = ["build_raw"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default=None,
                   help="output .npz (default: the trainers' cache file)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="nodes and edges times this (bench.py's scale)")
    args = p.parse_args(argv)
    n, e = reddit_size(args.scale)
    out = args.out or str(CACHE_DIR / f"rmat_raw_{n}_{e}_torch.npz")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    build_raw(n, e, out, log=lambda msg: print(msg, flush=True))
    print(f"saved {out}", flush=True)


if __name__ == "__main__":
    main()
