"""Time the tie-sum backward's kernels on the card, at DGCNN's widths.

At B = 64 clouds of P = 1024 points, k = 40, with mul_dtype bfloat16, on
two kinds of input: the k-NN masks of random 3-D points at F = 64, 128
and 256 (``knn``: what ``chip_smoke.py`` times), and the four layers'
own masks and h_src in one forward pass of the DGCNN trainer's model at
its defaults (``model``: k-NN in feature space from the second layer on,
where some points are the neighbours of several times k others, so the
lists are longer and less even); each timed from a replayed CUDA graph of
GRAPH_CALLS calls, in turns (there and back, the lesser reading):

- ``first``: the kernel before its redesign (``scripts/tie_sum_probe.cu``,
  a block a cloud, 32 columns and a 256-feature slab, the mask staged in
  128-row chunks, the passing pairs' rows of m and g read from L2), after
  the torch ``amin`` of m that it took;
- ``first_scan``: the same without its walk over the passing rows: what
  its mask scan alone takes;
- ``lists``: the redesign's list pass (``ops/edgeconv.py`` ``_tie_lists``:
  the bounds and list kernels);
- ``redesign``: the whole call, ``tie_sum_bwd`` (the list pass, then the
  sum from (m, g) slabs in shared memory).

The redesign must equal the first form bit for bit.  Prints a line per
input (with the lists' statistics: mean and largest count a column, and
the columns over ``TIE_CAP``), the model's four layers summed to a step,
and, last, one JSON object.  Needs a CUDA card and nvcc; run from the
root of the repository:

    python scripts/tie_sum_probe_torch.py
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dgnn_tpu_torch.ops import _build, ec_tiles, edgeconv  # noqa: E402
from dgnn_tpu_torch.ops.bins import _ptr  # noqa: E402

SOURCE = ROOT / "scripts" / "tie_sum_probe.cu"
B, P, K = 64, 1024, 40
WIDTHS = (64, 128, 256)
G_SCALE = 1.0 / 16


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_probe() -> ctypes.CDLL:
    """nvcc the first form into build/tie_sum_probe/<hash>/ and load it."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_build.NVCC_FLAGS).encode())
    out = ROOT / "build" / "tie_sum_probe" / h.hexdigest()[:16]
    so = out / "libtie_sum_probe.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(SOURCE)], capture_output=True, text=True, check=False)
        (out / "build.log").write_text(res.stdout + res.stderr)
        if res.returncode:
            raise RuntimeError(f"nvcc failed:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.probe_tie_sum.argtypes = [vp, ci, vp, vp, vp, vp, ci, ci, ci, ci,
                                  ci, vp, vp]
    lib.probe_tie_sum.restype = ci
    return lib


def first_form(lib, m, mask, hs, g, walk):
    mmin = m.amin(dim=-1)
    out = torch.empty_like(hs)
    Bb, Pp, F = hs.shape
    err = lib.probe_tie_sum(
        _ptr(mask), 1, _ptr(m), _ptr(hs), _ptr(g), _ptr(mmin), Bb, Pp, F, 1,
        int(walk), _ptr(out), torch.cuda.current_stream(hs.device).cuda_stream)
    if err:
        raise RuntimeError(f"probe_tie_sum: CUDA error {err}")
    return out


def model_inputs(dev):
    """(mask, h_src) of each EdgeConv layer in one forward pass of the
    DGCNN trainer's model (its defaults and seed) on its first batch of
    training clouds."""
    from dgnn_tpu_torch.models import dgcnn

    trainer = _script("train_edgeconv_torch")
    args = trainer.parser().parse_args(["--device", "cuda"])
    torch.backends.cuda.matmul.allow_tf32 = False
    xtr, ytr, xte, yte = trainer.load_modelnet(
        num_points=args.num_points, train_samples=args.train_samples,
        test_samples=args.test_samples, seed=args.seed)
    n_classes = int(max(ytr.max(), yte.max())) + 1
    model = dgcnn.DGCNN(k=args.k, output_classes=n_classes, dropout=0.5,
                        generator=torch.Generator().manual_seed(args.seed)
                        ).to(dev).eval()
    seen = []
    saved = dgcnn.edge_conv_max_dense

    def grab(mask, h_src, h_dst, *rest, **kw):
        seen.append((mask.detach(), h_src.detach().contiguous()))
        return saved(mask, h_src, h_dst, *rest, **kw)

    dgcnn.edge_conv_max_dense = grab
    try:
        with torch.no_grad():
            model(torch.from_numpy(xtr[:args.batch_size]).to(dev))
    finally:
        dgcnn.edge_conv_max_dense = saved
    return seen


def time_case(lib, gather_study, name, mask, hs, smi, dev):
    """One input's row: the four timings, bit-equality, list statistics."""
    f = hs.shape[-1]
    m = ec_tiles.masked_max(mask, hs, schedule=edgeconv.SCHEDULE)
    g = torch.randn(hs.shape, generator=torch.Generator(
        device=dev).manual_seed(15), device=dev) * G_SCALE
    fns = {
        "first": lambda: first_form(lib, m, mask, hs, g, True),
        "first_scan": lambda: first_form(lib, m, mask, hs, g, False),
        "lists": lambda: edgeconv._tie_lists(m, mask, hs),
        "redesign": lambda: edgeconv.tie_sum_bwd(m, mask, hs, g),
    }
    want = fns["first"]()
    got = fns["redesign"]()
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want))
    _, _, count = fns["lists"]()
    ms = dict.fromkeys(fns, float("inf"))
    order = list(fns)
    for key in order + order[::-1]:
        ms[key] = min(ms[key], gather_study.graph_ms(fns[key], dev, 5))
    row = dict(input=name, F=f, **{k + "_ms": v for k, v in ms.items()},
               bit_equal=same, count_mean=float(count.float().mean()),
               count_max=int(count.max()),
               over_cap=int((count > edgeconv.TIE_CAP).sum()))
    print(f"{name} F={f}: first {ms['first']:.4f} ms, its scan alone "
          f"{ms['first_scan']:.4f}, lists {ms['lists']:.4f}, redesign "
          f"{ms['redesign']:.4f} ms a call; bit-equal {same}; "
          f"{row['count_mean']:.2f} rows a column pass (largest "
          f"{row['count_max']}, {row['over_cap']} columns over "
          f"{edgeconv.TIE_CAP}) | {smi}", flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    study = _script("exp_ec_tiles_torch")
    gather_study = _script("microbench_gather_torch")
    lib = build_probe()
    _build.load()
    rows = []
    for f in WIDTHS:
        mask, hs = study.make_inputs(dev, B, P, f, K, "knn", seed=8)
        rows.append(time_case(lib, gather_study, "knn", mask, hs, smi, dev))
        del mask, hs
    for mask, hs in model_inputs(dev):
        rows.append(time_case(lib, gather_study, "model", mask, hs, smi,
                              dev))
    step = [r for r in rows if r["input"] == "model"]
    print("model, a DGCNN step's four calls: " + ", ".join(
        f"{k} {sum(r[k + '_ms'] for r in step):.4f}"
        for k in ("first", "first_scan", "lists", "redesign")) + " ms",
        flush=True)
    if not all(r["bit_equal"] for r in rows):
        print(json.dumps({"rows": rows, "card": smi}))
        return 1
    print(json.dumps({"rows": rows, "card": smi}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
