#!/usr/bin/env python3
"""Drive the PyTorch port (dgnn_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (a failure raises; nothing is caught and continued):

  1. device  - requires a CUDA device; prints nvidia-smi's name and power
               limit; turns TF32 off for matmuls and cuDNN.
  2. build   - builds the CUDA kernels from csrc/ (nvcc, sm_90a) and loads
               them; prints the build seconds and ptxas' register report.
  3. kernels - every bin of synthetic pubmed's forward and backward graphs,
               at (H, F) = (4, 64) and (1, 3), attention dropout p 0 and
               0.3, with and without the sign-split partials, plus a
               power-law graph with a bin wider than 64 and an empty
               segment: each kernel against its plain PyTorch version on the
               card (forward rtol 1e-5 / atol 1e-5; backward rtol 1e-4 /
               atol 1e-5, the summation order differs).  One flipped dropout
               bit would give an O(1) difference, so this also holds the
               dropout hash.
  4. op      - gat_aggregate forward and (ar, ac, feat) gradients on the
               card against the same op on CPU copies (the plain path),
               p 0 and 0.3.
  5. train   - the trainer (scripts/train_gat_torch.py) on synthetic pubmed
               at the bench width: heads (4, 1), hidden 64, feat_drop 0.5,
               attn_drop 0.3, Adam lr 1e-3, weight decay 5e-4, 20 steps and
               an eval.  The loss must be finite and fall; the launch counts
               must be exactly what the steps and evals imply; the trained
               model's logits on the card must match a CPU copy's.
  6. times   - each kernel and its plain version over one pass of pubmed's
               bins at the slice's shapes, CUDA events, in turns.

The last lines are a JSON object with every kernel, the card's name and
power limit, and {"ok": true, "device": {...}}.  Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

import copy
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
SLOPE = 0.2
SEED = 0x9E3779B9  # a uint32 dropout seed above the int32 range
SHAPES = ((4, 64), (1, 3))  # (H, F) of pubmed's hidden and output layers
# Scale of the random output gradients.  d ac is a difference of sums of
# terms up to |x| |g| F, so its float32 rounding floor grows with |g|: at
# unit scale and F = 64 it reaches the stated atol (1e-5) on a few elements
# in any summation order.  The main path's gradients, of a loss averaged
# over the training rows, are about 1e-4; 1/16 keeps them far above that,
# and a wrong slot, weight or dropout bit still moves the result by far
# more than the tolerance.
G_SCALE = 1.0 / 16
KERNELS = {
    "bin_gat_fwd": dict(route="cuda", source="dgnn_tpu_torch/csrc/bin_gat.cu",
                        replaces="dgnn_tpu/ops/pallas_bins.py:150"),
    "bin_gat_bwd": dict(route="cuda", source="dgnn_tpu_torch/csrc/bin_gat.cu",
                        replaces="dgnn_tpu/ops/pallas_bins.py:292"),
}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def tables(bins, combine_lse, graph, h, f, rng, dev):
    """Node tables for one (H, F) shape: random features, coefficients and
    output gradient made with numpy, and the backward's destination tables
    (M, 1 / L, ws = <g, out>) as the op's forward gives them on this graph,
    from the plain per-bin forward and the combine.  So the backward kernel
    sees attention weights in [0, 1], as on the main path."""
    def t(*shape, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    tb = dict(feat=t(graph.num_nodes, h, f), ac=t(graph.num_nodes, h),
              ar=t(graph.num_nodes, h),
              g=t(graph.num_nodes, h, f, scale=G_SCALE))
    parts = [bins.bin_gat_fwd_plain(tb["feat"], tb["ac"], tb["ar"], nbr, row,
                                    count, slope=SLOPE, with_pos=False)
             for _w, nbr, _e, row, count in graph.fwd.bins()]
    M, (L, acc) = combine_lse(graph.fwd.cmb, torch.cat([x[0] for x in parts]),
                              [torch.cat([x[1] for x in parts]),
                               torch.cat([x[3] for x in parts])])
    tb["M"] = M
    tb["Linv"] = 1.0 / torch.clamp(L, min=1e-20)
    tb["ws"] = (tb["g"] * acc * tb["Linv"][..., None]).sum(dim=-1)
    return tb


def check_bins(bins, adj_fwd, adj_bwd, tb, err):
    """Every bin of one graph, kernel against plain; returns comparisons."""
    n_cmp = 0
    for _w, nbr, _e, row, count in adj_fwd.bins():
        for p in (0.0, 0.3):
            for with_pos in (True, False):
                args = (tb["feat"], tb["ac"], tb["ar"], nbr, row, count)
                kw = dict(slope=SLOPE, with_pos=with_pos, p=p, seed=SEED)
                got = bins.bin_gat_fwd(*args, **kw)
                want = bins.bin_gat_fwd_plain(*args, **kw)
                for g, w in zip(got, want):
                    if w is None:
                        assert g is None
                        continue
                    torch.testing.assert_close(g, w, **FWD_TOL)
                    err["bin_gat_fwd"] = max(err["bin_gat_fwd"],
                                             float((g - w).abs().max()))
                n_cmp += 1
    for _w, nbr, _e, row, count in adj_bwd.bins():
        for p in (0.0, 0.3):
            args = (tb["g"], tb["ar"], tb["M"], tb["Linv"], tb["ws"],
                    tb["ac"], tb["feat"], nbr, row, count)
            kw = dict(slope=SLOPE, p=p, seed=SEED)
            got = bins.bin_gat_bwd(*args, **kw)
            want = bins.bin_gat_bwd_plain(*args, **kw)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, **BWD_TOL)
                err["bin_gat_bwd"] = max(err["bin_gat_bwd"],
                                         float((g - w).abs().max()))
            n_cmp += 1
    torch.cuda.synchronize()
    return n_cmp


def power_law_graph(structure, rng, n=4000):
    """Zipf-skewed in-degrees: one bin wider than 64 whose hub rows split
    into several segments."""
    src = rng.integers(0, n, 6 * n)
    dst = np.minimum(rng.zipf(1.6, 6 * n) - 1, n - 1)
    uniq = np.unique(np.stack([src, dst], 1), axis=0)
    g = structure.build_graph(uniq[:, 0], uniq[:, 1], n, widths=(8, 128))
    assert max(g.fwd.widths) > 64, g.fwd.widths
    return g


def time_pair(fn_kernel, fn_plain, time_calls, dev):
    """ms per call of each, measured in turns: plain, kernel, kernel, plain."""
    t = [time_calls(f, dev, iters=20, warmup=3)
         for f in (fn_plain, fn_kernel, fn_kernel, fn_plain)]
    return min(t[1], t[2]) * 1e3, min(t[0], t[3]) * 1e3


def main():
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs only "
              "on the card", file=sys.stderr)
        return 1
    from dgnn_tpu_torch.data import synthetic_citation
    from dgnn_tpu_torch.graph import structure
    from dgnn_tpu_torch.ops import _build, bins
    from dgnn_tpu_torch.ops.common import combine_lse
    from dgnn_tpu_torch.ops.gat import gat_aggregate
    from dgnn_tpu_torch.utils import time_calls

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    phase("device", f"{torch.cuda.get_device_name(dev)} | nvidia-smi: {smi} "
          f"| torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log = (_build.library_path().parent / "build.log").read_text()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    phase("build", f"{build_s:.1f} s -> {_build.library_path()} | "
          + " | ".join(regs))

    # 3. kernels against their plain versions
    rng = np.random.default_rng(0)
    d = synthetic_citation("pubmed")
    pub = structure.build_graph(d.src, d.dst, d.num_nodes, dense="auto",
                                edge_tables=False).to(dev)
    err = {k: 0.0 for k in KERNELS}
    tabs = {}
    for h, f in SHAPES:
        tabs[(h, f)] = tables(bins, combine_lse, pub, h, f, rng, dev)
        n_cmp = check_bins(bins, pub.fwd, pub.bwd, tabs[(h, f)], err)
        phase("kernels", f"pubmed H={h} F={f}: fwd widths {pub.fwd.widths} "
              f"bwd widths {pub.bwd.widths}: {n_cmp} kernel/plain "
              "comparisons agree")
    pl = power_law_graph(structure, rng).to(dev)
    pl_tabs = [tables(bins, combine_lse, pl, h, f, rng, dev)
               for h, f in SHAPES]
    pl.fwd.count[-1][0] = 0  # an empty segment in the widest bin
    for (h, f), tb in zip(SHAPES, pl_tabs):
        n_cmp = check_bins(bins, pl.fwd, pl.bwd, tb, err)
        phase("kernels", f"power-law H={h} F={f}: fwd widths "
              f"{pl.fwd.widths} (one empty segment): {n_cmp} comparisons "
              "agree")
    phase("kernels", f"max |kernel - plain|: {json.dumps(err)}")

    # 4. the op on the card against the op on CPU copies
    pub_cpu = pub.to("cpu")
    for p in (0.0, 0.3):
        h, f = SHAPES[0]
        arrs = [rng.normal(size=s).astype(np.float32)
                for s in ((d.num_nodes, h), (d.num_nodes, h),
                          (d.num_nodes, h, f), (d.num_nodes, h, f))]
        res = {}
        for where, graph in (("card", pub), ("cpu", pub_cpu)):
            to = dev if where == "card" else "cpu"
            ins = [torch.from_numpy(a).to(to).requires_grad_(True)
                   for a in arrs[:3]]
            out = gat_aggregate(graph, *ins, attn_drop=p, seed=SEED,
                                training=True)
            out.backward(torch.from_numpy(arrs[3] * G_SCALE).to(to))
            res[where] = [out.detach().cpu()] + [t.grad.cpu() for t in ins]
        torch.testing.assert_close(res["card"][0], res["cpu"][0], **FWD_TOL)
        for name, a, b in zip(("ar", "ac", "feat"), res["card"][1:],
                              res["cpu"][1:]):
            torch.testing.assert_close(a, b, **BWD_TOL, msg=lambda m: name + m)
        phase("op", f"gat_aggregate pubmed H={h} F={f} p={p}: output and "
              "d(ar, ac, feat) on the card match the CPU")

    # 5. train through the trainer's entry point
    spec = importlib.util.spec_from_file_location(
        "train_gat_torch", ROOT / "scripts" / "train_gat_torch.py")
    trainer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trainer)
    args = trainer.parser().parse_args(
        ["--dataset", "pubmed", "--n-heads", "4", "--n-hidden", "64",
         "--dropout", "0.5", "--attn-drop", "0.3", "--lr", "1e-3",
         "--weight-decay", "5e-4", "--n-epochs", "20", "--device", "cuda"])
    bins.reset_launches()
    r = trainer.run(args)
    launches = dict(bins.LAUNCHES)
    losses = r["losses"]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    n_convs = len(r["model"].convs)
    want = {"bin_gat_fwd": (r["train_steps"] + r["infer_calls"]) * n_convs
            * r["graph"].fwd.num_bins,
            "bin_gat_bwd": r["train_steps"] * n_convs * r["graph"].bwd.num_bins}
    assert launches == want, (launches, want)
    model_cpu = copy.deepcopy(r["model"]).to("cpu").eval()
    with torch.no_grad():
        logits_cpu = model_cpu(r["graph"].to("cpu"), r["feats"].cpu())
    torch.testing.assert_close(r["logits"].cpu(), logits_cpu, rtol=1e-4,
                               atol=1e-4)
    assert r["test_acc"] > 0.5, r["test_acc"]  # 3 classes: chance is 1/3
    phase("train", f"pubmed GAT heads (4,1) hidden 64 attn_drop 0.3: "
          f"{r['train_steps']} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, train {r['train_s'] * 1e3:.3f} ms/step, "
          f"inference {r['infer_s'] * 1e3:.3f} ms, peak {r['peak_mb']:.0f} "
          f"MB, test acc {r['test_acc']:.4f}, launches {launches}; card "
          "logits match a CPU copy")

    # 6. kernel and plain times over one pass of pubmed's bins
    times = {}
    for h, f in SHAPES:
        tb = tabs[(h, f)]
        fwd_args = [(tb["feat"], tb["ac"], tb["ar"], nbr, row, count)
                    for _w, nbr, _e, row, count in pub.fwd.bins()]
        bwd_args = [(tb["g"], tb["ar"], tb["M"], tb["Linv"], tb["ws"],
                     tb["ac"], tb["feat"], nbr, row, count)
                    for _w, nbr, _e, row, count in pub.bwd.bins()]
        fkw = dict(slope=SLOPE, with_pos=True, p=0.3, seed=SEED)
        bkw = dict(slope=SLOPE, p=0.3, seed=SEED)
        times[("bin_gat_fwd", h, f)] = time_pair(
            lambda: [bins.bin_gat_fwd(*a, **fkw) for a in fwd_args],
            lambda: [bins.bin_gat_fwd_plain(*a, **fkw) for a in fwd_args],
            time_calls, dev)
        times[("bin_gat_bwd", h, f)] = time_pair(
            lambda: [bins.bin_gat_bwd(*a, **bkw) for a in bwd_args],
            lambda: [bins.bin_gat_bwd_plain(*a, **bkw) for a in bwd_args],
            time_calls, dev)
    for (name, h, f), (ms, plain_ms) in times.items():
        phase("times", f"{name} pubmed all bins H={h} F={f} p=0.3: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms | {smi}")

    h, f = SHAPES[0]
    report = [dict(name=name, **meta, launches=launches[name],
                   max_abs_err=err[name], ms=times[(name, h, f)][0],
                   plain_ms=times[(name, h, f)][1])
              for name, meta in KERNELS.items()]
    print(json.dumps({"kernels": report}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
