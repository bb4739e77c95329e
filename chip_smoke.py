#!/usr/bin/env python3
"""Drive the PyTorch port (dgnn_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (a failure raises; nothing is caught and continued):

  1. device  - requires a CUDA device; prints nvidia-smi's name and power
               limit; turns TF32 off for matmuls and cuDNN.
  2. build   - builds the CUDA kernels from csrc/ (one nvcc per source, in
               parallel, sm_90a) and loads them; prints the build seconds and
               ptxas' register report.
  3. kernels - bin kernels: every bin of synthetic pubmed's forward and
               backward graphs, at (H, F) = (4, 64) and (1, 3), attention
               dropout p 0 and 0.3, with and without the sign-split
               partials, plus a power-law graph with a bin wider than 64 and
               an empty segment (forward rtol 1e-5 / atol 1e-5; backward
               rtol 1e-4 / atol 1e-5, the summation order differs).
               Dense kernels: the hub blocks of cora and citeseer (the
               planner's, both directions) and a forced (1000, 5000) block
               of pubmed (4 row chunks x 3 column tiles, padded rows and
               columns), at (H, F) = (4, 64) and (1, 7), p 0 and 0.3, with
               and without the sign-split partials, dense_dtype float32 and
               bfloat16 (BLOCK_TOL; bf16 also BF16_FLIPS).  Each kernel is
               held against its plain PyTorch version on the card.  One
               flipped dropout bit would give an O(1) difference, so this
               also holds the dropout hash.
  4. op      - gat_aggregate forward and (ar, ac, feat) gradients on the
               card against the same op on CPU copies (the plain path):
               pubmed at p 0 and 0.3; cora (hub block) at p 0 and 0.3 in
               both dense dtypes.
  5. train   - the trainer (scripts/train_gat_torch.py) at the bench width:
               heads (4, 1), hidden 64, feat_drop 0.5, attn_drop 0.3, Adam
               lr 1e-3, weight decay 5e-4, 20 steps and an eval, on cora
               (all four kernels) and on pubmed (the bin kernels).  The loss
               must be finite and fall; the launch counts must be exactly
               what the steps, evals, layers, bins and hub blocks imply; the
               trained model's logits on the card must match a CPU copy's;
               test accuracy must clear a margin above chance.
  6. times   - each kernel and its plain version, CUDA events, in turns:
               the bin kernels over one pass of pubmed's bins, the dense
               kernels over cora's hub block at (4, 64), p 0.3, bf16.  Then
               one gat_aggregate forward + backward on cora with its hub
               block against the all-binned build of the same graph.

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
# A hub-block row sums up to thousands of terms (a bin segment at most
# 128), in another order in the kernel than in the plain version.
BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 mode rounds the same operands on both sides, so the kernel and its
# plain version on the card should agree to summation order.  Where the two
# sides' weights differ by an ulp (the CPU's exp against the card's, or
# merged M, L in another order), a weight can cross a bf16 rounding boundary
# and move that one term by 2^-8 of itself: at most BF16_FLIPS of the
# elements may then leave the float32 tolerance, none may leave BF16_BOUND
# (the bf16-vs-float32 tolerance of tests/test_dense_block.py).
BF16_FLIPS = 1e-3
BF16_BOUND = dict(rtol=2e-2, atol=2e-2)
SLOPE = 0.2
SEED = 0x9E3779B9  # a uint32 dropout seed above the int32 range
SHAPES = ((4, 64), (1, 3))  # (H, F) of pubmed's hidden and output layers
DENSE_SHAPES = ((4, 64), (1, 7))  # (H, F) of cora's hidden and output layers
DENSE_DTYPES = ("float32", "bfloat16")
PUBMED_FORCED = (1000, 5000)  # a forced pubmed block: 4 x 3 tiles
CORA_MIN_ACC = 0.4  # 7 classes: chance is 1/7; 20 CPU steps reach 0.72
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
                        replaces="dgnn_tpu/ops/pallas_bins.py:225"),
    "bin_gat_bwd": dict(route="cuda", source="dgnn_tpu_torch/csrc/bin_gat.cu",
                        replaces="dgnn_tpu/ops/pallas_bins.py:359"),
    "dense_gat_fwd": dict(route="cuda",
                          source="dgnn_tpu_torch/csrc/dense_gat.cu",
                          replaces="dgnn_tpu/ops/pallas_dense.py:265"),
    "dense_gat_bwd": dict(route="cuda",
                          source="dgnn_tpu_torch/csrc/dense_gat.cu",
                          replaces="dgnn_tpu/ops/pallas_dense.py:430"),
}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def tables(gat_forward, graph, h, f, rng, dev):
    """Node tables for one (H, F) shape: random features, coefficients and
    output gradient made with numpy, and the backward's destination tables
    (M, 1 / L, ws = <g, out>) as the op's forward gives them on this graph
    (bins and hub block, float32), from its plain versions on a CPU copy.
    So the backward kernels see attention weights in [0, 1], as on the main
    path."""
    def t(*shape, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a)

    n = graph.num_nodes
    tb = dict(feat=t(n, h, f), ac=t(n, h), ar=t(n, h),
              g=t(n, h, f, scale=G_SCALE))
    out, M, L, _, _ = gat_forward(graph.fwd.to("cpu"), tb["ar"], tb["ac"],
                                  tb["feat"], SLOPE, 0.0, 0, "float32",
                                  with_pos=False)
    tb["M"] = M
    tb["Linv"] = 1.0 / torch.clamp(L, min=1e-20)
    tb["ws"] = (tb["g"] * out).sum(dim=-1)
    return {k: v.to(dev) for k, v in tb.items()}


def assert_close(got, want, tol, dense_dtype="float32", what=""):
    """Every element within ``tol``; in bf16 mode, see BF16_FLIPS.  Returns
    the max |got - want| and the number of elements outside ``tol``."""
    off = int((~torch.isclose(got, want, **tol)).sum())
    if dense_dtype == "float32":
        torch.testing.assert_close(got, want, **tol, msg=lambda m: what + m)
    else:
        torch.testing.assert_close(got, want, **BF16_BOUND,
                                   msg=lambda m: what + m)
        assert off <= BF16_FLIPS * got.numel(), (what, off, got.numel())
    return float((got - want).abs().max()), off


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


def check_dense(dense, graph, tb, err):
    """Both dense kernels against their plain versions on one graph's hub
    blocks; returns (comparisons, elements outside the float32 tolerance)."""
    n_cmp = n_off = 0
    for dt in DENSE_DTYPES:
        for p in (0.0, 0.3):
            for with_pos in (True, False):
                args = (graph.fwd.dense, tb["ar"], tb["ac"], tb["feat"])
                kw = dict(slope=SLOPE, with_pos=with_pos, p=p, seed=SEED,
                          dense_dtype=dt)
                got = dense.dense_gat_fwd(*args, **kw)
                want = dense.dense_gat_fwd_plain(*args, **kw)
                for name, g, w in zip(("m", "l", "lpos", "acc", "accpos"),
                                      got, want):
                    if w is None:
                        assert g is None
                        continue
                    e, off = assert_close(g, w, BLOCK_TOL, dt,
                                          f"dense_gat_fwd {name} {dt} p={p}: ")
                    err["dense_gat_fwd"] = max(err["dense_gat_fwd"], e)
                    n_off += off
                n_cmp += 1
            args = (graph.bwd.dense, *(tb[k] for k in (
                "g", "ar", "M", "Linv", "ws", "ac", "feat")))
            kw = dict(slope=SLOPE, p=p, seed=SEED, dense_dtype=dt)
            got = dense.dense_gat_bwd(*args, **kw)
            want = dense.dense_gat_bwd_plain(*args, **kw)
            for name, g, w in zip(("dx", "dac"), got, want):
                e, off = assert_close(g, w, BLOCK_TOL, dt,
                                      f"dense_gat_bwd {name} {dt} p={p}: ")
                err["dense_gat_bwd"] = max(err["dense_gat_bwd"], e)
                n_off += off
            n_cmp += 1
    torch.cuda.synchronize()
    return n_cmp, n_off


def block_stats(adj):
    """Tiles, padded rows x columns and edges of one direction's block."""
    db = adj.dense
    edges = int(np.unpackbits(db.mask.cpu().numpy()).sum())
    return (f"T={db.mask.shape[0]} {db.row_ids.shape[0]}x"
            f"{db.col_ids.shape[0]} {edges} edges")


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


def run_trainer(trainer, dataset):
    """20 steps at the bench width through the trainer's entry point, with
    every launch count set to 0 just before and read just after."""
    from dgnn_tpu_torch.ops import bins, dense

    args = trainer.parser().parse_args(
        ["--dataset", dataset, "--n-heads", "4", "--n-hidden", "64",
         "--dropout", "0.5", "--attn-drop", "0.3", "--lr", "1e-3",
         "--weight-decay", "5e-4", "--n-epochs", "20", "--device", "cuda"])
    bins.reset_launches()
    dense.reset_launches()
    r = trainer.run(args)
    launches = {**bins.LAUNCHES, **dense.LAUNCHES}
    losses = r["losses"]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    g = r["graph"]
    fwd_calls = (r["train_steps"] + r["infer_calls"]) * len(r["model"].convs)
    bwd_calls = r["train_steps"] * len(r["model"].convs)
    want = {"bin_gat_fwd": fwd_calls * g.fwd.num_bins,
            "bin_gat_bwd": bwd_calls * g.bwd.num_bins,
            "dense_gat_fwd": fwd_calls * (g.fwd.dense is not None),
            "dense_gat_bwd": bwd_calls * (g.bwd.dense is not None)}
    assert launches == want, (launches, want)
    model_cpu = copy.deepcopy(r["model"]).to("cpu").eval()
    with torch.no_grad():
        logits_cpu = model_cpu(g.to("cpu"), r["feats"].cpu())
    got = r["logits"].cpu()
    tol = dict(rtol=1e-4, atol=1e-4)
    r["logit_off"] = int((~torch.isclose(got, logits_cpu, **tol)).sum())
    r["logit_err"] = float((got - logits_cpu).abs().max())
    if g.fwd.dense is not None:
        # bf16 hub-block products: the card's and the CPU's projection
        # matmuls (float32, another order) and exp differ by ulps, which
        # moves some operands across a bf16 rounding boundary; each such
        # term moves by 2^-8 of itself, and two layers spread it to the
        # neighbouring rows.  So the logits are held to BF16_BOUND.
        tol = BF16_BOUND
    torch.testing.assert_close(got, logits_cpu, **tol)
    return r, launches


def main():
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs only "
              "on the card", file=sys.stderr)
        return 1
    from dgnn_tpu_torch.data import synthetic_citation
    from dgnn_tpu_torch.graph import structure
    from dgnn_tpu_torch.ops import _build, bins, dense
    from dgnn_tpu_torch.ops.gat import _gat_forward, gat_aggregate
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
    assert pub.fwd.dense is None and pub.bwd.dense is None
    err = {k: 0.0 for k in KERNELS}
    tabs = {}
    for h, f in SHAPES:
        tabs[(h, f)] = tables(_gat_forward, pub, h, f, rng, dev)
        n_cmp = check_bins(bins, pub.fwd, pub.bwd, tabs[(h, f)], err)
        phase("kernels", f"pubmed H={h} F={f}: fwd widths {pub.fwd.widths} "
              f"bwd widths {pub.bwd.widths}: {n_cmp} kernel/plain "
              "comparisons agree")
    pl = power_law_graph(structure, rng).to(dev)
    pl_tabs = [tables(_gat_forward, pl, h, f, rng, dev) for h, f in SHAPES]
    pl.fwd.count[-1][0] = 0  # an empty segment in the widest bin
    for (h, f), tb in zip(SHAPES, pl_tabs):
        n_cmp = check_bins(bins, pl.fwd, pl.bwd, tb, err)
        phase("kernels", f"power-law H={h} F={f}: fwd widths "
              f"{pl.fwd.widths} (one empty segment): {n_cmp} comparisons "
              "agree")
    hubs = {}
    for name in ("cora", "citeseer"):
        dd = synthetic_citation(name)
        hubs[name] = structure.build_graph(dd.src, dd.dst, dd.num_nodes,
                                           dense="auto",
                                           edge_tables=False).to(dev)
    hubs["pubmed forced"] = structure.build_graph(
        d.src, d.dst, d.num_nodes, dense=PUBMED_FORCED,
        edge_tables=False).to(dev)
    cora_tabs = {}
    for name, g in hubs.items():
        for h, f in DENSE_SHAPES:
            tb = tables(_gat_forward, g, h, f, rng, dev)
            if name == "cora":
                cora_tabs[(h, f)] = tb
            n_cmp, n_off = check_dense(dense, g, tb, err)
            phase("kernels", f"{name} H={h} F={f}: fwd block "
                  f"{block_stats(g.fwd)}, bwd block {block_stats(g.bwd)}: "
                  f"{n_cmp} kernel/plain comparisons agree ({n_off} bf16 "
                  "elements outside BLOCK_TOL)")
    phase("kernels", f"max |kernel - plain|: {json.dumps(err)}")

    # 4. the op on the card against the op on CPU copies
    cora = hubs["cora"]
    cases = [("pubmed", pub, p, "float32") for p in (0.0, 0.3)]
    cases += [("cora", cora, p, dt) for dt in DENSE_DTYPES for p in (0.0, 0.3)]
    for name, graph, p, dt in cases:
        h, f = SHAPES[0]
        n = graph.num_nodes
        arrs = [rng.normal(size=s).astype(np.float32)
                for s in ((n, h), (n, h), (n, h, f), (n, h, f))]
        res = {}
        for where, to in (("card", dev), ("cpu", "cpu")):
            ins = [torch.from_numpy(a).to(to).requires_grad_(True)
                   for a in arrs[:3]]
            out = gat_aggregate(graph.to(to), *ins, attn_drop=p, seed=SEED,
                                training=True, dense_dtype=dt)
            out.backward(torch.from_numpy(arrs[3] * G_SCALE).to(to))
            res[where] = [out.detach().cpu()] + [t.grad.cpu() for t in ins]
        assert_close(res["card"][0], res["cpu"][0], FWD_TOL, dt, "out: ")
        for gname, a, b in zip(("ar", "ac", "feat"), res["card"][1:],
                               res["cpu"][1:]):
            assert_close(a, b, BWD_TOL, dt, f"d{gname}: ")
        phase("op", f"gat_aggregate {name} H={h} F={f} p={p} dense_dtype "
              f"{dt}: output and d(ar, ac, feat) on the card match the CPU")

    # 5. train through the trainer's entry point: cora (all four kernels),
    #    then pubmed (the bin kernels)
    spec = importlib.util.spec_from_file_location(
        "train_gat_torch", ROOT / "scripts" / "train_gat_torch.py")
    trainer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trainer)
    launches = {}
    # pubmed: 3 classes, chance 1/3
    for dataset, min_acc in (("cora", CORA_MIN_ACC), ("pubmed", 0.5)):
        r, launches[dataset] = run_trainer(trainer, dataset)
        losses = r["losses"]
        assert r["test_acc"] > min_acc, (dataset, r["test_acc"])
        phase("train", f"{dataset} GAT heads (4,1) hidden 64 attn_drop 0.3: "
              f"{r['train_steps']} steps, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, train {r['train_s'] * 1e3:.3f} ms/step, "
              f"inference {r['infer_s'] * 1e3:.3f} ms, peak "
              f"{r['peak_mb']:.0f} MB, test acc {r['test_acc']:.4f} (> "
              f"{min_acc}), launches {launches[dataset]}; card logits match "
              f"a CPU copy (max |diff| {r['logit_err']:.3g}, "
              f"{r['logit_off']} of {r['logits'].numel()} outside 1e-4)")

    # 6. times: kernel and plain, in turns
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
    h, f = DENSE_SHAPES[0]
    tb = cora_tabs[(h, f)]
    fa = (cora.fwd.dense, tb["ar"], tb["ac"], tb["feat"])
    fkw = dict(slope=SLOPE, with_pos=True, p=0.3, seed=SEED,
               dense_dtype="bfloat16")
    ba = (cora.bwd.dense, *(tb[k] for k in ("g", "ar", "M", "Linv", "ws",
                                            "ac", "feat")))
    bkw = dict(slope=SLOPE, p=0.3, seed=SEED, dense_dtype="bfloat16")
    times[("dense_gat_fwd", h, f)] = time_pair(
        lambda: dense.dense_gat_fwd(*fa, **fkw),
        lambda: dense.dense_gat_fwd_plain(*fa, **fkw), time_calls, dev)
    times[("dense_gat_bwd", h, f)] = time_pair(
        lambda: dense.dense_gat_bwd(*ba, **bkw),
        lambda: dense.dense_gat_bwd_plain(*ba, **bkw), time_calls, dev)
    for name in ("dense_gat_fwd", "dense_gat_bwd"):
        ms, plain_ms = times[(name, h, f)]
        phase("times", f"{name} cora hub block H={h} F={f} p=0.3 bf16: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms | {smi}")
    dc = synthetic_citation("cora")
    cora_binned = structure.build_graph(dc.src, dc.dst, dc.num_nodes,
                                        dense=None, edge_tables=False).to(dev)
    n = cora.num_nodes
    ins = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
           .requires_grad_(True) for s in ((n, h), (n, h), (n, h, f))]
    g_out = torch.from_numpy(
        rng.normal(size=(n, h, f)).astype(np.float32) * G_SCALE).to(dev)

    def step(graph):
        out = gat_aggregate(graph, *ins, attn_drop=0.3, seed=SEED,
                            training=True)
        out.backward(g_out)

    auto_ms, binned_ms = time_pair(lambda: step(cora), lambda: step(
        cora_binned), time_calls, dev)
    phase("times", f"gat_aggregate fwd+bwd cora H={h} F={f} p=0.3: hub "
          f"block (dense=auto, bins {cora.fwd.widths}/{cora.bwd.widths}) "
          f"{auto_ms:.4f} ms, all-binned (bins {cora_binned.fwd.widths}/"
          f"{cora_binned.bwd.widths}) {binned_ms:.4f} ms | {smi}")

    report = []
    for name, meta in KERNELS.items():
        shape = SHAPES[0] if name.startswith("bin") else DENSE_SHAPES[0]
        ms, plain_ms = times[(name, *shape)]
        # launches: cora's run, the one path that runs all four kernels
        report.append(dict(name=name, **meta,
                           launches=launches["cora"][name],
                           max_abs_err=err[name], ms=ms, plain_ms=plain_ms))
    print(json.dumps({"kernels": report}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
