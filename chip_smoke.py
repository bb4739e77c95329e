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
               also holds the dropout hash.  The bins that these three
               graphs keep beside their blocks go through the bin kernels
               too, at the same shapes.
               MoNet kernels, the same graphs: the bin kernels at (K, F) =
               (3, 64) and (3, 3), the dense kernels at (3, 64) and (3, 7)
               in both dense dtypes, D = 2, tanh on and off (same
               tolerances; the backward's stat rows are held per segment
               and per block row to BWD_TOL / BLOCK_TOL), and the bin
               kernels on the hub graphs' bins at (3, 64) and (3, 7).
  4. op      - gat_aggregate forward and (ar, ac, feat) gradients on the
               card against the same op on CPU copies (the plain path):
               pubmed at p 0 and 0.3; cora (hub block) at p 0 and 0.3 in
               both dense dtypes.  gmm_aggregate_node forward and the
               gradients of feat, proj_weight, proj_bias, mu and inv_sigma
               the same way: pubmed; cora in both dense dtypes.  The
               parameter gradients are sums of signed terms over every
               edge, so they get PARAM_TOL, scaled to the edge count.
  5. train   - the trainers at the bench widths, 20 steps and an eval each,
               on cora (bin and dense kernels) and on pubmed (bin kernels):
               scripts/train_gat_torch.py with heads (4, 1), hidden 64,
               feat_drop 0.5, attn_drop 0.3, Adam lr 1e-3, weight decay
               5e-4; scripts/train_gmm_torch.py with hidden 64, 3 kernels,
               pseudo dim 2, dropout 0.5, Adam lr 1e-2, weight decay 5e-4.
               The loss must be finite and fall; the launch counts must be
               exactly what the steps, evals, layers, bins and hub blocks
               imply, and the other model's kernels must not launch; the
               trained model's logits on the card must match a CPU copy's;
               test accuracy must clear a margin above chance.
  6. times   - each kernel and its plain version, CUDA events, in turns:
               the bin kernels over one pass of pubmed's bins, the dense
               kernels over cora's hub block, at the hidden layer's width
               ((H, F) = (4, 64), p 0.3; (K, F) = (3, 64)), bf16.  Then one
               gat_aggregate and one gmm_aggregate_node forward + backward
               on cora with its hub block against the all-binned build of
               the same graph, and a 1 GiB device-to-device copy.  Each
               kernel's bound is the larger of its bytes (every input
               tensor read once, of a hub block's node tables the rows its
               ids name, every output written once) over 3.35 TB/s
               and its operations (FLOPS_PER_EDGE) over 67 TFLOP/s float32,
               the H100's published peaks.

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
GMM_SHAPES = ((3, 64), (3, 3))  # (K, F) of pubmed's hidden and output layers
GMM_DENSE_SHAPES = ((3, 64), (3, 7))  # (K, F) of cora's layers
GMM_D = 2  # projected pseudo dimensions; Ds = Dd = 1 as the trainer's
# MoNet's parameter gradients (mu, inv_sigma, the pseudo projection) are
# sums over every edge of signed terms of about unit size, taken in another
# order on the card than on the CPU: float32's 2^-23 per summed term is the
# floor, so the absolute tolerance grows with the edge count.
PARAM_TOL = dict(rtol=1e-4, atol_per_edge=2.0 ** -23)
# The H100's published peaks (SXM): HBM3 bytes/s, float32 FLOP/s outside the
# tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_F32 = 67e12
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
    "bin_gmm_node_fwd": dict(route="cuda",
                             source="dgnn_tpu_torch/csrc/bin_gmm.cu",
                             replaces="dgnn_tpu/ops/pallas_bins.py:453"),
    "bin_gmm_node_bwd": dict(route="cuda",
                             source="dgnn_tpu_torch/csrc/bin_gmm.cu",
                             replaces="dgnn_tpu/ops/pallas_bins.py:554"),
    "dense_gmm_fwd": dict(route="cuda",
                          source="dgnn_tpu_torch/csrc/dense_gmm.cu",
                          replaces="dgnn_tpu/ops/pallas_dense.py:539"),
    "dense_gmm_bwd": dict(route="cuda",
                          source="dgnn_tpu_torch/csrc/dense_gmm.cu",
                          replaces="dgnn_tpu/ops/pallas_dense.py:648"),
}
# Float32 operations per edge that each function needs, by (C, G) = (feature
# columns, heads or Gaussian kernels): a multiply-add per column and
# weighted sum, plus the edge's score or Gaussian weights (a dozen
# operations per head or kernel).  The backward adds the <x, g> products.
FLOPS_PER_EDGE = {
    "bin_gat_fwd": lambda C, G: 4 * C + 12 * G,    # acc and accpos
    "bin_gat_bwd": lambda C, G: 4 * C + 14 * G,    # dx and <x, g>
    "bin_gmm_node_fwd": lambda C, G: 2 * C + 12 * G,
    "bin_gmm_node_bwd": lambda C, G: 4 * C + 30 * G,
}
for _k in ("gat_fwd", "gat_bwd"):
    FLOPS_PER_EDGE["dense_" + _k] = FLOPS_PER_EDGE["bin_" + _k]
for _k in ("fwd", "bwd"):
    FLOPS_PER_EDGE["dense_gmm_" + _k] = FLOPS_PER_EDGE["bin_gmm_node_" + _k]


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


def gmm_tables(n, k, f, rng, dev):
    """Node tables and parameters of one MoNet pass at (K, F), made with
    numpy: features, the output gradient (at G_SCALE), both halves of the
    projected pseudo-coordinate, the raw pseudo scalars, and the kernels'
    means and inverse widths."""
    def t(*shape, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    return dict(feat=t(n, k, f), g=t(n, k, f, scale=G_SCALE),
                alpha=t(n, GMM_D), beta=t(n, GMM_D), sfeat=t(n, 1),
                dfeat=t(n, 1), mu=t(k, GMM_D), isig=torch.from_numpy(
                    (rng.random((k, GMM_D)) + 0.5).astype(np.float32)).to(dev))


def gmm_bin_args(tb, nbr, row, count):
    """(forward, backward) argument tuples of one bin."""
    seg = (nbr, row, count, tb["mu"], tb["isig"])
    return ((tb["feat"], tb["alpha"], tb["beta"], *seg),
            (tb["g"], tb["beta"], tb["dfeat"], tb["alpha"], tb["feat"],
             tb["sfeat"], *seg))


def gmm_dense_args(graph, tb):
    """(forward, backward) argument tuples of one graph's hub blocks."""
    par = (tb["mu"], tb["isig"])
    return ((graph.fwd.dense, tb["beta"], tb["alpha"], tb["feat"], *par),
            (graph.bwd.dense, tb["g"], tb["beta"], tb["dfeat"], tb["alpha"],
             tb["feat"], *par))


def check_gmm_bins(bins, adj_fwd, adj_bwd, tb, err):
    """Every bin of one graph, MoNet kernels against their plain versions,
    tanh on and off; returns comparisons."""
    n_cmp = 0
    for use_tanh in (True, False):
        for _w, nbr, _e, row, count in adj_fwd.bins():
            args = gmm_bin_args(tb, nbr, row, count)[0]
            got = bins.bin_gmm_node_fwd(*args, use_tanh=use_tanh)
            want = bins.bin_gmm_node_fwd_plain(*args, use_tanh=use_tanh)
            torch.testing.assert_close(got, want, **FWD_TOL)
            err["bin_gmm_node_fwd"] = max(err["bin_gmm_node_fwd"],
                                          float((got - want).abs().max()))
            n_cmp += 1
        for _w, nbr, _e, row, count in adj_bwd.bins():
            args = gmm_bin_args(tb, nbr, row, count)[1]
            got = bins.bin_gmm_node_bwd(*args, use_tanh=use_tanh)
            want = bins.bin_gmm_node_bwd_plain(*args, use_tanh=use_tanh)
            for name, g, w in zip(("dx", "stat rows"), got, want):
                torch.testing.assert_close(
                    g, w, **BWD_TOL,
                    msg=lambda m: f"bin_gmm_node_bwd {name}: {m}")
                err["bin_gmm_node_bwd"] = max(err["bin_gmm_node_bwd"],
                                              float((g - w).abs().max()))
            n_cmp += 1
    torch.cuda.synchronize()
    return n_cmp


def check_gmm_dense(dense, graph, tb, err):
    """Both dense MoNet kernels against their plain versions on one graph's
    hub blocks; returns (comparisons, elements outside the float32
    tolerance)."""
    n_cmp = n_off = 0
    fwd_args, bwd_args = gmm_dense_args(graph, tb)
    for dt in DENSE_DTYPES:
        for use_tanh in (True, False):
            kw = dict(use_tanh=use_tanh, dense_dtype=dt)
            got = dense.dense_gmm_fwd(*fwd_args, **kw)
            want = dense.dense_gmm_fwd_plain(*fwd_args, **kw)
            e, off = assert_close(got, want, BLOCK_TOL, dt,
                                  f"dense_gmm_fwd acc {dt} tanh={use_tanh}: ")
            err["dense_gmm_fwd"] = max(err["dense_gmm_fwd"], e)
            n_off += off
            got = dense.dense_gmm_bwd(*bwd_args, **kw)
            want = dense.dense_gmm_bwd_plain(*bwd_args, **kw)
            for name, g, w in zip(("dx", "stat rows"), got, want):
                e, off = assert_close(
                    g, w, BLOCK_TOL, dt,
                    f"dense_gmm_bwd {name} {dt} tanh={use_tanh}: ")
                err["dense_gmm_bwd"] = max(err["dense_gmm_bwd"], e)
                n_off += off
            n_cmp += 2
    torch.cuda.synchronize()
    return n_cmp, n_off


def block_stats(adj):
    """Tiles, padded rows x columns and edges of one direction's block."""
    db = adj.dense
    return (f"T={db.mask.shape[0]} {db.row_ids.shape[0]}x"
            f"{db.col_ids.shape[0]} {block_edges(db)} edges")


def block_edges(db):
    return int(np.unpackbits(db.mask.cpu().numpy()).sum())


def bound(name, inputs, outputs, edges, columns, groups):
    """(bound_ms, bound_by) of one timed function on this run's inputs: the
    larger of its bytes (each distinct input tensor read once, each output
    written once) over the card's memory rate and its float32 operations
    over the card's peak rate.  An input given as (table, rows) counts only
    that many of the table's rows: a hub block reads the rows its row_ids
    or col_ids name, not the whole node table."""
    seen = {}
    for t in list(inputs) + list(outputs):
        rows = None
        if isinstance(t, tuple):
            t, rows = t
        if isinstance(t, torch.Tensor):
            nbytes = t.numel() * t.element_size()
            if rows is not None:
                nbytes = nbytes // t.shape[0] * rows
            seen[t.data_ptr()] = nbytes
    by_bytes = sum(seen.values()) / PEAK_BYTES_S
    by_ops = edges * FLOPS_PER_EDGE[name](columns, groups) / PEAK_FLOPS_F32
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def flat(results):
    """The tensors of a list of wrapper results (tuples with Nones)."""
    out = []
    for r in results:
        out += [t for t in (r if isinstance(r, tuple) else (r,))
                if t is not None]
    return out


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


# wrapper names per trainer: bin forward, bin backward, dense forward, dense
# backward
PATH_KERNELS = {
    "gat": ("bin_gat_fwd", "bin_gat_bwd", "dense_gat_fwd", "dense_gat_bwd"),
    "gmm": ("bin_gmm_node_fwd", "bin_gmm_node_bwd", "dense_gmm_fwd",
            "dense_gmm_bwd"),
}


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_trainer(trainer, model_kind, dataset):
    """20 steps at the bench width (the trainer's BENCH_ARGV) through its
    entry point, with every launch count set to 0 just before and read just
    after."""
    from dgnn_tpu_torch.ops import bins, dense

    args = trainer.parser().parse_args(
        ["--dataset", dataset, *trainer.BENCH_ARGV, "--n-epochs", "20",
         "--device", "cuda"])
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
    bin_fwd, bin_bwd, dense_fwd, dense_bwd = PATH_KERNELS[model_kind]
    want = dict.fromkeys(launches, 0)  # the other model's kernels: none
    want.update({bin_fwd: fwd_calls * g.fwd.num_bins,
                 bin_bwd: bwd_calls * g.bwd.num_bins,
                 dense_fwd: fwd_calls * (g.fwd.dense is not None),
                 dense_bwd: bwd_calls * (g.bwd.dense is not None)})
    assert launches == want, (launches, want)
    model_cpu = copy.deepcopy(r["model"]).to("cpu").eval()
    extra = ([type(r["pseudo"])(*(t.cpu() for t in r["pseudo"]))]
             if "pseudo" in r else [])
    with torch.no_grad():
        logits_cpu = model_cpu(g.to("cpu"), r["feats"].cpu(), *extra)
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
    from dgnn_tpu_torch.ops.gmm import gmm_aggregate_node
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
            # the bins beside the block, at this graph's widths
            n_cmp = check_bins(bins, g.fwd, g.bwd, tb, err)
            phase("kernels", f"{name} H={h} F={f}: fwd widths "
                  f"{g.fwd.widths} bwd widths {g.bwd.widths}: {n_cmp} "
                  "kernel/plain comparisons agree")
    # MoNet draws from a generator of its own, so that the GAT checks see
    # the same numbers whether or not the MoNet ones run
    grng = np.random.default_rng(1)
    gmm_tabs = {}
    for k, f in GMM_SHAPES:
        gmm_tabs[(k, f)] = gmm_tables(pub.num_nodes, k, f, grng, dev)
        n_cmp = check_gmm_bins(bins, pub.fwd, pub.bwd, gmm_tabs[(k, f)], err)
        phase("kernels", f"pubmed MoNet K={k} F={f} D={GMM_D}: {n_cmp} "
              "kernel/plain comparisons agree (tanh on and off)")
        n_cmp = check_gmm_bins(bins, pl.fwd, pl.bwd,
                               gmm_tables(pl.num_nodes, k, f, grng, dev), err)
        phase("kernels", f"power-law MoNet K={k} F={f}: fwd widths "
              f"{pl.fwd.widths} (one empty segment): {n_cmp} comparisons "
              "agree")
    cora_gmm_tabs = {}
    for name, g in hubs.items():
        for k, f in GMM_DENSE_SHAPES:
            tb = gmm_tables(g.num_nodes, k, f, grng, dev)
            if name == "cora":
                cora_gmm_tabs[(k, f)] = tb
            n_cmp, n_off = check_gmm_dense(dense, g, tb, err)
            phase("kernels", f"{name} MoNet K={k} F={f} D={GMM_D}: {n_cmp} "
                  f"kernel/plain comparisons agree ({n_off} bf16 elements "
                  "outside BLOCK_TOL)")
            n_cmp = check_gmm_bins(bins, g.fwd, g.bwd, tb, err)
            phase("kernels", f"{name} MoNet K={k} F={f}: fwd widths "
                  f"{g.fwd.widths} bwd widths {g.bwd.widths}: {n_cmp} "
                  "bin kernel/plain comparisons agree (tanh on and off)")
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

    gmm_names = ("feat", "proj_weight", "proj_bias", "mu", "inv_sigma")
    for name, graph, dt in [("pubmed", pub, "float32")] + [
            ("cora", cora, dt) for dt in DENSE_DTYPES]:
        k, f = GMM_SHAPES[0]
        n = graph.num_nodes
        arrs = dict(feat=grng.normal(size=(n, k, f)),
                    proj_weight=grng.normal(size=(2, GMM_D)),
                    proj_bias=grng.normal(size=(GMM_D,)),
                    mu=grng.normal(size=(k, GMM_D)),
                    inv_sigma=grng.random((k, GMM_D)) + 0.5,
                    s=grng.normal(size=(n, 1)), d=grng.normal(size=(n, 1)),
                    g=grng.normal(size=(n, k, f)) * G_SCALE)
        arrs = {key: a.astype(np.float32) for key, a in arrs.items()}
        res = {}
        for where, to in (("card", dev), ("cpu", "cpu")):
            t = {key: torch.from_numpy(a).to(to) for key, a in arrs.items()}
            ins = {key: t[key].requires_grad_(True) for key in gmm_names}
            out = gmm_aggregate_node(
                graph.to(to), ins["feat"], t["s"], t["d"], ins["mu"],
                ins["inv_sigma"], proj_weight=ins["proj_weight"],
                proj_bias=ins["proj_bias"], dense_dtype=dt)
            out.backward(t["g"])
            res[where] = [out.detach().cpu()] + [ins[key].grad.cpu()
                                                 for key in gmm_names]
        assert_close(res["card"][0], res["cpu"][0], FWD_TOL, dt, "out: ")
        assert_close(res["card"][1], res["cpu"][1], BWD_TOL, dt, "dfeat: ")
        param_tol = dict(rtol=PARAM_TOL["rtol"],
                         atol=PARAM_TOL["atol_per_edge"] * graph.num_edges)
        worst = 0.0
        for gname, a, b in zip(gmm_names[1:], res["card"][2:],
                               res["cpu"][2:]):
            # a handful of numbers each: the bf16 flip share does not apply
            torch.testing.assert_close(
                a, b, **(param_tol if dt == "float32" else BF16_BOUND),
                msg=lambda m: f"d{gname} {name} {dt}: {m}")
            worst = max(worst, float(((a - b).abs() / b.abs().clamp(
                min=1e-12)).max()))
        phase("op", f"gmm_aggregate_node {name} K={k} F={f} dense_dtype {dt}: "
              "output and d(feat, proj_weight, proj_bias, mu, inv_sigma) on "
              f"the card match the CPU (parameter gradients: rtol "
              f"{param_tol['rtol']}, atol {param_tol['atol']:.3g}; largest "
              f"relative difference {worst:.3g})")

    # 5. train through the trainers' entry points: cora (bin and dense
    #    kernels), then pubmed (the bin kernels), GAT then MoNet
    trainers = {"gat": load_script("train_gat_torch"),
                "gmm": load_script("train_gmm_torch")}
    titles = {"gat": "GAT heads (4,1) hidden 64 attn_drop 0.3",
              "gmm": "MoNet hidden 64 kernels 3 dim 2 dropout 0.5 lr 1e-2"}
    launches = {}
    # pubmed: 3 classes, chance 1/3
    for kind, dataset, min_acc in (("gat", "cora", CORA_MIN_ACC),
                                   ("gat", "pubmed", 0.5),
                                   ("gmm", "cora", CORA_MIN_ACC),
                                   ("gmm", "pubmed", 0.5)):
        r, launches[(kind, dataset)] = run_trainer(trainers[kind], kind,
                                                   dataset)
        losses = r["losses"]
        assert r["test_acc"] > min_acc, (kind, dataset, r["test_acc"])
        used = {k: v for k, v in launches[(kind, dataset)].items() if v}
        phase("train", f"{dataset} {titles[kind]}: "
              f"{r['train_steps']} steps, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, train {r['train_s'] * 1e3:.3f} ms/step, "
              f"inference {r['infer_s'] * 1e3:.3f} ms, peak "
              f"{r['peak_mb']:.0f} MB, test acc {r['test_acc']:.4f} (> "
              f"{min_acc}), launches {used} (every other kernel 0); card "
              "logits match "
              f"a CPU copy (max |diff| {r['logit_err']:.3g}, "
              f"{r['logit_off']} of {r['logits'].numel()} outside 1e-4)")

    # 6. times: kernel and plain, in turns.  One job per (kernel, shape):
    #    (what it ran on, kernel call, plain call, input tensors, edges,
    #    feature columns, heads or Gaussian kernels)
    def edges_of(adj):
        return sum(int(c.sum()) for c in adj.count)

    jobs = {}
    for h, f in SHAPES:
        tb = tabs[(h, f)]
        fwd_args = [(tb["feat"], tb["ac"], tb["ar"], nbr, row, count)
                    for _w, nbr, _e, row, count in pub.fwd.bins()]
        bwd_args = [(tb["g"], tb["ar"], tb["M"], tb["Linv"], tb["ws"],
                     tb["ac"], tb["feat"], nbr, row, count)
                    for _w, nbr, _e, row, count in pub.bwd.bins()]
        fkw = dict(slope=SLOPE, with_pos=True, p=0.3, seed=SEED)
        bkw = dict(slope=SLOPE, p=0.3, seed=SEED)
        what = f"pubmed all bins H={h} F={f} p=0.3"
        jobs[("bin_gat_fwd", h, f)] = (
            what,
            lambda a=fwd_args, kw=fkw: [bins.bin_gat_fwd(*x, **kw) for x in a],
            lambda a=fwd_args, kw=fkw: [bins.bin_gat_fwd_plain(*x, **kw)
                                        for x in a],
            flat(fwd_args), edges_of(pub.fwd), h * f, h)
        jobs[("bin_gat_bwd", h, f)] = (
            what,
            lambda a=bwd_args, kw=bkw: [bins.bin_gat_bwd(*x, **kw) for x in a],
            lambda a=bwd_args, kw=bkw: [bins.bin_gat_bwd_plain(*x, **kw)
                                        for x in a],
            flat(bwd_args), edges_of(pub.bwd), h * f, h)
    k, f = GMM_SHAPES[0]
    tb = gmm_tabs[(k, f)]
    fwd_args = [gmm_bin_args(tb, nbr, row, count)[0]
                for _w, nbr, _e, row, count in pub.fwd.bins()]
    bwd_args = [gmm_bin_args(tb, nbr, row, count)[1]
                for _w, nbr, _e, row, count in pub.bwd.bins()]
    what = f"pubmed all bins K={k} F={f} D={GMM_D} tanh"
    jobs[("bin_gmm_node_fwd", k, f)] = (
        what,
        lambda a=fwd_args: [bins.bin_gmm_node_fwd(*x, use_tanh=True)
                            for x in a],
        lambda a=fwd_args: [bins.bin_gmm_node_fwd_plain(*x, use_tanh=True)
                            for x in a],
        flat(fwd_args), edges_of(pub.fwd), k * f, k)
    jobs[("bin_gmm_node_bwd", k, f)] = (
        what,
        lambda a=bwd_args: [bins.bin_gmm_node_bwd(*x, use_tanh=True)
                            for x in a],
        lambda a=bwd_args: [bins.bin_gmm_node_bwd_plain(*x, use_tanh=True)
                            for x in a],
        flat(bwd_args), edges_of(pub.bwd), k * f, k)

    def block_inputs(db, by_row, by_col, whole=()):
        """A hub block's inputs: its ids, mask and schedule in full, and of
        each node table the rows that row_ids (by_row) or col_ids (by_col)
        name."""
        n_row = int(torch.unique(db.row_ids).numel())
        n_col = int(torch.unique(db.col_ids).numel())
        return ([db.row_ids, db.col_ids, db.mask, db.ct, db.chunk_ptr, *whole]
                + [(t, n_row) for t in by_row] + [(t, n_col) for t in by_col])

    h, f = DENSE_SHAPES[0]
    tb = cora_tabs[(h, f)]
    fa = (cora.fwd.dense, tb["ar"], tb["ac"], tb["feat"])
    fkw = dict(slope=SLOPE, with_pos=True, p=0.3, seed=SEED,
               dense_dtype="bfloat16")
    ba = (cora.bwd.dense, *(tb[k_] for k_ in ("g", "ar", "M", "Linv", "ws",
                                              "ac", "feat")))
    bkw = dict(slope=SLOPE, p=0.3, seed=SEED, dense_dtype="bfloat16")
    what = f"cora hub block H={h} F={f} p=0.3 bf16"
    jobs[("dense_gat_fwd", h, f)] = (
        what, lambda: [dense.dense_gat_fwd(*fa, **fkw)],
        lambda: [dense.dense_gat_fwd_plain(*fa, **fkw)],
        block_inputs(fa[0], [tb["ar"]], [tb["ac"], tb["feat"]]),
        block_edges(fa[0]), h * f, h)
    jobs[("dense_gat_bwd", h, f)] = (
        what, lambda: [dense.dense_gat_bwd(*ba, **bkw)],
        lambda: [dense.dense_gat_bwd_plain(*ba, **bkw)],
        block_inputs(ba[0], [tb["ac"], tb["feat"]],
                     [tb[k_] for k_ in ("g", "ar", "M", "Linv", "ws")]),
        block_edges(ba[0]), h * f, h)
    k, f = GMM_DENSE_SHAPES[0]
    tb = cora_gmm_tabs[(k, f)]
    gfa, gba = gmm_dense_args(cora, tb)
    par = (tb["mu"], tb["isig"])
    gkw = dict(use_tanh=True, dense_dtype="bfloat16")
    what = f"cora hub block K={k} F={f} D={GMM_D} tanh bf16"
    jobs[("dense_gmm_fwd", k, f)] = (
        what, lambda: [dense.dense_gmm_fwd(*gfa, **gkw)],
        lambda: [dense.dense_gmm_fwd_plain(*gfa, **gkw)],
        block_inputs(gfa[0], [tb["beta"]], [tb["alpha"], tb["feat"]], par),
        block_edges(gfa[0]), k * f, k)
    jobs[("dense_gmm_bwd", k, f)] = (
        what, lambda: [dense.dense_gmm_bwd(*gba, **gkw)],
        lambda: [dense.dense_gmm_bwd_plain(*gba, **gkw)],
        block_inputs(gba[0], [tb["alpha"], tb["feat"]],
                     [tb["g"], tb["beta"], tb["dfeat"]], par),
        block_edges(gba[0]), k * f, k)

    times = {}
    for key, (what, fn_kernel, fn_plain, inputs, edges, cols, groups) in \
            jobs.items():
        ms, plain_ms = time_pair(fn_kernel, fn_plain, time_calls, dev)
        bound_ms, bound_by = bound(key[0], inputs, flat(fn_kernel()), edges,
                                   cols, groups)
        times[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
        phase("times", f"{key[0]} {what}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
              f"({edges} edges), no single library call | {smi}")

    dc = synthetic_citation("cora")
    cora_binned = structure.build_graph(dc.src, dc.dst, dc.num_nodes,
                                        dense=None, edge_tables=False).to(dev)
    n = cora.num_nodes
    h, f = DENSE_SHAPES[0]
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
    layouts = (f"hub block (dense=auto, bins {cora.fwd.widths}/"
               f"{cora.bwd.widths}) {{:.4f}} ms, all-binned (bins "
               f"{cora_binned.fwd.widths}/{cora_binned.bwd.widths}) {{:.4f}} "
               f"ms | {smi}")
    phase("times", f"gat_aggregate fwd+bwd cora H={h} F={f} p=0.3: "
          + layouts.format(auto_ms, binned_ms))
    k, f = GMM_DENSE_SHAPES[0]
    tb = cora_gmm_tabs[(k, f)]
    gins = {key: tb[key].clone().requires_grad_(True)
            for key in ("feat", "mu", "isig")}
    pw = torch.from_numpy(grng.normal(size=(2, GMM_D)).astype(np.float32)) \
        .to(dev).requires_grad_(True)
    pb = torch.zeros(GMM_D, device=dev, requires_grad=True)

    def gmm_step(graph):
        out = gmm_aggregate_node(graph, gins["feat"], tb["sfeat"],
                                 tb["dfeat"], gins["mu"], gins["isig"],
                                 proj_weight=pw, proj_bias=pb)
        out.backward(tb["g"])

    auto_ms, binned_ms = time_pair(lambda: gmm_step(cora), lambda: gmm_step(
        cora_binned), time_calls, dev)
    phase("times", f"gmm_aggregate_node fwd+bwd cora K={k} F={f} D={GMM_D}: "
          + layouts.format(auto_ms, binned_ms))
    # the card's memory rate: a 1 GiB device-to-device copy reads and writes
    # 1 GiB each
    src = torch.empty(2 ** 30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_s = time_calls(lambda: dst.copy_(src), dev, iters=10, warmup=2)
    phase("times", f"device copy 1 GiB: {copy_s * 1e3:.4f} ms, "
          f"{2 * 2 ** 30 / copy_s / 1e12:.3f} TB/s read + write (published "
          f"peak {PEAK_BYTES_S / 1e12} TB/s) | {smi}")
    del src, dst

    report = []
    for name, meta in KERNELS.items():
        # the kernel's first job: the hidden layer's width
        shape = next(key[1:] for key in jobs if key[0] == name)
        # launches: the cora run of the kernel's model, the path that runs
        # its bin and its dense kernels
        kind = "gat" if "gat" in name else "gmm"
        report.append(dict(name=name, **meta,
                           launches=launches[(kind, "cora")][name],
                           max_abs_err=err[name], **times[(name, *shape)]))
        assert report[-1]["launches"] > 0, name
    print(json.dumps({"kernels": report}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
