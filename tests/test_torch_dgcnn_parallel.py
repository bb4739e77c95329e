"""Batch-data-parallel DGCNN training and the sharded MoNet trainer on
torch.distributed (gloo, CPU ranks), against the single-device port and the
JAX trainer.

- ``GlobalBatchNorm`` at P = 2 and 4: output, input gradient, ``scale`` /
  ``bias`` gradients and running statistics against the single-device
  ``BatchNorm`` on the concatenated batch; in eval mode, its running
  statistics with no collective;
- ``train_dgcnn_rank`` at P = 2 and 4, dropout 0: three steps against the
  JAX trainer's ``train_step`` with its optax chain on the same permuted
  and augmented batches, from the same flax weights (``load_flax_dgcnn``),
  at tests/test_torch_dgcnn_loop.py's tolerances: every loss, parameter
  and batch statistic;
- the same at dropout 0.5 against the port's single-device trainer
  (scripts/train_edgeconv_torch.py ``train_step`` on ``shuffle_augment``'s
  batches) under the same generators; the ranks' final states equal bit
  for bit; the all-reduces counted;
- ``dgcnn_grads`` (the chip check's one step) against the single-device
  step: logits, loss, every gradient and the batch statistics;
- ``train_monet_rank`` at P = 2, three Adam steps against the
  single-device port MoNet with the same weights and node pseudo.

The DGCNN is the JAX package's multi-chip dry run's (``__graft_entry__.py``):
B = 8 clouds of 32 points, k = 4, dims (8, 8), emb (16, 16), 5 classes.
JAX is imported inside the fixture only; the ranks are spawned once per
world size and run every case of that size (each spawn costs seconds).
"""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.models import DGCNN, MoNet, flax_dgcnn_state_dict
from dgnn_tpu_torch.models.convert import load_flax_dgcnn
from dgnn_tpu_torch.models.dgcnn import BatchNorm
from dgnn_tpu_torch.ops.gmm import NodePseudo
from dgnn_tpu_torch.parallel import (ALLREDUCES, GlobalBatchNorm,
                                     ShardedDGCNN, allreduce_grads,
                                     partition_graph, reset_exchanges,
                                     run_ranks)
from dgnn_tpu_torch.parallel.trainer import (MONET_LR, DGCNNJob, MoNetJob,
                                             degree_pseudo, dgcnn_grads,
                                             train_rank)
from dgnn_tpu_torch.utils.training import (make_optimizer, make_sgd_cosine,
                                           masked_loss, shuffle_augment,
                                           smoothed_loss)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
# __graft_entry__.py's data-parallel DGCNN
KW = dict(k=4, feature_dims=(8, 8), emb_dims=(16, 16), output_classes=5)
B, P, SEED = 8, 32, 3
STEPS, WARMUP = 2, 1      # three steps: one warmup, two timed
BN_TOL = dict(rtol=1e-5, atol=1e-6)
# tests/test_torch_dgcnn_loop.py's: three SGD steps, float32 sums in
# another order, and the EdgeConv backward's bf16 rounding of g, where an
# ulp's difference in a float32 sum can flip a rounding and move a gradient
# element by 2^-8 of itself, which lr 0.1 carries into the weights.  The
# P-rank steps against the single-device port's differ only in the order of
# the batch norm's sums and of the gradients' sum over the ranks, but that
# is such an ulp (one of 24 first-layer weights moved 1.05e-5 at P = 2 on
# a CPU), so their weights are held to it too; their losses to rtol 1e-5.
STEPS_TOL = dict(rtol=1e-3, atol=1e-4)
# one step, before any optimizer step: the model's one-step tolerance of
# tests/test_torch_edgeconv.py (MODEL_TOL; float32 matrix products on other
# row counts and the batch norm's sums in another order, four layers deep)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
# ... but the EdgeConv layers' parameter gradients come through the
# EdgeConv backward, which rounds g to bf16 (mul_dtype): where g differs by
# a float32 ulp between the two sides, a rounding can flip and move a term
# by 2^-8 of itself, and a gradient that sums terms of both signs can move
# by that much of its larger terms (on a CPU: 8.3e-5 on an element of 0.0143,
# the tensor's largest 0.26, at emb (16, 16, 8)).  Their atol is that flip's
# share of the tensor's largest element.
CONV_FLIP = 2.0 ** -8


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# what a rank runs
# ---------------------------------------------------------------------------


def _bn_rank(rank, world, case):
    """GlobalBatchNorm on this rank's rows of case["x"]: its output, input
    gradient of <out, g>, the summed scale / bias gradients, the running
    statistics, the eval-mode output and the all-reduces it made."""
    rows = slice(rank * len(case["x"]) // world,
                 (rank + 1) * len(case["x"]) // world)
    bn = GlobalBatchNorm(case["x"].shape[-1])
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(case["scale"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))
    x = torch.from_numpy(case["x"][rows]).requires_grad_(True)
    reset_exchanges()
    out = bn.train()(x)
    (out * torch.from_numpy(case["g"][rows])).sum().backward()
    allreduce_grads(bn)
    counted = ALLREDUCES["allreduces"]
    with torch.no_grad():
        evaled = bn.eval()(x)
    return dict(out=out.detach().numpy(), dx=x.grad.numpy(),
                dscale=bn.scale.grad.numpy(), dbias=bn.bias.grad.numpy(),
                mean=bn.mean.numpy(), var=bn.var.numpy(),
                eval=evaled.numpy(), allreduces=counted,
                eval_allreduces=ALLREDUCES["allreduces"] - counted)


def _rank_cases(rank, world, cases):
    results = {}
    for name, case in cases.items():
        if isinstance(case, (DGCNNJob, MoNetJob)):
            results[name] = train_rank(rank, world, case)
        elif name == "bn":
            results[name] = _bn_rank(rank, world, case)
        else:
            r = dgcnn_grads(case, rank, world, device="cpu")
            results[name] = dict(
                logits=r["logits"].numpy(), loss=float(r["loss"]),
                grads={k: g.numpy() for k, g in r["grads"].items()},
                stats={k: v.numpy() for k, v in r["stats"].items()})
    return results


# ---------------------------------------------------------------------------
# the cases and their references (this process)
# ---------------------------------------------------------------------------


def _bn_case(rng):
    """A [B, 5, 16] batch (norm over the first two axes) and its
    single-device BatchNorm: output, gradients, running statistics, eval
    output."""
    x = rng.normal(size=(B, 5, 16)).astype(np.float32) * 3 + 1
    case = dict(x=x, g=rng.normal(size=x.shape).astype(np.float32),
                scale=rng.normal(size=16).astype(np.float32),
                bias=rng.normal(size=16).astype(np.float32))
    bn = BatchNorm(16)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(case["scale"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = bn.train()(xt)
    (out * torch.from_numpy(case["g"])).sum().backward()
    with torch.no_grad():
        evaled = bn.eval()(xt)
    want = dict(out=out.detach().numpy(), dx=xt.grad.numpy(),
                dscale=bn.scale.grad.numpy(), dbias=bn.bias.grad.numpy(),
                mean=bn.mean.numpy(), var=bn.var.numpy(), eval=evaled.numpy())
    return case, want


def _clouds(rng, n):
    return (rng.normal(size=(n, P, 3)).astype(np.float32),
            rng.integers(0, KW["output_classes"], n))


def _jax_case(rng):
    """dropout 0: the job (from flax weights) and the JAX trainer's three
    steps on the batches the job's generator draws (its permutation and
    augmentation of the 24 clouds, one epoch)."""
    import jax
    import jax.numpy as jnp
    import optax
    from dgnn_tpu.models import DGCNN as FDGCNN

    jtrainer = _load("train_edgeconv")
    x, y = _clouds(rng, (STEPS + WARMUP) * B)
    fmodel = FDGCNN(dropout=0.0, **KW)
    variables = jax.tree_util.tree_map(
        np.asarray, fmodel.init(jax.random.PRNGKey(0), jnp.asarray(x[:B])))
    state = load_flax_dgcnn(DGCNN(dropout=0.0, **KW), variables).state_dict()
    job = DGCNNJob(x_train=x, y_train=y, n_classes=KW["output_classes"],
                   batch_size=B, k=KW["k"], feature_dims=KW["feature_dims"],
                   emb_dims=KW["emb_dims"], dropout=0.0, steps=STEPS,
                   warmup=WARMUP, seed=SEED, state=state, device="cpu")
    xs, ys = shuffle_augment(torch.from_numpy(x), torch.from_numpy(y),
                             torch.Generator().manual_seed(SEED))
    xs, ys = xs.numpy(), ys.numpy().astype(np.int32)
    params, stats = variables["params"], variables["batch_stats"]
    total = STEPS + WARMUP
    tx = optax.chain(optax.add_decayed_weights(1e-4),
                     optax.sgd(optax.cosine_decay_schedule(0.1, total,
                                                           alpha=0.01),
                               momentum=0.9))
    opt_state = tx.init(params)
    losses = []
    for i in range(total):
        xb, yb = xs[i * B:(i + 1) * B], ys[i * B:(i + 1) * B]

        def loss_fn(prm, xb=xb, yb=yb, stats=stats):
            logits, upd = fmodel.apply(
                {"params": prm, "batch_stats": stats}, jnp.asarray(xb),
                training=True, mutable=["batch_stats"])
            return jtrainer.compute_loss(logits, jnp.asarray(yb)), \
                upd["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    want = flax_dgcnn_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                 jax.tree_util.tree_map(np.asarray, stats))
    return job, dict(losses=losses,
                     state={k: v.numpy() for k, v in want.items()})


def _dropout_case(rng):
    """dropout 0.5 over two epochs of two steps (a second shuffle): the job
    from DGCNN's seeded init, and the port's single-device trainer with the
    same init, optimizer and generator."""
    trainer = _load("train_edgeconv_torch")
    x, y = _clouds(rng, 2 * B + 3)  # the trainer keeps whole batches
    job = DGCNNJob(x_train=x, y_train=y, n_classes=KW["output_classes"],
                   batch_size=B, k=KW["k"], feature_dims=KW["feature_dims"],
                   emb_dims=KW["emb_dims"], dropout=0.5, steps=STEPS,
                   warmup=WARMUP, seed=SEED, device="cpu")
    model = DGCNN(dropout=0.5, generator=torch.Generator().manual_seed(SEED),
                  **KW)
    total = STEPS + WARMUP
    opt = make_sgd_cosine(model, total)
    gen = torch.Generator().manual_seed(SEED)
    xt, yt = torch.from_numpy(x[:2 * B]), torch.from_numpy(y[:2 * B])
    losses = []
    for i in range(total):
        if i % 2 == 0:
            xs, ys = shuffle_augment(xt, yt, gen)
        sl = slice((i % 2) * B, (i % 2 + 1) * B)
        loss, _ = trainer.train_step(model, opt, xs[sl], ys[sl], gen)
        losses.append(float(loss))
    return job, dict(losses=losses, state={
        k: v.numpy() for k, v in model.state_dict().items()})


def _grads_case(rng):
    """dgcnn_grads' spec at dropout 0.5 and the single-device step."""
    x, y = _clouds(rng, B)
    kwargs = dict(KW, dropout=0.5)
    model = DGCNN(**kwargs, generator=torch.Generator().manual_seed(1))
    spec = dict(kwargs=kwargs, state={k: v.clone() for k, v in
                                      model.state_dict().items()},
                x=x, y=y, seed=SEED)
    logits = model.train()(torch.from_numpy(x),
                           generator=torch.Generator().manual_seed(SEED))
    loss = smoothed_loss(logits, torch.from_numpy(y))
    loss.backward()
    return spec, dict(logits=logits.detach().numpy(),
                      loss=float(loss.detach()),
                      grads={k: p.grad.numpy()
                             for k, p in model.named_parameters()},
                      stats={k: v.numpy()
                             for k, v in model.bns.named_buffers()})


def _monet_case(rng):
    """A MoNet job at P = 2 on a power-law graph whose shards keep hub
    blocks (float32), dropout 0, and the single-device port MoNet trained
    with the same init, pseudo, loss and Adam steps."""
    from tests.conftest import random_graph

    n, in_feats, n_cls = 64, 8, 3
    src, dst = random_graph(rng, n, 4, power_law=True)
    feat = rng.normal(size=(n, in_feats)).astype(np.float32)
    labels = rng.integers(0, n_cls, n)
    train = rng.random(n) < 0.5
    pseudo = degree_pseudo(dst, n)
    shards = partition_graph(src, dst, n, 2, widths=(4, 16), dense=(8, 24))
    assert shards.fwd_dense is not None and shards.bwd_dense is not None
    job = MoNetJob(shards=shards, features=feat, labels=labels,
                   train_mask=train, pseudo=pseudo, n_classes=n_cls,
                   n_hidden=8, n_kernels=2, dim=2, dropout=0.0, steps=STEPS,
                   warmup=WARMUP, dense_dtype="float32", device="cpu")
    model = MoNet(in_feats, 8, n_cls, 1, 2, 2, dropout=0.0,
                  generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model, MONET_LR, job.weight_decay)
    g = build_graph(src, dst, n, widths=(4, 16))
    ps = torch.from_numpy(pseudo)
    x, y = torch.from_numpy(feat), torch.from_numpy(labels).long()
    mask = torch.from_numpy(train)
    losses = []
    for _ in range(STEPS + WARMUP):
        opt.zero_grad()
        loss = masked_loss(model.train()(g, x, NodePseudo(src=ps, dst=ps)),
                           y, mask)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        logits = model.eval()(g, x, NodePseudo(src=ps, dst=ps)).numpy()
    return job, dict(losses=losses, logits=logits)


@pytest.fixture(scope="module")
def ranks():
    """{world: (the cases' references, {case: the ranks' results})}."""
    rng = np.random.default_rng(0)
    bn, bn_want = _bn_case(rng)
    jax_job, jax_want = _jax_case(rng)
    drop_job, drop_want = _dropout_case(rng)
    spec, spec_want = _grads_case(rng)
    monet_job, monet_want = _monet_case(rng)
    wants = dict(bn=bn_want, jax=jax_want, dropout=drop_want,
                 grads=spec_want, monet=monet_want)
    cases = dict(bn=bn, jax=jax_job, dropout=drop_job, grads=spec)
    out = {}
    for world in WORLDS:
        world_cases = dict(cases, monet=monet_job) if world == 2 else cases
        results = run_ranks(_rank_cases, world, world_cases, device="cpu")
        out[world] = (wants, {name: [r[name] for r in results]
                              for name in world_cases})
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_sharded_dgcnn_keeps_dgcnn_names():
    """ShardedDGCNN's parameters, buffers and their order are DGCNN's, its
    init too, so a single-device state_dict loads strictly; its batch
    norms are GlobalBatchNorms."""
    want = DGCNN(generator=torch.Generator().manual_seed(0), **KW)
    got = ShardedDGCNN(generator=torch.Generator().manual_seed(0), **KW)
    assert list(got.state_dict()) == list(want.state_dict())
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    got.load_state_dict(want.state_dict(), strict=True)
    assert all(isinstance(bn, GlobalBatchNorm) for bn in got.bns.values())


@pytest.mark.parametrize("world", WORLDS)
def test_global_batchnorm_matches_single(ranks, world):
    """The ranks' rows of the output and of the input gradient, the summed
    scale / bias gradients and every rank's running statistics equal the
    single BatchNorm's on the whole batch; one all-reduce forward, one
    backward, one of the parameter gradients; eval mode reads the running
    statistics with none."""
    wants, got = ranks[world]
    want, res = wants["bn"], got["bn"]
    for key in ("out", "dx", "eval"):
        np.testing.assert_allclose(np.concatenate([r[key] for r in res]),
                                   want[key], **BN_TOL, err_msg=key)
    for r in res:
        for key in ("dscale", "dbias", "mean", "var"):
            np.testing.assert_allclose(r[key], want[key], **BN_TOL,
                                       err_msg=key)
            np.testing.assert_array_equal(r[key], res[0][key])
        assert (r["allreduces"], r["eval_allreduces"]) == (3, 0)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_steps_match_jax_trainer(ranks, world):
    """Three data-parallel steps at dropout 0 = the JAX trainer's three
    steps on the same batches from the same flax weights: each step's loss
    (the ranks' shares summed) and every parameter and batch statistic
    after them."""
    wants, got = ranks[world]
    want, res = wants["jax"], got["jax"]
    loss = [sum(v) for v in zip(*(r["losses"] for r in res))]
    np.testing.assert_allclose(loss, want["losses"], rtol=1e-5)
    assert set(res[0]["state"]) == set(want["state"])
    for k, v in want["state"].items():
        np.testing.assert_allclose(res[0]["state"][k].numpy(), v,
                                   err_msg=k, **STEPS_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_dropout_steps_match_single_device(ranks, world):
    """At dropout 0.5, over two epochs (two shuffles), the P-rank steps =
    the port's single-device trainer steps under the same generators: the
    losses and every parameter and batch statistic."""
    wants, got = ranks[world]
    want, res = wants["dropout"], got["dropout"]
    loss = [sum(v) for v in zip(*(r["losses"] for r in res))]
    np.testing.assert_allclose(loss, want["losses"], rtol=1e-5)
    for k, v in want["state"].items():
        np.testing.assert_allclose(res[0]["state"][k].numpy(), v,
                                   err_msg=k, **STEPS_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_ranks_agree_and_count(ranks, world):
    """Every rank ends with the same bits (digest and state); no kernel
    launched on the CPU; a step all-reduces the gradients once and the one
    batch norm's statistics forward and backward, on gloo/cpu."""
    _, got = ranks[world]
    for name in ("jax", "dropout"):
        res = got[name]
        assert len({r["digest"] for r in res}) == 1
        for r in res[1:]:
            for k, v in res[0]["state"].items():
                assert torch.equal(r["state"][k], v), (name, k)
        n_params = sum(v.numel() for k, v in res[0]["state"].items()
                       if not k.endswith((".mean", ".var")))
        steps = STEPS + WARMUP
        for r in res:
            assert r["launches"] == {}
            assert r["allreduces"] == dict(
                allreduces=3 * steps, route="gloo/cpu",
                bytes=steps * 4 * (n_params + 2 * 2 * KW["emb_dims"][1]))
            assert len(r["losses"]) == steps and r["step_s"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_dgcnn_grads_match_single_device(ranks, world):
    """dgcnn_grads (one step, dropout 0.5): the ranks' logits rows, summed
    loss shares, every summed gradient (the same on every rank; the
    EdgeConv layers' within a bf16 flip, CONV_FLIP) and the batch
    statistics = the single-device step's."""
    wants, got = ranks[world]
    want, res = wants["grads"], got["grads"]
    np.testing.assert_allclose(np.concatenate([r["logits"] for r in res]),
                               want["logits"], **STEP_TOL)
    np.testing.assert_allclose(sum(r["loss"] for r in res), want["loss"],
                               rtol=1e-5)
    for r in res:
        assert set(r["grads"]) == set(want["grads"])
        for k, v in want["grads"].items():
            tol = STEP_TOL
            if k.startswith("convs."):
                tol = dict(STEP_TOL, atol=CONV_FLIP * float(np.abs(v).max()))
            np.testing.assert_allclose(r["grads"][k], v, err_msg=k, **tol)
            np.testing.assert_array_equal(r["grads"][k],
                                          res[0]["grads"][k])
        for k, v in want["stats"].items():
            np.testing.assert_allclose(r["stats"][k], v, err_msg=k,
                                       **STEP_TOL)


def test_monet_rank_matches_single_device(ranks):
    """train_monet_rank at P = 2 (hub blocks in both directions, float32)
    = the single-device MoNet: each step's loss (the ranks' shares summed)
    and the logits after training; no launch on the CPU, the exchanges on
    gloo/cpu, one gradient all-reduce a step."""
    wants, got = ranks[2]
    want, res = wants["monet"], got["monet"]
    loss = [sum(v) for v in zip(*(r["losses"] for r in res))]
    np.testing.assert_allclose(loss, want["losses"], rtol=1e-5)
    np.testing.assert_allclose(
        np.concatenate([r["logits"] for r in res])[:len(want["logits"])],
        want["logits"], rtol=1e-4, atol=1e-5)
    for r in res:
        assert r["launches"] == {}
        assert r["exchanges"]["route"] == "gloo/cpu"
        # two layers, forward and backward, a step
        assert r["exchanges"]["exchanges"] == 4 * (STEPS + WARMUP)
        assert r["allreduces"]["allreduces"] == STEPS + WARMUP
