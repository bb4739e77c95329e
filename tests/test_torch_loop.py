"""The device-resident epoch loop (utils/timing.py) and the dropout seed in
device memory: the port against the JAX package on the CPU.

- ``pair_keep`` and ``gat_aggregate`` with the seed as a tensor give the
  int seed's and the JAX package's results, bit for bit for the hash;
- ``run_epochs`` of the trainers' own steps gives what
  ``dgnn_tpu.utils.timing.run_epochs`` gives with the optax chain of
  scripts/train_gat.py (no dropout: the two packages' generators differ);
- the trainers train exactly ``--n-epochs`` steps from the initial state
  (the timing loop runs on a copy);
- on a card (``cuda``-marked, skipped here): replayed steps equal eager
  ones.

JAX is imported inside the JAX tests only, so that the CUDA test runs on a
machine without JAX:  python -m pytest --noconftest -m cuda
tests/test_torch_loop.py
"""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import copy
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from dgnn_tpu_torch.data import synthetic
from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.models import GAT, MoNet, load_flax_gat, load_flax_monet
from dgnn_tpu_torch.ops.common import pair_keep, seed_tensor
from dgnn_tpu_torch.ops.gat import gat_aggregate
from dgnn_tpu_torch.ops.gmm import NodePseudo
from dgnn_tpu_torch.ops.naive import gat_naive
from dgnn_tpu_torch.utils import (device_peak_memory_mb, fetch_scalar,
                                  make_optimizer, run_epochs, time_epoch_loop)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FWD_TOL = dict(rtol=1e-5, atol=1e-5)   # as tests/test_torch_gat_op.py
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # as tests/test_torch_gat_op.py
# Five Adam steps on each side: float32 sums in another order in each
# step's forward and backward, carried through the moments
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_graph(rng, n, avg_degree):
    """A random edge list without repeated edges."""
    e = np.unique(rng.integers(0, n, (n * avg_degree, 2)), axis=0)
    return e[:, 0], e[:, 1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _int32_bits(seed: int) -> torch.Tensor:
    return torch.tensor(seed - (1 << 32) if seed >> 31 else seed,
                        dtype=torch.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_pair_keep_tensor_seed_matches_int_and_jax(rng, seed):
    import jax.numpy as jnp

    from dgnn_tpu.ops.common import pair_keep as jax_pair_keep

    dst = rng.integers(0, 2 ** 31, 500)
    src = rng.integers(0, 2 ** 31, 500)
    want = np.asarray(jax_pair_keep(jnp.uint32(seed), jnp.asarray(dst),
                                    jnp.asarray(src), 3, 0.3))
    d, s = torch.from_numpy(dst), torch.from_numpy(src)
    for given in (seed, torch.tensor(seed, dtype=torch.int64),
                  _int32_bits(seed), torch.tensor([seed])):
        got = pair_keep(given, d, s, 3, 0.3)
        np.testing.assert_array_equal(got.numpy(), want)


def test_seed_tensor_holds_the_bits():
    like = torch.zeros(1)
    for seed in SEEDS:
        for given in (seed, torch.tensor(seed, dtype=torch.int64),
                      _int32_bits(seed)):
            t = seed_tensor(given, like)
            assert t.dtype == torch.int32 and t.shape == ()
            assert int(t) & 0xFFFFFFFF == seed
    # an int32 seed is read in place, an int64 one through its low word
    table = torch.tensor([5, 2 ** 32 - 2], dtype=torch.int64)
    assert seed_tensor(table[1], like).data_ptr() == table[1].data_ptr()
    bits = torch.tensor([7, -3], dtype=torch.int32)
    assert seed_tensor(bits[1], like).data_ptr() == bits[1].data_ptr()
    with pytest.raises(TypeError, match="one integer"):
        seed_tensor(torch.tensor(1.0), like)
    with pytest.raises(TypeError, match="one integer"):
        seed_tensor(torch.tensor([1, 2]), like)
    with pytest.raises(ValueError, match="lies on"):
        seed_tensor(torch.tensor(1, device="meta"), like)


@pytest.fixture(scope="module")
def cora_pair():
    from dgnn_tpu.graph.structure import build_graph as jax_build_graph

    d = synthetic.synthetic_citation("cora")
    tg = build_graph(d.src, d.dst, d.num_nodes, dense="auto")
    jg = jax_build_graph(d.src, d.dst, d.num_nodes, dense="auto")
    assert tg.fwd.dense is not None and tg.bwd.dense is not None
    return jg, tg, d.num_nodes


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_gat_aggregate_tensor_seed_matches_jax(cora_pair, dtype):
    """The plain path on cora (bins and hub block) at attn_drop 0.3, the
    seed a 0-d tensor: forward and gradients as the JAX op's with the same
    uint32 seed."""
    import jax
    import jax.numpy as jnp

    from dgnn_tpu.ops.gat import gat_aggregate as jax_gat

    jg, tg, n = cora_pair
    h, f = 2, 8
    rng = np.random.default_rng(11)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((n, h), (n, h), (n, h, f))]
    ct = rng.normal(size=(n, h, f)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    seed = int(jax.random.bits(key, dtype=jnp.uint32))

    @jax.jit
    def out_and_grads(g, ar, ac, feat, ct):
        out, vjp = jax.vjp(
            lambda *a: jax_gat(g, *a, attn_drop=0.3, key=key, training=True,
                               dense_dtype="float32"), ar, ac, feat)
        return out, vjp(ct)

    out_j, grads_j = out_and_grads(jg, *map(jnp.asarray, arrs),
                                   jnp.asarray(ct))
    given = (_int32_bits(seed) if dtype == torch.int32
             else torch.tensor(seed, dtype=dtype))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out_t = gat_aggregate(tg, *ts, attn_drop=0.3, seed=given, training=True,
                          dense_dtype="float32")
    out_t.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    for name, t, gj in zip(("ar", "ac", "feat"), ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj),
                                   err_msg=name, **GRAD_TOL)


def test_naive_and_model_take_tensor_seeds(rng):
    """gat_naive and GAT.forward give with seeds as tensors exactly what
    they give with the same seeds as ints."""
    n = 60
    src, dst = random_graph(rng, n, 4)
    g = build_graph(src, dst, n)
    ar, ac = (torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))
              for _ in range(2))
    feat = torch.from_numpy(rng.normal(size=(n, 2, 3)).astype(np.float32))
    kw = dict(attn_drop=0.3, training=True)
    torch.testing.assert_close(
        gat_naive(g, ar, ac, feat, seed=torch.tensor(2 ** 31 + 5), **kw),
        gat_naive(g, ar, ac, feat, seed=2 ** 31 + 5, **kw), rtol=0, atol=0)
    model = GAT(5, 1, 4, 3, (2, 1), attn_drop=0.3,
                generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(rng.normal(size=(n, 5)).astype(np.float32))
    seeds = [2 ** 32 - 1, 17]
    torch.testing.assert_close(
        model(g.slim(), x, attn_seeds=torch.tensor(seeds)),
        model(g.slim(), x, attn_seeds=seeds), rtol=0, atol=0)


def _jax_step(model, tx, apply_args):
    """scripts/train_gat.py's train_step (and train_gmm.py's): the masked
    cross entropy, Adam with coupled weight decay."""
    import jax
    import jax.numpy as jnp
    import optax

    def train_step(carry, dropout_key, cs):
        graph, features, labels, train_mask = cs
        params, opt_state, _ = carry

        def loss_fn(p):
            logits = model.apply(p, graph, features, *apply_args,
                                 training=True, rngs={"dropout": dropout_key})
            losses = optax.softmax_cross_entropy_with_integer_labels(
                logits, labels)
            return jnp.sum(losses * train_mask) / jnp.sum(train_mask)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return train_step


@pytest.mark.parametrize("kind", ["gat", "monet"])
def test_run_epochs_matches_jax_run_epochs(rng, kind):
    """5 Adam steps (lr 1e-2, weight decay 5e-4), no dropout, from the same
    weights: the trainers' own steps through the port's run_epochs against
    dgnn_tpu.utils.timing.run_epochs."""
    import jax
    import jax.numpy as jnp
    import optax

    from dgnn_tpu.graph.structure import build_graph as jax_build_graph
    from dgnn_tpu.models import GAT as JaxGAT
    from dgnn_tpu.models import MoNet as JaxMoNet
    from dgnn_tpu.ops.gmm import NodePseudo as JaxNodePseudo
    from dgnn_tpu.utils import timing as jax_timing

    n, epochs = 80, 5
    src, dst = random_graph(rng, n, 4)
    jg, tg = jax_build_graph(src, dst, n), build_graph(src, dst, n)
    feat = rng.normal(size=(n, 12)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    train_mask = rng.random(n) < 0.5
    x, y = torch.from_numpy(feat), torch.from_numpy(labels).long()
    m = torch.from_numpy(train_mask)
    if kind == "gat":
        jm = JaxGAT(num_layers=1, n_hidden=8, n_classes=3, heads=(4, 1))
        extra = ()
        params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(feat))
        tm = load_flax_gat(GAT(12, 1, 8, 3, (4, 1)), params)
        trainer = _load("train_gat_torch")
    else:
        rsq = (1.0 / np.sqrt(np.maximum(np.diff(tg.row_ptr.numpy()), 1))
               ).astype(np.float32)[:, None]
        jm = JaxMoNet(n_hidden=8, out_feats=3, n_layers=1, dim=2,
                      n_kernels=2, dropout=0.0)
        extra = (JaxNodePseudo(src=jnp.asarray(rsq), dst=jnp.asarray(rsq)),)
        params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(feat),
                         *extra)
        tm = load_flax_monet(MoNet(12, 8, 3, 1, 2, 2, dropout=0.0), params)
        trainer = _load("train_gmm_torch")
    tx = optax.chain(optax.add_decayed_weights(5e-4), optax.adam(1e-2))
    consts = (jg, jnp.asarray(feat), jnp.asarray(labels),
              jnp.asarray(train_mask))
    carry = jax_timing.run_epochs(_jax_step(jm, tx, extra),
                                  (params, tx.init(params), jnp.float32(0)),
                                  jax.random.PRNGKey(0), epochs,
                                  consts=consts)
    want = (load_flax_gat if kind == "gat" else load_flax_monet)(
        copy.deepcopy(tm), carry[0])

    opt = make_optimizer(tm, 1e-2, 5e-4)
    count = torch.zeros(1, dtype=torch.int64)
    losses = torch.zeros(epochs)
    g = tg.slim()
    if kind == "gat":
        step = trainer.make_step(tm, opt, g, x, y, m,
                                 trainer.generators(0, "cpu"), count, losses)
    else:
        pseudo = NodePseudo(src=torch.from_numpy(rsq),
                            dst=torch.from_numpy(rsq))
        step = trainer.make_step(tm, opt, g, x, pseudo, y, m,
                                 torch.Generator().manual_seed(0), count,
                                 losses)
    run_epochs(step, epochs, device="cpu")
    assert int(count) == epochs
    np.testing.assert_allclose(float(losses[-1]), float(carry[2]),
                               rtol=1e-3)
    for (name, got), (_, exp) in zip(tm.state_dict().items(),
                                     want.state_dict().items()):
        torch.testing.assert_close(got, exp, **PARAM_TOL,
                                   msg=lambda s, name=name: f"{name}: {s}")


def test_time_epoch_loop_times_a_copy(rng):
    """The trainers' protocol: timing runs on a throwaway copy of the model
    and optimizer state, which the caller's never see; the time is
    positive, and the copy took the warmup and the timed epochs."""
    n = 60
    src, dst = random_graph(rng, n, 4)
    g = build_graph(src, dst, n).slim()
    x = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, n)).long()
    m = torch.ones(n, dtype=torch.bool)
    trainer = _load("train_gat_torch")
    model = GAT(6, 1, 4, 3, (2, 1), feat_drop=0.5, attn_drop=0.3,
                generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model, 1e-2, 5e-4)
    before = copy.deepcopy(model.state_dict())
    copy_ = copy.deepcopy(model)
    count = torch.zeros(1, dtype=torch.int64)
    step = trainer.make_step(copy_, make_optimizer(copy_, 1e-2, 5e-4), g, x,
                             y, m, trainer.generators(0, "cpu"), count)
    s = time_epoch_loop(step, 3, device="cpu", warmup=2, min_signal=0.0)
    assert s > 0
    assert int(count) == 2 + 3
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert not opt.state  # the caller's optimizer took no step
    assert not torch.equal(copy_.state_dict()["convs.gat_0.W.weight"],
                           before["convs.gat_0.W.weight"])


def test_time_epoch_loop_doubles_until_the_signal():
    calls = []
    s = time_epoch_loop(lambda: calls.append(1), 2, device="cpu", warmup=1,
                        min_signal=1e9, max_epochs=16)
    # 1 warmup, then 2, 4, 8, 16 epochs: the last at max_epochs
    assert len(calls) == 1 + 2 + 4 + 8 + 16 and s > 0


@pytest.mark.parametrize("kind", ["gat", "gmm"])
def test_trainer_trains_exactly_n_epochs(kind):
    """``run`` on the CPU (cora, dropout on, node pseudo for MoNet): its
    model equals a plain loop of --n-epochs steps from the same initial
    model with the same generators, and its losses are that loop's."""
    trainer = _load(f"train_{kind}_torch")
    argv = ["--device", "cpu", "--n-epochs", "5", "--n-hidden", "8"]
    argv += (["--n-heads", "2", "--attn-drop", "0.3"] if kind == "gat"
             else ["--pseudo", "node"])
    args = trainer.parser().parse_args(argv)
    r = trainer.run(args)
    n_classes = int(r["labels"].max()) + 1
    in_feats = r["feats"].shape[1]
    init = torch.Generator().manual_seed(args.seed)
    if kind == "gat":
        model = GAT(in_feats, 1, 8, n_classes, (2, 1), feat_drop=0.5,
                    attn_drop=0.3, generator=init)
    else:
        model = MoNet(in_feats, 8, n_classes, 1, 2, 3, dropout=0.5,
                      pseudo="node", generator=init)
    opt = make_optimizer(model, args.lr, args.weight_decay)
    drop_gen = torch.Generator().manual_seed(args.seed)
    seed_gen = torch.Generator().manual_seed(args.seed + 1)
    g, x, y, m = r["graph"], r["feats"], r["labels"], r["train_mask"]
    losses = []
    for _ in range(args.n_epochs):
        if kind == "gat":
            seeds = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                                  generator=seed_gen)
            loss = trainer.train_step(model, opt, g, x, y, m, drop_gen, seeds)
        else:
            loss = trainer.train_step(model, opt, g, x, r["pseudo"], y, m,
                                      drop_gen)
        losses.append(float(loss))
    # the same operations in the same order on the same host
    np.testing.assert_array_equal(np.asarray(r["losses"], np.float32),
                                  np.asarray(losses, np.float32))
    for (name, got), (_, want) in zip(r["model"].state_dict().items(),
                                      model.state_dict().items()):
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   msg=lambda s, name=name: f"{name}: {s}")
    # the timing loops' steps and forwards, then the n epochs and the last
    # forward, all counted where they ran
    assert r["train_steps"] > args.n_epochs + trainer.WARMUP_STEPS
    assert r["infer_calls"] > args.n_epochs + trainer.WARMUP_STEPS


def test_timing_helpers_on_the_cpu():
    t = torch.arange(6.0).reshape(2, 3) + 4
    assert fetch_scalar(t) == 4.0
    assert fetch_scalar({"a": [t * 2]}) == 8.0
    assert device_peak_memory_mb("cpu") == -1.0
    with pytest.raises(ValueError, match="no device loop"):
        from dgnn_tpu_torch.utils import StepGraph
        StepGraph(lambda: None, "cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replayed_steps_equal_eager_steps(rng, cuda_device):
    """10 replays of the GAT trainer's step (attn_drop 0.3, feature dropout
    0.5) equal 10 eager steps from the same state and generator states,
    and the kernels' launches count every replay."""
    from dgnn_tpu_torch.ops import bins

    trainer = _load("train_gat_torch")
    n = 400
    src, dst = random_graph(rng, n, 6)
    g = build_graph(src, dst, n).slim().to(cuda_device)
    x = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, n)).long()
    x, y = x.to(cuda_device), y.to(cuda_device)
    m = torch.ones(n, dtype=torch.bool, device=cuda_device)
    base = GAT(16, 1, 8, 3, (4, 1), feat_drop=0.5, attn_drop=0.3,
               generator=torch.Generator().manual_seed(0)).to(cuda_device)
    sides = []
    for replayed in (False, True):
        model = copy.deepcopy(base)
        count = torch.zeros(1, dtype=torch.int64, device=cuda_device)
        losses = torch.zeros(10, device=cuda_device)
        gens = trainer.generators(3, cuda_device)
        step = trainer.make_step(model, make_optimizer(model, 1e-2, 5e-4), g,
                                 x, y, m, gens, count, losses)
        bins.reset_launches()
        if replayed:
            run_epochs(step, 10, device=cuda_device, generators=gens)
        else:
            for _ in range(10):
                step()
        torch.cuda.synchronize()
        sides.append((model, losses, dict(bins.LAUNCHES)))
    (m_e, l_e, n_e), (m_r, l_r, n_r) = sides
    assert n_r == n_e and n_e["bin_gat_fwd"] > 0
    torch.testing.assert_close(l_r, l_e, rtol=1e-5, atol=1e-6)
    for (name, a), (_, b) in zip(m_e.state_dict().items(),
                                 m_r.state_dict().items()):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6,
                                   msg=lambda s, name=name: f"{name}: {s}")
