"""The DGCNN trainer's device-resident epoch (scripts/train_edgeconv_torch.py
``make_epoch``), its optimizer with the cosine on the device
(utils/training.py ``SGDCosine``) and the tie-sum backward's kernel wrapper
(ops/edgeconv.py ``tie_sum_bwd``): the port on the CPU, against the JAX
trainer's step and optax, and, on a CUDA device, the kernel against its
plain version and a replayed epoch against eager ones.

- a few training steps of the port's trainer equal the JAX trainer's
  ``train_step`` with its optax chain, from the same weights on the same
  batches (dropout 0: the two packages' generators differ);
- one ``make_epoch`` call equals its steps taken one by one on the same
  permuted and augmented batches, bit for bit (the same operations on the
  same host);
- the trainer trains exactly ``--num-epochs`` epochs from its initial
  state, and its timing leaves the model untouched;
- ``tie_sum_bwd`` takes its plain version on the CPU and refuses what it
  does not take;
- ``cuda``-marked (skipped here): ``tie_sum_bwd`` against ``_dsrc_ties``
  on k-NN and adversarial masks in both mask and both mul dtypes, bit-equal
  between two calls, launches counted; replayed epochs against eager ones.

JAX is imported inside the JAX test only, so that the CUDA tests run on a
machine without JAX:  python -m pytest --noconftest -m cuda
tests/test_torch_dgcnn_loop.py
"""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import copy
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from dgnn_tpu_torch.graph.knn import knn_mask_neg
from dgnn_tpu_torch.models import DGCNN, flax_dgcnn_state_dict, load_flax_dgcnn
from dgnn_tpu_torch.ops import ec_tiles, edgeconv
from dgnn_tpu_torch.ops.edgeconv import _dsrc_ties, tie_sum_bwd
from dgnn_tpu_torch.utils import SGDCosine, make_sgd_cosine, run_epochs
from dgnn_tpu_torch.utils.training import augment

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(k=4, feature_dims=(8, 8), emb_dims=(16, 16, 8),
             output_classes=5)
# Three SGD steps on each side: float32 products and sums in another order
# in every forward and backward, carried through the momentum; and the
# EdgeConv backward rounds g and its sums to bfloat16 (mul_dtype), where an
# ulp's difference in a float32 sum can flip a rounding and move a gradient
# element by 2^-8 of itself, which lr 0.1 carries into the weights (the
# one-step test of tests/test_torch_edgeconv.py holds 2e-4 / 2e-5)
STEPS_TOL = dict(rtol=1e-3, atol=1e-4)
F32_TOL = dict(rtol=1e-5, atol=1e-6)    # as tests/test_torch_edgeconv.py
BF16_TOL = dict(rtol=5e-3, atol=2e-2)   # mul_dtype bfloat16, as the JAX test
# the loop: a replay runs the eager epoch's kernels on the same inputs
LOOP_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _clouds(rng, n, p, classes=5):
    return (torch.from_numpy(_f32(rng, n, p, 3)),
            torch.from_numpy(rng.integers(0, classes, n)).long())


def _small_model(seed=0, dropout=0.5):
    return DGCNN(dropout=dropout, generator=torch.Generator().manual_seed(seed),
                 **SMALL)


def _plain_epoch(trainer, model, opt, x, y, bs, gen):
    """An epoch written out: the permutation (argsort of uniform draws),
    the scale and shift, then the steps one by one; returns the steps'
    losses and accuracies."""
    order = torch.argsort(torch.rand(x.shape[0], generator=gen))
    xs, ys = augment(x[order], gen), y[order]
    out = []
    for i in range(x.shape[0] // bs):
        loss, acc = trainer.train_step(model, opt, xs[i * bs:(i + 1) * bs],
                                       ys[i * bs:(i + 1) * bs], gen)
        out.append((float(loss), float(acc)))
    return out


def _assert_same_state(got, want, **tol):
    tol = tol or dict(rtol=0, atol=0)
    assert list(got.state_dict()) == list(want.state_dict())
    for (name, a), (_, b) in zip(got.state_dict().items(),
                                 want.state_dict().items()):
        torch.testing.assert_close(a, b, **tol,
                                   msg=lambda s, name=name: f"{name}: {s}")


# ---------------------------------------------------------------------------
# the optimizer and the step against the JAX trainer
# ---------------------------------------------------------------------------


def test_sgd_cosine_state_is_made_up_front():
    """Momentum buffers (zero) and the step count (an int64 0) exist before
    any step, on the parameters' device; a step with no gradient anywhere
    moves nothing but the count."""
    model = torch.nn.Linear(4, 3)
    opt = make_sgd_cosine(model, 10)
    assert isinstance(opt, SGDCosine)
    for p in model.parameters():
        buf = opt.state[p]["momentum_buffer"]
        assert buf.shape == p.shape and float(buf.abs().max()) == 0.0
    assert opt.count.dtype == torch.int64 and int(opt.count) == 0
    before = copy.deepcopy(model.state_dict())
    opt.step()
    assert int(opt.count) == 1
    for name, v in model.state_dict().items():
        assert torch.equal(v, before[name]), name
    with pytest.raises(ValueError):
        make_sgd_cosine(model, 0)


def test_train_steps_match_jax_trainer(rng):
    """Three training steps of the port's trainer (its ``train_step`` and
    optimizer) against scripts/train_edgeconv.py's ``train_step`` with its
    optax chain, cosine over the three steps, from the same weights on the
    same batches, dropout 0: every loss, parameter and batch statistic."""
    import jax
    import jax.numpy as jnp
    import optax
    from dgnn_tpu.models import DGCNN as FDGCNN

    jtrainer = _load("train_edgeconv")
    trainer = _load("train_edgeconv_torch")
    steps, bs, p = 3, 2, 32
    x = _f32(rng, steps * bs, p, 3)
    y = rng.integers(0, SMALL["output_classes"], steps * bs).astype(np.int32)
    fmodel = FDGCNN(dropout=0.0, **SMALL)
    variables = jax.tree_util.tree_map(
        np.asarray, fmodel.init(jax.random.PRNGKey(0), jnp.asarray(x[:bs])))
    params, stats = variables["params"], variables["batch_stats"]
    tx = optax.chain(optax.add_decayed_weights(1e-4),
                     optax.sgd(optax.cosine_decay_schedule(0.1, steps,
                                                           alpha=0.01),
                               momentum=0.9))
    opt_state = tx.init(params)
    model = load_flax_dgcnn(DGCNN(dropout=0.0, **SMALL), variables)
    opt = make_sgd_cosine(model, steps)
    for i in range(steps):
        xb, yb = x[i * bs:(i + 1) * bs], y[i * bs:(i + 1) * bs]

        def loss_fn(prm):
            logits, upd = fmodel.apply(
                {"params": prm, "batch_stats": stats}, jnp.asarray(xb),
                training=True, mutable=["batch_stats"])
            return jtrainer.compute_loss(logits, jnp.asarray(yb)), \
                upd["batch_stats"]

        (jloss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        loss, _ = trainer.train_step(model, opt, torch.from_numpy(xb),
                                     torch.from_numpy(yb).long(), None)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   err_msg=f"loss of step {i}")
    want = flax_dgcnn_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                 jax.tree_util.tree_map(np.asarray, stats))
    got = model.state_dict()
    assert set(got) == set(want)
    for key, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[key].numpy(),
                                   err_msg=f"{key} after {steps} steps",
                                   **STEPS_TOL)


# ---------------------------------------------------------------------------
# the epoch and the trainer's protocol on the CPU
# ---------------------------------------------------------------------------


def test_make_epoch_equals_its_steps(rng):
    """One ``make_epoch`` call (dropout 0.5) equals its steps taken one by
    one on the same permuted and augmented batches from the same generator
    state: the losses written to the buffer at the count, the epoch's mean
    loss and accuracy, every parameter, batch statistic and momentum
    buffer, and the step count; exactly (the same operations in the same
    order on the same host)."""
    trainer = _load("train_edgeconv_torch")
    x, y = _clouds(rng, 12, 16)
    bs, spe = 4, 3
    sides = []
    for epoch_fn in (True, False):
        model = _small_model()
        opt = make_sgd_cosine(model, 2 * spe)
        gen = torch.Generator().manual_seed(3)
        if epoch_fn:
            count = torch.tensor([spe])   # a second epoch's buffer slots
            losses = torch.full((2 * spe,), -1.0)
            stats = torch.zeros(2)
            trainer.make_epoch(model, opt, x, y, bs, gen, count, stats,
                               losses)()
            assert int(count) == 2 * spe
            assert bool((losses[:spe] == -1.0).all())
            got = (losses[spe:].tolist(), stats.tolist())
        else:
            steps = _plain_epoch(trainer, model, opt, x, y, bs, gen)
            got = ([s[0] for s in steps],
                   np.mean(np.float32(steps), axis=0).tolist())
        sides.append((model, opt, got))
    (m_e, o_e, (l_e, s_e)), (m_p, o_p, (l_p, s_p)) = sides
    np.testing.assert_array_equal(np.float32(l_e), np.float32(l_p))
    np.testing.assert_allclose(s_e, s_p, rtol=1e-6)
    _assert_same_state(m_e, m_p)
    for a, b in zip(m_e.parameters(), m_p.parameters()):
        assert torch.equal(o_e.state[a]["momentum_buffer"],
                           o_p.state[b]["momentum_buffer"])
    assert int(o_e.count) == int(o_p.count) == spe


def test_trainer_trains_exactly_n_epochs(monkeypatch):
    """``run`` on the CPU (dropout on): its model equals a plain loop of
    --num-epochs epochs from the same initial model with a generator seeded
    as the trainer seeds its own, and its losses are that loop's; the
    timing ran on a copy (its steps counted beside the n epochs')."""
    trainer = _load("train_edgeconv_torch")
    # a short timing signal: the timing loop only runs longer at 2 s
    monkeypatch.setattr(trainer, "MIN_SIGNAL_S", 0.05)
    args = trainer.parser().parse_args(
        ["--device", "cpu", "--num-epochs", "2", "--batch-size", "4",
         "--k", "4", "--num-points", "16", "--train-samples", "12",
         "--test-samples", "8"])
    r = trainer.run(args)
    model = DGCNN(k=args.k, output_classes=r["n_classes"], dropout=0.5,
                  generator=torch.Generator().manual_seed(args.seed))
    spe = r["steps_per_epoch"]
    opt = make_sgd_cosine(model, args.num_epochs * spe)
    gen = torch.Generator().manual_seed(args.seed)
    losses = []
    for _ in range(args.num_epochs):
        losses += [s[0] for s in _plain_epoch(trainer, model, opt,
                                              r["x_train"], r["y_train"], 4,
                                              gen)]
    np.testing.assert_array_equal(np.float32(r["losses"]),
                                  np.float32(losses))
    _assert_same_state(r["model"], model)
    assert r["train_steps"] > args.num_epochs * spe
    assert (r["train_steps"] - args.num_epochs * spe) % spe == 0
    assert np.float32(r["last_lr"]) == np.float32(float(opt.lr()))


# ---------------------------------------------------------------------------
# the tie-sum backward's wrapper on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mul_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tie_sum_bwd_takes_the_plain_version_on_the_cpu(rng, mul_dtype):
    b, p, f = 2, 16, 6
    mask = knn_mask_neg(torch.from_numpy(_f32(rng, b, p, 3)), 4)
    hs, g = (torch.from_numpy(_f32(rng, b, p, f)) for _ in range(2))
    m = ec_tiles.masked_max(mask, hs)
    edgeconv.reset_launches()
    got = tie_sum_bwd(m, mask, hs, g, mul_dtype)
    assert torch.equal(got, _dsrc_ties(m, mask, hs, g, mul_dtype))
    assert edgeconv.LAUNCHES == {"tie_sum_bwd": 0, "tie_sum_lists": 0}


def test_tie_sum_bwd_refuses_bad_arguments(rng):
    b, p, f = 1, 8, 4
    mask = knn_mask_neg(torch.from_numpy(_f32(rng, b, p, 3)), 3)
    hs, g = (torch.from_numpy(_f32(rng, b, p, f)) for _ in range(2))
    m = ec_tiles.masked_max(mask, hs)
    with pytest.raises(ValueError):
        tie_sum_bwd(m[:, :, :3], mask, hs, g)
    with pytest.raises(ValueError):
        tie_sum_bwd(m, mask[:, :, :7], hs, g)
    with pytest.raises(TypeError):
        tie_sum_bwd(m, mask.to(torch.float16), hs, g)
    with pytest.raises(TypeError):
        tie_sum_bwd(m.double(), mask, hs, g)
    with pytest.raises(ValueError):
        tie_sum_bwd(m, mask, hs, g, torch.float16)


# ---------------------------------------------------------------------------
# on a CUDA device
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def _tie_case(rng, kind, b, p, f):
    """(mask, h_src): the k-NN mask, or the masks that make the kernel's
    filter keep pairs a {0, neg} rule would drop; duplicated source rows
    make exact ties in every case."""
    hs = _f32(rng, b, p, f)
    if kind == "knn":
        mask = knn_mask_neg(torch.from_numpy(_f32(rng, b, p, 3)), 8)
    elif kind == "three-valued":
        pick = rng.random((b, p, p))
        mask = torch.from_numpy(np.where(
            pick < 0.3, 0.0, np.where(pick < 0.6, -0.5, -3.0))
            .astype(np.float32))
    elif kind == "near-neg":
        cols = np.argsort(rng.random((b, p, p)), axis=-1)[..., :3]
        m = np.full((b, p, p), -8.0, np.float32)
        np.put_along_axis(m, cols, 0.0, axis=-1)
        mask, hs = torch.from_numpy(m), hs * 4.0
    elif kind == "admits-nothing":
        mask = knn_mask_neg(torch.from_numpy(_f32(rng, b, p, 3)), 5)
        mask[0, 4] = -1e30
        mask[-1, 2] = -1e30
    elif kind == "float":
        mask = torch.from_numpy(_f32(rng, b, p, p) * 2)
    elif kind == "overflow":   # a row admitting more than the list's cap
        mask = knn_mask_neg(torch.from_numpy(_f32(rng, b, p, 3)), 5)
        mask[0, 1] = -1e30
        mask[0, 1, :ec_tiles.LIVE_CAP + 1] = 0
    elif kind == "full-column":  # columns every row admits, h_src raised
        # there: every row's filter passes them, over the tie-sum lists'
        # cap, so the sum walks them densely
        mask = knn_mask_neg(torch.from_numpy(_f32(rng, b, p, 3)), 5)
        mask[0, :, 2] = 0
        mask[-1, :, p - 2] = 0
        hs[0, 2] += 4.0
        hs[-1, p - 2] += 4.0
    else:
        raise ValueError(kind)
    hs[0, 5] = hs[0, 1]
    hs[-1, p - 1] = hs[-1, 3]
    return mask, torch.from_numpy(hs)


@pytest.mark.cuda
@pytest.mark.parametrize("mul_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mask_dtype", [torch.bfloat16, torch.float32],
                         ids=["mask-bf16", "mask-f32"])
@pytest.mark.parametrize("kind", ["knn", "three-valued", "near-neg",
                                  "admits-nothing", "float", "overflow",
                                  "full-column"])
@pytest.mark.parametrize("shape", [(2, 300, 70), (2, 64, 256), (1, 40, 300)],
                         ids=["ragged", "f256", "two-slabs"])
def test_cuda_tie_sum_bwd_matches_plain(rng, cuda_device, shape, kind,
                                        mask_dtype, mul_dtype):
    """The kernels against ``_dsrc_ties`` on CPU copies (the same m, from
    the card's masked max): equal bit for bit, as are two calls; one list
    pass and one sum a call."""
    b, p, f = shape
    if kind == "overflow" and p <= ec_tiles.LIVE_CAP:
        p = ec_tiles.LIVE_CAP + 44
    if kind == "full-column" and p <= edgeconv.TIE_CAP:
        p = edgeconv.TIE_CAP + 44
    mask, hs = _tie_case(rng, kind, b, p, f)
    mask = mask.to(mask_dtype).to(cuda_device)
    hs = hs.to(cuda_device)
    g = torch.from_numpy(_f32(rng, b, p, f)).to(cuda_device)
    m = ec_tiles.masked_max(mask, hs)
    edgeconv.reset_launches()
    got = tie_sum_bwd(m, mask, hs, g, mul_dtype)
    again = tie_sum_bwd(m, mask, hs, g, mul_dtype)
    torch.cuda.synchronize()
    assert edgeconv.LAUNCHES == {"tie_sum_bwd": 2, "tie_sum_lists": 2}
    assert torch.equal(got, again)
    want = _dsrc_ties(m.cpu(), mask.cpu(), hs.cpu(), g.cpu(), mul_dtype)
    tol = F32_TOL if mul_dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.cpu(), want, **tol)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_tie_sum_bwd_refuses_what_the_kernel_does_not_take(
        rng, cuda_device):
    mask = knn_mask_neg(torch.from_numpy(_f32(rng, 1, 16, 3)), 4).to(
        cuda_device)
    hs = torch.from_numpy(_f32(rng, 1, 16, 8)).to(cuda_device)
    m = ec_tiles.masked_max(mask, hs)
    with pytest.raises(ValueError):
        tie_sum_bwd(m, mask.transpose(1, 2), hs, hs)
    with pytest.raises(ValueError):
        tie_sum_bwd(m, mask.cpu(), hs, hs)


@pytest.mark.cuda
def test_cuda_replayed_epochs_equal_eager_epochs(rng, cuda_device):
    """Two ``run_epochs`` replays of the trainer's epoch (dropout 0.5)
    equal two eager epochs from the same state and generator state: the
    losses, every parameter and batch statistic (LOOP_TOL), and the
    kernels' launches count every replay."""
    trainer = _load("train_edgeconv_torch")
    x, y = (t.to(cuda_device) for t in _clouds(rng, 8, 64))
    base = _small_model().to(cuda_device)
    spe, sides = 2, []
    # the kernels and cuBLAS's handles once, on a throwaway copy
    warm = copy.deepcopy(base)
    trainer.make_epoch(warm, make_sgd_cosine(warm, 4), x, y, 4,
                       torch.Generator(device=cuda_device).manual_seed(1),
                       torch.zeros(1, dtype=torch.int64, device=cuda_device),
                       torch.zeros(2, device=cuda_device))()
    for replayed in (False, True):
        model = copy.deepcopy(base)
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        count = torch.zeros(1, dtype=torch.int64, device=cuda_device)
        losses = torch.zeros(2 * spe, device=cuda_device)
        epoch = trainer.make_epoch(model, make_sgd_cosine(model, 2 * spe),
                                   x, y, 4, gen, count,
                                   torch.zeros(2, device=cuda_device),
                                   losses)
        ec_tiles.reset_launches()
        edgeconv.reset_launches()
        if replayed:
            run_epochs(epoch, 2, device=cuda_device, generators=(gen,))
        else:
            for _ in range(2):
                epoch()
        torch.cuda.synchronize()
        sides.append((model, losses, dict(ec_tiles.LAUNCHES),
                      dict(edgeconv.LAUNCHES)))
    (m_e, l_e, t_e, e_e), (m_r, l_r, t_r, e_r) = sides
    layers = len(SMALL["feature_dims"])
    calls = layers * spe * 2
    assert t_r == t_e and e_r == e_e == {"tie_sum_bwd": calls,
                                         "tie_sum_lists": calls}
    torch.testing.assert_close(l_r, l_e, **LOOP_TOL)
    _assert_same_state(m_r, m_e, **LOOP_TOL)
