"""GAT model and trainer: the port against the flax model on converted
weights, and the port's import hygiene."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import ast
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgnn_tpu.models.gat as jax_gat_module
from dgnn_tpu.graph.structure import build_graph as jax_build_graph
from dgnn_tpu.models import GAT as JaxGAT
from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.models import GAT, load_flax_gat
from tests.conftest import random_graph

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _trainer():
    spec = importlib.util.spec_from_file_location(
        "train_gat_torch", ROOT / "scripts" / "train_gat_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _problem(rng, n=80, in_feats=16, n_classes=3, dense=None):
    src, dst = random_graph(rng, n, 4, power_law=dense is not None)
    feat = rng.normal(size=(n, in_feats)).astype(np.float32)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    train_mask = rng.random(n) < 0.5
    return (jax_build_graph(src, dst, n, dense=dense),
            build_graph(src, dst, n, dense=dense), feat, labels, train_mask)


def _models(jg, feat, attn_drop, n_classes=3):
    kw = dict(num_layers=1, n_hidden=8, n_classes=n_classes, heads=(4, 1),
              feat_drop=0.0, attn_drop=attn_drop)
    jm = JaxGAT(**kw)
    params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(feat))
    tm = GAT(feat.shape[1], 1, 8, n_classes, (4, 1), feat_drop=0.0,
             attn_drop=attn_drop, generator=torch.Generator().manual_seed(0))
    load_flax_gat(tm, params)
    return jm, params, tm


def test_converted_logits_equal_in_eval(rng):
    jg, tg, feat, _, _ = _problem(rng)
    jm, params, tm = _models(jg, feat, attn_drop=0.3)
    want = jax.jit(lambda p, g, x: jm.apply(p, g, x))(params, jg,
                                                      jnp.asarray(feat))
    tm.eval()
    with torch.no_grad():
        got = tm(tg, torch.from_numpy(feat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_converted_logits_equal_with_attention_dropout(rng, monkeypatch):
    """Training mode, attn_drop 0.3: the port gets the uint32 seeds that the
    flax model's dropout keys give (int(jax.random.bits(key, uint32)))."""
    jg, tg, feat, _, _ = _problem(rng)
    jm, params, tm = _models(jg, feat, attn_drop=0.3)
    seeds = []
    orig = jax_gat_module.gat_aggregate

    def recording(graph, ar, ac, x, **kw):
        seeds.append(int(jax.random.bits(kw["key"], dtype=jnp.uint32)))
        return orig(graph, ar, ac, x, **kw)

    monkeypatch.setattr(jax_gat_module, "gat_aggregate", recording)
    want = jm.apply(params, jg, jnp.asarray(feat), training=True,
                    rngs={"dropout": jax.random.PRNGKey(5)})
    assert len(seeds) == 2
    tm.train()
    with torch.no_grad():
        got = tm(tg, torch.from_numpy(feat), attn_seeds=seeds)
        no_drop = tm.eval()(tg, torch.from_numpy(feat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert not np.allclose(got.numpy(), no_drop.numpy())


@pytest.mark.parametrize("training", [False, True])
def test_converted_logits_equal_on_hub_graph(rng, monkeypatch, training):
    """A forced hub block at the model's default dense_dtype (bfloat16), in
    eval and with attention dropout 0.3.  Both sides round the same
    operands to bf16; the tolerance allows float32 summation order only."""
    jg, tg, feat, _, _ = _problem(rng, n=200, dense=(64, 150))
    assert tg.fwd.dense is not None and tg.bwd.dense is not None
    jm, params, tm = _models(jg, feat, attn_drop=0.3)
    seeds = []
    orig = jax_gat_module.gat_aggregate

    def recording(graph, ar, ac, x, **kw):
        assert "dense_dtype" not in kw  # the flax model takes the default
        if training:
            seeds.append(int(jax.random.bits(kw["key"], dtype=jnp.uint32)))
        return orig(graph, ar, ac, x, **kw)

    monkeypatch.setattr(jax_gat_module, "gat_aggregate", recording)
    want = jm.apply(params, jg, jnp.asarray(feat), training=training,
                    rngs={"dropout": jax.random.PRNGKey(5)})
    tm.train(training)
    with torch.no_grad():
        got = tm(tg, torch.from_numpy(feat),
                 attn_seeds=seeds if training else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("in_feats", [16, 32])
def test_converted_residual_and_activation_equal(rng, in_feats):
    """GAT(residual=True, activation=elu), two hidden layers of 4 heads x 8:
    at in_feats 16 the first layer's residual is a res_fc projection, at 32
    (= 4 x 8) the input itself; the second hidden layer's is always the
    input itself, and the output layer has neither.  Eval logits and the
    gradient of their sum with respect to the input features."""
    jg, tg, feat, _, _ = _problem(rng, in_feats=in_feats)
    jm = JaxGAT(num_layers=2, n_hidden=8, n_classes=3, heads=(4, 4, 1),
                residual=True, activation=jax.nn.elu)
    params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(feat))
    layers = params["params"]
    assert ("res_fc" in layers["gat_0"]) == (in_feats != 32)
    assert "res_fc" not in layers["gat_1"] and "res_fc" not in layers["gat_out"]
    tm = GAT(in_feats, 2, 8, 3, (4, 4, 1), residual=True,
             activation=torch.nn.functional.elu,
             generator=torch.Generator().manual_seed(0))
    assert (tm.convs["gat_0"].res_fc is not None) == (in_feats != 32)
    assert tm.convs["gat_out"].residual is False
    load_flax_gat(tm, params)
    want_logits = jm.apply(params, jg, jnp.asarray(feat))
    want_dx = jax.grad(lambda x: jnp.sum(jm.apply(params, jg, x)))(
        jnp.asarray(feat))
    x = torch.from_numpy(feat).requires_grad_(True)
    got = tm.eval()(tg, x)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_logits),
                               **LOGIT_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-5)


def test_init_std_follows_flax_fan_avg():
    tm = GAT(500, 1, 64, 3, (4, 1), generator=torch.Generator().manual_seed(0))
    conv = tm.convs["gat_0"]
    # variance_scaling(2, fan_avg): std = sqrt(2 / ((fan_in + fan_out) / 2))
    for t, fan_in, fan_out in ((conv.W.weight, 500, 256),
                               (conv.attn_l, 4, 64)):
        want = np.sqrt(2.0 / ((fan_in + fan_out) / 2))
        assert abs(float(t.detach().std()) / want - 1) < 0.1
    assert conv.bias is None and tm.convs["gat_out"].bias is not None


def test_trainers_agree_for_five_adam_steps(rng):
    """Adam + coupled weight decay on both sides, from the same weights."""
    jg, tg, feat, labels, train_mask = _problem(rng)
    jm, params, tm = _models(jg, feat, attn_drop=0.0)
    tx = optax.chain(optax.add_decayed_weights(5e-4), optax.adam(1e-2))
    opt_state = tx.init(params)
    mask_j = jnp.asarray(train_mask)

    @jax.jit
    def jax_step(params, opt_state, graph, x, y):
        def loss_fn(p):  # scripts/train_gat.py's loss
            logits = jm.apply(p, graph, x, training=True)
            losses = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                                     y)
            return jnp.sum(losses * mask_j) / jnp.sum(mask_j)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    trainer = _trainer()
    opt = trainer.make_optimizer(tm, 1e-2, 5e-4)
    x_t, y_t = torch.from_numpy(feat), torch.from_numpy(labels).long()
    m_t = torch.from_numpy(train_mask)
    for step in range(6):
        params, opt_state, loss_j = jax_step(params, opt_state, jg,
                                             jnp.asarray(feat),
                                             jnp.asarray(labels))
        loss_t = trainer.train_step(tm, opt, tg, x_t, y_t, m_t, None, None)
        rtol = 1e-4 if step == 0 else 1e-3
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=rtol,
                                   err_msg=f"step {step}")


def test_trainer_cli_refusals(capsys):
    """Cora (a hub block in both directions, the CLI's default dataset)
    trains on the CPU's plain versions, on a slim graph; no more steps than
    the warmup is refused.  (--impl naive runs: tests/test_torch_naive.py.)"""
    trainer = _trainer()
    args = trainer.parser().parse_args(["--device", "cpu", "--n-epochs", "5",
                                        "--attn-drop", "0.3"])
    r = trainer.run(args)
    assert r["graph"].fwd.dense is not None
    assert r["graph"].bwd.dense is not None
    assert r["graph"].row_ptr.numel() == 0  # the fused op needs no raw CSR
    assert len(r["losses"]) == 5 and np.isfinite(r["losses"]).all()
    assert "Test Accuracy" in capsys.readouterr().out
    args = trainer.parser().parse_args(["--device", "cpu", "--impl", "naive",
                                        "--n-epochs", "3"])
    with pytest.raises(ValueError, match="warmup"):
        trainer.run(args)


def test_csv_rows_match_jax_schema(tmp_path):
    from dgnn_tpu.utils.logging import append_csv_row as jax_append
    from dgnn_tpu_torch.utils import append_csv_row

    row = ("train_GAT_x_fused", "pubmed heads=4 hidden_dim=64", 0.0074218,
           0.00242, 383.7, 0.8688)
    files = {}
    for name, append in (("jax", jax_append), ("torch", append_csv_row)):
        files[name] = tmp_path / f"{name}.csv"
        for _ in range(2):  # the header comment is written once per file
            append(str(files[name]), *row)
    lines = {k: p.read_text().splitlines() for k, p in files.items()}
    data = {k: [ln for ln in v if not ln.startswith("#")]
            for k, v in lines.items()}
    assert len(data["torch"]) == 2
    assert data["torch"] == data["jax"]
    assert lines["torch"][0] == lines["jax"][0]  # the column header


_FORBIDDEN = {"jax", "flax", "optax", "dgnn_tpu"}


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((ROOT / "dgnn_tpu_torch").rglob("*.py"))
    files += [ROOT / "scripts" / "train_gat_torch.py",
              ROOT / "scripts" / "train_gmm_torch.py",
              ROOT / "scripts" / "build_reddit_raw_torch.py",
              ROOT / "scripts" / "profile_step_torch.py",
              ROOT / "scripts" / "bin_kernel_times_torch.py",
              ROOT / "scripts" / "dense_variants_torch.py",
              ROOT / "scripts" / "gather_variants_torch.py",
              ROOT / "scripts" / "microbench_gather_torch.py",
              ROOT / "scripts" / "record_results_torch.py",
              ROOT / "scripts" / "train_edgeconv_torch.py",
              ROOT / "scripts" / "exp_ec_tiles_torch.py",
              ROOT / "scripts" / "tie_sum_probe_torch.py",
              ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        bad = _FORBIDDEN & set(_imported_roots(path))
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
