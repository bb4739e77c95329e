"""scripts/memory_report_torch.py on the CPU: its fused and naive training
steps against the same step written with flax and optax
(scripts/memory_report.py:26-45), the saved-bytes count on the reddit
graph at cut scales, the fit, the refusal to measure off the card, and
the Markdown's labels; on a card (``cuda``-marked, skipped here): a fused
step's measured peak is at least its counted saved bytes."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import copy
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from dgnn_tpu_torch.data import reddit
from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.models import load_flax_gat

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCALES = (2e-4, 4e-4)  # 46 and 93 nodes; hub blocks in both directions
# as tests/test_torch_loop.py holds the trainers' steps to the JAX ones
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


mr = _load("memory_report_torch")


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    cache = tmp_path_factory.mktemp("reddit")
    return {s: reddit.load_reddit(s, cache_dir=cache, log=lambda m: None).graph
            for s in SCALES}


def _step_parts(impl, graph):
    """The report's model (no feature dropout), inputs and step on the CPU,
    on the graph its step takes."""
    g = graph.slim() if impl == "fused" else graph
    feat, labels = mr.make_inputs(graph.num_nodes, "cpu")
    model = mr.build_model(impl, feat_drop=0.0)
    return g, feat, labels, model


def _random_graph(n=80, avg_degree=4):
    """A random edge list without repeated edges (so that the hub block,
    where the planner keeps one, and the naive step's CSR count the same
    edges), and both packages' graphs of it."""
    from dgnn_tpu.graph.structure import build_graph as jax_build_graph

    e = np.unique(np.random.default_rng(0).integers(0, n, (n * avg_degree,
                                                           2)), axis=0)
    return (jax_build_graph(e[:, 0], e[:, 1], n, dense="auto"),
            build_graph(e[:, 0], e[:, 1], n, dense="auto"))


@pytest.mark.parametrize("impl", ["fused", "naive"])
def test_step_matches_the_jax_scripts_step(impl):
    """One step from the same weights: the loss, the gradients and every
    parameter after Adam's update.  Adam's first step moves a parameter by
    lr * sign(g + wd * p), so an element whose decayed gradient lies within
    the gradients' tolerance of zero may move either way in either package:
    such an element must move by at most lr, every other one must match."""
    import jax
    import jax.numpy as jnp
    import optax

    from dgnn_tpu.models import GAT as JaxGAT

    jg, graph = _random_graph()
    if impl == "fused":
        jg = jg.slim()
    g, feat, labels, model = _step_parts(impl, graph)
    jm = JaxGAT(num_layers=1, n_hidden=mr.HIDDEN, n_classes=mr.N_CLASSES,
                heads=mr.HEADS, feat_drop=0.0, attn_drop=0.0, impl=impl)
    jfeat, jlabels = jnp.asarray(feat.numpy()), jnp.asarray(labels.numpy())
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jg, jfeat)
    tx = optax.chain(optax.add_decayed_weights(mr.WEIGHT_DECAY),
                     optax.adam(mr.LR))

    @jax.jit
    def train_step(params, opt_state, key, graph, feat, labels):
        def loss_fn(p):
            logits = jm.apply(p, graph, feat, training=True,
                              rngs={"dropout": key})
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), grads, loss

    jparams, jgrads, jloss = train_step(
        params, tx.init(params), jax.random.PRNGKey(1), jg, jfeat, jlabels)
    load_flax_gat(model, params)
    before = copy.deepcopy(model)
    want = load_flax_gat(copy.deepcopy(model), jparams)
    want_grads = dict(load_flax_gat(copy.deepcopy(model), jgrads)
                      .named_parameters())
    step = mr.make_step(model, g, feat, labels)
    loss = step()
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    torch.nn.functional.cross_entropy(before(g, feat), labels).backward()
    undetermined = 0
    for name, p0 in before.named_parameters():
        g0 = want_grads[name].detach()
        torch.testing.assert_close(p0.grad, g0, **GRAD_TOL,
                                   msg=lambda s, name=name: f"{name}: {s}")
        decayed = g0 + mr.WEIGHT_DECAY * p0.detach()
        tied = decayed.abs() <= GRAD_TOL["atol"] + GRAD_TOL["rtol"] * g0.abs()
        got = dict(model.named_parameters())[name].detach()
        exp = dict(want.named_parameters())[name].detach()
        torch.testing.assert_close(got[~tied], exp[~tied], **PARAM_TOL,
                                   msg=lambda s, name=name: f"{name}: {s}")
        moved = (got[tied] - p0.detach()[tied]).abs()
        assert (moved <= mr.LR * (1 + 1e-3)).all(), name
        undetermined += int(tied.sum())
    total = sum(p.numel() for p in model.parameters())
    assert undetermined <= total // 1000, (undetermined, total)
    assert all(p.grad is None for p in model.parameters())


def _saved(impl, graph):
    g, feat, labels, model = _step_parts(impl, graph)
    step = mr.make_step(model, g, feat, labels)
    return mr.saved_bytes(step, graph.num_nodes, graph.num_edges)


def test_saved_bytes_naive_against_fused(graphs):
    """The naive step saves the [E, 4, 64] float32 messages' operand, the
    fused step no tensor of E * H * F elements, and less in all."""
    graph = graphs[SCALES[0]]
    e = graph.num_edges
    naive, fused = _saved("naive", graph), _saved("fused", graph)
    assert naive["E"] >= e * 4 * 64 * 4
    assert fused["E"] == 0
    for h, f in ((4, 64), (1, mr.N_CLASSES)):
        assert not any(int(np.prod(shape)) == e * h * f
                       for shape, _, _ in fused["tensors"])
        assert any(int(np.prod(shape)) == e * h * f
                   for shape, _, _ in naive["tensors"])
    assert fused["total"] < naive["total"]
    for s in (naive, fused):
        assert s["total"] == s["E"] + s["N"] + s["other"]
        assert np.isfinite(s["loss"])
        # the parameters, and nothing of the edges, sit in "other"
        assert s["other"] < 64 * 1024


def test_saved_edge_bytes_grow_with_the_edges(graphs):
    small, large = (graphs[s] for s in SCALES)
    a, b = _saved("naive", small), _saved("naive", large)
    assert large.num_edges > 2 * small.num_edges - 1000
    assert a["E"] * large.num_edges == b["E"] * small.num_edges
    # carried to the larger graph dimension by dimension: its own count
    # up to the N part's rounding
    np.testing.assert_allclose(
        mr.extrapolate(a, small.num_nodes, small.num_edges, large.num_nodes,
                       large.num_edges), b["total"], rtol=1e-3)


def test_expected_launches(graphs):
    g = graphs[SCALES[0]].slim()
    naive = mr.expected_launches(g, "naive", None, 3, 2)
    assert set(naive) == set(mr.all_launches()) and not any(naive.values())
    for dtype, suffix in ((None, ""), ("bfloat16", "_bf16")):
        want = mr.expected_launches(g, "fused", dtype, 3, 2)
        used = {k: v for k, v in want.items() if v}
        per = -(-g.fwd.num_bins // 8), -(-g.bwd.num_bins // 8)
        assert used == {f"bin_gat_fwd{suffix}": 6 * per[0],
                        f"bin_gat_bwd{suffix}": 6 * per[1],
                        "dense_gat_fwd": 6, "dense_gat_bwd": 6}


def test_fit_peak_exact_on_a_line_and_refuses_two_points():
    fit = mr.fit_peak([1 / 64, 1 / 32, 1 / 16], [100 + 640 / 64,
                                                  100 + 640 / 32,
                                                  100 + 640 / 16])
    assert fit["at_one"] == pytest.approx(740.0, rel=1e-12)
    assert fit["a"] == pytest.approx(100.0, rel=1e-12)
    assert fit["max_rel_residual"] < 1e-12
    # y = 0.1 + 0.96 x: residuals 0.06, -0.18, 0.18, -0.06 over 1, 2.2,
    # 2.8, 4
    noisy = mr.fit_peak([1, 2, 3, 4], [1.0, 2.2, 2.8, 4.0])
    assert noisy["at_one"] == pytest.approx(1.06, rel=1e-9)
    assert noisy["max_rel_residual"] == pytest.approx(0.18 / 2.2, rel=1e-9)
    with pytest.raises(ValueError, match="at least 3"):
        mr.fit_peak([1 / 64, 1 / 32], [1.0, 2.0])
    with pytest.raises(ValueError, match="at least 3"):
        mr.fit_peak([0.5, 0.5, 0.5], [1.0, 2.0, 3.0])


def test_measured_path_raises_off_the_card(graphs, tmp_path):
    g, feat, labels, model = _step_parts("fused", graphs[SCALES[0]])
    step = mr.make_step(model, g, feat, labels)
    with pytest.raises(RuntimeError, match="CUDA"):
        mr.step_peak_mb(step, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        mr.main(["--device", "cpu", "--out", str(tmp_path / "m.md")])
    assert not (tmp_path / "m.md").exists()
    args = mr.parser().parse_args([])
    assert args.device == "cuda"  # the card unless the caller asks
    assert pathlib.Path(args.out) == ROOT / "docs" / "MEMORY_torch.md"


def _row(impl, dtype, scale, resident, peak, saved):
    return dict(impl=impl, gather_dtype=dtype, scale=scale,
                resident_mb=resident, peak_mb=peak,
                saved=dict(total=saved * mr.MB, E=0, N=0, other=0))


def test_markdown_labels_every_figure():
    res = dict(
        rows=[_row("naive", "float32", 1 / 64, 120.5, 8000.25, 4200.0),
              _row("fused", "float32", 1 / 64, 100.0, 300.0, 20.0),
              _row("fused", "float32", 1.0, 5800.0, 6500.0, 250.0),
              _row("fused", "bfloat16", 1.0, 5800.0, 6400.0, 240.0)],
        fit=dict(a=10.0, b=512000.0, at_one=512010.0,
                 max_rel_residual=0.0123),
        counted_mb=270000.0, nodes=232965, edges=114848857,
        nvidia_smi="NVIDIA H100 80GB HBM3, 700.00 W", torch="2.11.0",
        total_mb=81559.0, stopped=[(0.125, 64000.0)])
    text = mr.markdown(res)
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in text and "2.11.0" in text
    assert "8,283" in text and "22,467" in text and "TPU" not in text
    table = [ln for ln in text.splitlines() if ln.startswith("| ")
             and not ln.startswith(("| implementation", "| ---"))]
    assert len(table) == 5
    label = re.compile(r"^\d[\d,]*(\.\d+)? (measured|fitted|counted)")
    for ln in table:
        cells = [c.strip() for c in ln.strip("|").split("|")]
        for cell in cells[3:]:  # MB resident, MB peak, MB saved
            assert label.match(cell) or cell == "not measured", (ln, cell)
    assert "| naive | float32 | 1 | not measured | 512,010.0 fitted | " \
        "270,000.0 counted" in text
    # every number outside the table names what it is
    assert "0.0123 (fitted)" in text and "64,000 MB predicted" in text


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device memory is measured there "
                    "only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_measured_peak_holds_the_counted_saved_bytes(tmp_path, cuda_device):
    graph = reddit.load_reddit(SCALES[1], cache_dir=tmp_path,
                               log=lambda m: None).graph
    row = mr.measure("fused", graph, SCALES[1], cuda_device)
    assert row["peak_mb"] >= row["saved"]["total"] / mr.MB
    assert row["peak_mb"] >= row["resident_mb"] > 0
    assert row["launches"]["dense_gat_fwd"] == mr.STEPS * 2
