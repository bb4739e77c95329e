"""The sharded path on torch.distributed (gloo, CPU ranks) against the JAX
package's single-device models: forward and every parameter gradient.

The cases mirror tests/test_parallel.py's.  The JAX references are
computed once in this process; the ranks are spawned once per world size
(a module-scoped fixture) and run every case of that size, each rank
returning its rows of the output and the summed parameter gradients; each
case then asserts on its own.  JAX is imported inside the fixtures only,
so the spawned ranks, which import this module to find their function,
import torch and the port alone.
"""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import numpy as np
import pytest
import torch

from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.models import DGCNN, GAT
from dgnn_tpu_torch.models.convert import (flax_gat_state_dict,
                                           flax_monet_state_dict,
                                           load_flax_dgcnn)
from dgnn_tpu_torch.parallel import (batch_parallel, partition_graph,
                                     run_ranks)
from dgnn_tpu_torch.parallel.trainer import (LR, GATJob, shard_loss,
                                             spec_grads, train_gat_rank)
from dgnn_tpu_torch.utils.training import make_optimizer, masked_loss

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
# the gradient tolerances of the JAX tests each case mirrors
GRAD_TOL_GAT = dict(rtol=5e-4, atol=1e-5)        # test_parallel.py:101
GRAD_TOL_HUB = dict(rtol=5e-4, atol=5e-5)        # test_parallel.py:150
GRAD_TOL_MONET = dict(rtol=2e-3, atol=2e-4)      # test_parallel.py:240, :311
DP_TOL = dict(rtol=2e-5, atol=2e-5)              # test_parallel.py:334
# the DGCNN of test_parallel.py:326
DGCNN_KW = dict(k=4, feature_dims=(8, 8), emb_dims=(16, 16),
                output_classes=5, dropout=0.0)


# ---------------------------------------------------------------------------
# what a rank runs
# ---------------------------------------------------------------------------


def _local_loss(out, spec, rows):
    """This rank's share of the case's loss: its real rows' terms under the
    global normaliser."""
    valid = rows(spec["mask_pad"])
    if spec["loss"] == "ce":
        return shard_loss(out, rows(spec["labels_pad"]).long(), valid,
                          spec["n"])
    return (torch.sin(out) * valid[:, None]).sum()


def _rank_cases(rank, world, specs):
    """Every case of one world size on this rank: (its rows of the output,
    the parameter gradients summed over the ranks)."""
    results = {}
    for name, spec in specs.items():
        if isinstance(spec, GATJob):
            results[name] = train_gat_rank(rank, world, spec)
            continue
        if spec["model"] == "dgcnn":
            model = DGCNN(**DGCNN_KW)
            model.load_state_dict(spec["state"], strict=True)
            with torch.no_grad():
                out = batch_parallel(model.eval(), torch.from_numpy(spec["x"]))
            results[name] = (out.numpy(), None)
            continue
        out, grads = spec_grads(
            spec, rank, lambda o, rows, s=spec: _local_loss(o, s, rows),
            device="cpu")
        results[name] = (out.numpy(), {k: g.numpy() for k, g in grads.items()})
    return results


# ---------------------------------------------------------------------------
# the cases and their JAX references (this process)
# ---------------------------------------------------------------------------


def _padded(x, n_pad):
    out = np.zeros((n_pad,) + x.shape[1:], x.dtype)
    out[:len(x)] = x
    return out


def _reference(model, g, feat, extra, *, key, loss, labels=None,
               training=False):
    """The JAX single-device model's params, output and gradient of the
    case's loss (None: no gradient), jitted: one compile of forward and
    backward."""
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(feat)
    params = jax.jit(model.init)(jax.random.PRNGKey(key), g, x, *extra)
    rngs = {"dropout": jax.random.PRNGKey(7)} if training else None

    def loss_fn(p):
        out = model.apply(p, g, x, *extra, training=training, rngs=rngs) \
            if training else model.apply(p, g, x, *extra)
        if loss == "ce":
            ls = -jax.nn.log_softmax(out)[jnp.arange(out.shape[0]),
                                          jnp.asarray(labels)]
            return jnp.mean(ls), out
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return params, np.asarray(out), (None if loss is None else grads)


def _attn_seeds(model, params, g, feat):
    """The uint32 seeds the JAX GAT's dropout keys give its layers in a
    training apply with PRNGKey(7) (int(jax.random.bits(key, uint32)))."""
    import jax
    import jax.numpy as jnp

    import dgnn_tpu.models.gat as jax_gat_module

    seeds = []
    orig = jax_gat_module.gat_aggregate

    def recording(graph, ar, ac, x, **kw):
        seeds.append(int(jax.random.bits(kw["key"], dtype=jnp.uint32)))
        return orig(graph, ar, ac, x, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gat_module, "gat_aggregate", recording)
        model.apply(params, g, jnp.asarray(feat), training=True,
                    rngs={"dropout": jax.random.PRNGKey(7)})
    assert len(seeds) == 2  # one a layer
    return seeds


def _gat_cases(rng, *, n, deg, layouts, power_law=False, loss="sin", key=0,
               attn_drop=0.0, dense_dtype="bfloat16"):
    """One problem and its JAX reference, partitioned as each of
    ``layouts`` ((num_shards, dense) pairs): one (spec, reference) a
    layout."""
    from dgnn_tpu.graph.structure import build_graph
    from dgnn_tpu.models import GAT
    from tests.conftest import random_graph

    h, f, in_feats = 2, 4, 10
    src, dst = random_graph(rng, n, deg, power_law=power_law)
    g = build_graph(src, dst, n, widths=(4, 16))
    feat = rng.normal(size=(n, in_feats)).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32) if loss == "ce" else None
    ref_model = GAT(num_layers=1, n_hidden=f, n_classes=3, heads=(h, 1),
                    attn_drop=attn_drop)
    training = attn_drop > 0
    params, ref, grads = _reference(ref_model, g, feat, (), key=key,
                                    loss=loss, labels=labels,
                                    training=training)
    seeds = _attn_seeds(ref_model, params, g, feat) if training else None
    want_grads = {k: v.numpy() for k, v in flax_gat_state_dict(grads).items()}
    out = []
    for num_shards, dense in layouts:
        shards = partition_graph(src, dst, n, num_shards, widths=(4, 16),
                                 dense=dense)
        if dense is not None:
            assert shards.fwd_dense is not None
            assert shards.bwd_dense is not None
        n_pad = shards.padded_nodes
        spec = dict(
            model="gat", shards=shards, state=flax_gat_state_dict(params),
            kwargs=dict(in_feats=in_feats, num_layers=1, n_hidden=f,
                        n_classes=3, heads=(h, 1), attn_drop=attn_drop,
                        dense_dtype=dense_dtype),
            training=training, seeds=seeds, features=_padded(feat, n_pad),
            mask_pad=_padded(np.ones(n, np.float32), n_pad),
            labels_pad=None if labels is None else _padded(labels, n_pad),
            loss=loss, n=n)
        out.append((num_shards, spec, ref, want_grads))
    return out


def _monet_case(rng, *, pseudo):
    import jax.numpy as jnp

    from dgnn_tpu.graph.structure import build_graph
    from dgnn_tpu.models import MoNet
    from dgnn_tpu.ops.gmm import NodePseudo as JaxNodePseudo
    from dgnn_tpu.ops.gmm import bin_pseudo
    from tests.conftest import random_graph

    num_shards, in_feats = 4, 10
    if pseudo == "binned":  # test_parallel.py:188
        n, k, dim, dense, dense_dtype = 40, 2, 3, None, "bfloat16"
        src, dst = random_graph(rng, n, 4)
    else:  # test_parallel.py:243
        n, k, dim, dense, dense_dtype = 48, 2, 2, (8, 24), "float32"
        src, dst = random_graph(rng, n, 6, power_law=True)
    shards = partition_graph(src, dst, n, num_shards, widths=(4, 16),
                             dense=dense)
    g = build_graph(src, dst, n, widths=(4, 16))
    n_pad = shards.padded_nodes
    feat = rng.normal(size=(n, in_feats)).astype(np.float32)
    spec = dict(model="monet", shards=shards, training=False, loss="sin",
                n=n, pseudo=pseudo, features=_padded(feat, n_pad),
                mask_pad=_padded(np.ones(n, np.float32), n_pad))
    if pseudo == "binned":
        pflat = rng.normal(size=(g.num_edges, 2)).astype(np.float32)
        jp = bin_pseudo(g, jnp.asarray(pflat))
        spec["pseudo_flat"] = pflat
    else:
        psrc = rng.normal(size=(n, 1)).astype(np.float32)
        pdst = rng.normal(size=(n, 1)).astype(np.float32)
        jp = JaxNodePseudo(src=jnp.asarray(psrc), dst=jnp.asarray(pdst))
        spec.update(psrc=_padded(psrc, n_pad), pdst=_padded(pdst, n_pad))
    ref_model = MoNet(n_hidden=4, out_feats=3, n_layers=1, dim=dim,
                      n_kernels=k, dropout=0.0)
    params, ref, grads = _reference(ref_model, g, feat, (jp,), key=2,
                                    loss="sin")
    spec["state"] = flax_monet_state_dict(params)
    spec["kwargs"] = dict(in_feats=in_feats, n_hidden=4, out_feats=3,
                          n_layers=1, dim=dim, n_kernels=k, dropout=0.0,
                          pseudo_in=2, pseudo=pseudo, dense_dtype=dense_dtype)
    return [(num_shards, spec, ref,
             {k_: v.numpy() for k_, v in
              flax_monet_state_dict(grads).items()})]


def _monet_binned_hub_case(rng):
    """Binned pseudo on shards built with hub blocks: the JAX layer drops
    the combine tables and sums segments by row (and the blocks' edges,
    which hold no slot, are not aggregated), so its reference is the JAX
    sharded model itself (shard_map over 4 CPU devices, check_vma=False as
    tests/test_parallel.py's other sharded cases), not a single-device
    model."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from dgnn_tpu.graph.structure import build_graph
    from dgnn_tpu.models import MoNet
    from dgnn_tpu.ops.gmm import bin_pseudo
    from dgnn_tpu.parallel import ShardedMoNet as JaxShardedMoNet
    from dgnn_tpu.parallel import local_view
    from dgnn_tpu.parallel import partition_graph as jax_partition_graph
    from dgnn_tpu.parallel import shard_edge_data as jax_shard_edge_data
    from tests.conftest import random_graph

    n, k, dim, in_feats = 48, 2, 3, 10
    src, dst = random_graph(rng, n, 6, power_law=True)
    shards = partition_graph(src, dst, n, 4, widths=(4, 16), dense=(8, 24))
    assert shards.fwd_dense is not None and shards.bwd_dense is not None
    jshards = jax_partition_graph(src, dst, n, 4, widths=(4, 16),
                                  dense=(8, 24))
    g = build_graph(src, dst, n, widths=(4, 16))
    n_pad = shards.padded_nodes
    feat = _padded(rng.normal(size=(n, in_feats)).astype(np.float32), n_pad)
    pflat = rng.normal(size=(g.num_edges, 2)).astype(np.float32)
    kw = dict(n_hidden=4, out_feats=3, n_layers=1, dim=dim, n_kernels=k,
              dropout=0.0)
    params = jax.jit(MoNet(**kw).init)(jax.random.PRNGKey(2), g,
                                       jnp.asarray(feat[:n]),
                                       bin_pseudo(g, jnp.asarray(pflat)))
    model = JaxShardedMoNet(**kw)
    ptables = jax_shard_edge_data(jshards, jnp.asarray(pflat))
    mask = _padded(np.ones(n, np.float32), n_pad)
    fwd = shard_map(
        lambda p, s, pt, x: model.apply(p, local_view(s), x,
                                        jax.tree.map(lambda v: v[0], pt)),
        mesh=Mesh(np.array(jax.devices()[:4]), ("graph",)),
        in_specs=(P(), P("graph"), P("graph"), P("graph")),
        out_specs=P("graph"), check_vma=False)

    def loss_fn(p):
        out = fwd(p, jshards, ptables, jnp.asarray(feat))
        return jnp.sum(jnp.sin(out) * jnp.asarray(mask)[:, None]), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    spec = dict(model="monet", shards=shards, training=False, loss="sin",
                n=n, pseudo="binned", pseudo_flat=pflat, features=feat,
                mask_pad=mask, state=flax_monet_state_dict(params),
                kwargs=dict(in_feats=in_feats, pseudo_in=2, pseudo="binned",
                            **kw))
    return [(4, spec, np.asarray(out)[:n],
             {k_: v.numpy() for k_, v in
              flax_monet_state_dict(grads).items()})]


def _trainer_case(rng):
    """parallel.trainer at P = 2 (attention dropout on, feature dropout
    off) and the single-device GAT trained in this process with the same
    init, seeds, loss and Adam steps: the sharded trainer's losses and
    final logits should be the single-device run's."""
    from tests.conftest import random_graph

    n = 64
    src, dst = random_graph(rng, n, 4, power_law=True)
    feat = rng.normal(size=(n, 8)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    train = rng.random(n) < 0.5
    job = GATJob(shards=partition_graph(src, dst, n, 2, widths=(4, 16),
                                        dense=(8, 24)),
                 features=feat, labels=labels, train_mask=train,
                 n_classes=3, n_hidden=4, heads=(2, 1), feat_drop=0.0,
                 attn_drop=0.3, steps=3, warmup=1, dense_dtype="float32",
                 device="cpu")
    # the trainer's model, optimizer and seed streams on one device
    model = GAT(8, 1, 4, 3, (2, 1), attn_drop=0.3,
                generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model, LR, job.weight_decay)
    seed_gen = torch.Generator().manual_seed(1)
    g = build_graph(src, dst, n, widths=(4, 16))
    x, y = torch.from_numpy(feat), torch.from_numpy(labels).long()
    mask = torch.from_numpy(train)
    losses = []
    for _ in range(job.warmup + job.steps):
        seeds = torch.randint(0, 2 ** 32, (2,), generator=seed_gen,
                              dtype=torch.int64).tolist()
        opt.zero_grad()
        loss = masked_loss(model.train()(g, x, attn_seeds=seeds), y, mask)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        logits = model.eval()(g, x).numpy()
    return [(2, job, logits, losses)]


def _dgcnn_case(rng):
    """test_parallel.py:316: eval-mode DGCNN on 8 clouds of 16 points, the
    batch split over 4 ranks."""
    import jax
    import jax.numpy as jnp

    from dgnn_tpu.models import DGCNN as JaxDGCNN

    x = rng.normal(size=(8, 16, 3)).astype(np.float32)
    model = JaxDGCNN(**DGCNN_KW)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(model.apply(variables, jnp.asarray(x)))
    state = load_flax_dgcnn(DGCNN(**DGCNN_KW), variables).state_dict()
    return [(4, dict(model="dgcnn", state=state, x=x), ref, None)]


@pytest.fixture(scope="module")
def cases():
    """name -> (JAX reference output, JAX gradients, gradient tolerance,
    (the ranks' outputs concatenated, each rank's gradients))."""
    rng = np.random.default_rng(0)
    groups = {
        # test_parallel.py:25 (P = 2 and 4) and :57 (masked cross entropy
        # over n): one problem, two partitions
        ("plain_p2", "plain_p4"): (GRAD_TOL_GAT, _gat_cases(
            rng, n=48, deg=5, layouts=[(2, None), (4, None)], loss="ce",
            key=1)),
        # :107, per-shard hub blocks and combine tables
        ("dense_hub",): (GRAD_TOL_HUB, _gat_cases(
            rng, n=48, deg=6, layouts=[(4, (8, 24))], power_law=True,
            dense_dtype="float32")),
        # :154, attention dropout keyed on global ids, without and with hub
        # blocks (one single-device mask), and the gradients under it
        ("attn_dropout", "attn_dropout_hub"): (GRAD_TOL_HUB, _gat_cases(
            rng, n=48, deg=6, layouts=[(4, None), (4, (8, 24))],
            power_law=True, attn_drop=0.4, dense_dtype="float32")),
        # :188 (ROADMAP C1's case) and :243
        ("monet_binned",): (GRAD_TOL_MONET, _monet_case(rng,
                                                        pseudo="binned")),
        ("monet_node",): (GRAD_TOL_MONET, _monet_case(rng, pseudo="node")),
        # binned pseudo on shards with hub blocks: against the JAX sharded
        # layer, which computes this case the same way
        ("monet_binned_hub",): (GRAD_TOL_MONET,
                                _monet_binned_hub_case(rng)),
        ("dgcnn_data_parallel",): (None, _dgcnn_case(rng)),
        ("trainer",): (None, _trainer_case(rng)),
    }
    built = {name: (tol, *case) for names, (tol, cs) in groups.items()
             for name, case in zip(names, cs)}
    results = {}
    for world in sorted({w for _, w, _, _, _ in built.values()}):
        specs = {name: spec for name, (_, w, spec, _, _) in built.items()
                 if w == world}
        ranks = run_ranks(_rank_cases, world, specs, device="cpu")
        for name in specs:
            if name == "trainer":
                results[name] = [r[name] for r in ranks]
                continue
            outs = [r[name][0] for r in ranks]
            if specs[name]["model"] == "dgcnn":
                # every rank gathered the whole batch
                for o in outs[1:]:
                    np.testing.assert_array_equal(o, outs[0])
                outs = outs[:1]
            results[name] = (np.concatenate(outs),
                             [r[name][1] for r in ranks])
    return {name: (ref, want, tol, results[name])
            for name, (tol, _, _, ref, want) in built.items()}


CASES = ["plain_p2", "plain_p4", "dense_hub", "attn_dropout",
         "attn_dropout_hub", "monet_binned", "monet_node",
         "monet_binned_hub"]


@pytest.mark.parametrize("name", CASES)
def test_sharded_forward_matches_single(cases, name):
    ref, _, _, (out, _) = cases[name]
    np.testing.assert_allclose(out[:len(ref)], ref, **FWD_TOL)


def test_dgcnn_data_parallel_matches_single(cases):
    """Each rank's DGCNN on its 2 of 8 clouds, the logits gathered: the
    single-device JAX model's logits."""
    ref, _, _, (out, _) = cases["dgcnn_data_parallel"]
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **DP_TOL)


@pytest.mark.parametrize("name", CASES)
def test_sharded_grads_match_single(cases, name):
    _, want, tol, (_, grads) = cases[name]
    assert set(grads[0]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(grads[0][k], v, **tol, err_msg=k)
        for other in grads[1:]:  # every rank holds the same sums
            np.testing.assert_array_equal(other[k], grads[0][k])


def test_trainer_matches_single_device_training(cases):
    """parallel.trainer at P = 2 against the same training on one device:
    the losses step by step (the ranks' shares summed) and the logits
    after training; no launch counted on the CPU (the plain versions ran),
    and the exchanges took gloo on CPU tensors."""
    logits, losses, _, ranks = cases["trainer"]
    got = [sum(v) for v in zip(*(r["losses"] for r in ranks))]
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    np.testing.assert_allclose(
        np.concatenate([r["logits"] for r in ranks])[:len(logits)], logits,
        rtol=1e-4, atol=1e-5)
    assert all(r["launches"] == {} for r in ranks)
    assert all(r["exchanges"]["route"] == "gloo/cpu" for r in ranks)
