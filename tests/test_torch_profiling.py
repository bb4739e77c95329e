"""utils/profiling.py: the recorder's host spans (nesting, totals, the
bounded buffer, the profiler's view of them), the probe flag's switch, the
spans of the host build, and the tail and slow-share arithmetic the
benchmark reads; on a card (``cuda``-marked, skipped here) the hub-block
kernels' row spans, eager and replayed.

Nothing here imports JAX, so that the CUDA tests run on a machine without
it:  python -m pytest --noconftest -m cuda tests/test_torch_profiling.py
"""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import json
import sys
import threading

import numpy as np
import pytest
import torch

from dgnn_tpu_torch.data import synthetic
from dgnn_tpu_torch.graph.cache import load_graph, save_graph
from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.utils import profiling, span, trace

CPU = [torch.profiler.ProfilerActivity.CPU]


def _graph(n, seed=0):
    """A simple random graph skewed to a few hubs in both directions."""
    rng = np.random.default_rng(seed)
    src, dst = (np.minimum(rng.zipf(1.6, 8 * n) - 1, n - 1)
                for _ in range(2))
    e = np.unique(np.stack([src, rng.permutation(n)[dst]], 1), axis=0)
    return e[:, 0], e[:, 1], n


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        with span("dgnn.test.matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    text = (tmp_path / "prof" / "trace.json").read_text()
    assert json.loads(text)["traceEvents"]
    assert "dgnn.test.matmul" in text
    assert any("mm" in e.key for e in prof.key_averages())


def test_spans_nest_and_name_their_parents():
    rec = profiling.Recorder()
    with rec.span("dgnn.a") as a:
        with rec.span("dgnn.b") as b:
            with rec.span("dgnn.c"):
                pass
        with rec.span("dgnn.b"):
            pass
    assert [(r.name, r.parent) for r in rec.spans()] == [
        ("dgnn.c", "dgnn.b"), ("dgnn.b", "dgnn.a"), ("dgnn.b", "dgnn.a"),
        ("dgnn.a", None)]
    first_b = rec.spans()[1]
    assert a.start_ns <= first_b.start_ns <= first_b.end_ns <= a.end_ns
    assert b.seconds == (b.end_ns - b.start_ns) / 1e9
    assert rec.last("dgnn.b") == rec.spans()[2]
    assert rec.last("dgnn.b").seconds == pytest.approx(
        (rec.spans()[2].end_ns - rec.spans()[2].start_ns) / 1e9)
    with rec.span("dgnn.d"):  # the stack is empty again
        pass
    assert rec.spans()[-1].parent is None


def test_totals_add_up():
    rec = profiling.Recorder()
    for _ in range(3):
        with rec.span("dgnn.outer"):
            for _ in range(2):
                with rec.span("dgnn.inner"):
                    sum(range(1000))
    with rec.span("dgnn.inner"):
        pass
    tot = rec.totals()
    for name in ("dgnn.outer", "dgnn.inner"):
        recs = [r for r in rec.spans() if r.name == name]
        assert tot[name][0] == len(recs)
        assert tot[name][1] == pytest.approx(
            sum(r.end_ns - r.start_ns for r in recs) / 1e9)
    assert tot["dgnn.outer"][0] == 3 and tot["dgnn.inner"][0] == 7
    roots = rec.totals(roots=True)
    assert roots["dgnn.outer"] == tot["dgnn.outer"]
    assert roots["dgnn.inner"][0] == 1
    rec.reset()
    assert rec.spans() == [] and rec.totals() == {}


def test_threads_keep_their_own_parents_and_every_count():
    rec = profiling.Recorder()
    workers, each = 16, 500

    def work(i):
        for _ in range(each):
            with rec.span(f"dgnn.t{i}"):
                with rec.span(f"dgnn.i{i}"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    tot = rec.totals()
    assert sum(c for c, _ in tot.values()) == 2 * workers * each
    assert all(tot[f"dgnn.{k}{i}"][0] == each
               for i in range(workers) for k in "ti")
    for r in rec.spans():  # a thread's inner span under its own outer one
        kind, i = r.name[5], r.name[6:]
        assert r.parent == (f"dgnn.t{i}" if kind == "i" else None)


def test_the_buffer_stays_bounded(monkeypatch):
    assert profiling.RECORDER._spans.maxlen == profiling.SPAN_BUFFER
    monkeypatch.setattr(profiling, "SPAN_BUFFER", 8)
    rec = profiling.Recorder()
    for i in range(20):
        with rec.span(f"dgnn.n{i}"):
            pass
    assert [r.name for r in rec.spans()] == [f"dgnn.n{i}"
                                             for i in range(12, 20)]
    assert len(rec.totals()) == 20
    assert rec.last("dgnn.n19").name == "dgnn.n19"
    assert rec.last("dgnn.n3") is None  # pushed out of the buffer


def test_the_profiler_holds_the_spans_and_only_then_a_record_function(
        monkeypatch):
    made = []
    real = profiling._annotation

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_annotation", counting)
    with span("dgnn.test.outside"):
        pass
    assert made == []
    with torch.profiler.profile(activities=CPU) as prof:
        with span("dgnn.test.outer"):
            with span("dgnn.test.inner"):
                torch.ones(8) + 1
    assert made == ["dgnn.test.outer", "dgnn.test.inner"]
    events = {e.name: e for e in prof.events()}
    assert {"dgnn.test.outer", "dgnn.test.inner"} <= set(events)
    outer, inner = events["dgnn.test.outer"], events["dgnn.test.inner"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    with span("dgnn.test.after"):
        pass
    assert len(made) == 2


def test_the_flag_switches_exactly_on_a_change_of_the_profilers_state(
        monkeypatch):
    rec = profiling.Recorder()
    writes = []
    monkeypatch.setattr(rec, "_write_flag", writes.append)
    rec.sync_probes()  # no flag yet: nothing to write
    rec._flag = object()  # a flag word, as the first eager launch makes it
    rec.sync_probes()
    assert writes == []  # off, as it was made
    with torch.profiler.profile(activities=CPU):
        rec.sync_probes()
        rec.sync_probes()
        assert writes == [True]
    rec.sync_probes()
    rec.sync_probes()
    assert writes == [True, False]
    with torch.profiler.profile(activities=CPU):
        rec.sync_probes()
    assert writes == [True, False, True]


@pytest.mark.parametrize("dense,hub", [(None, ()),
                                       ((64, 150), ("fill",)),
                                       ("auto", ("plan", "fill"))])
def test_the_host_build_records_its_spans(tmp_path, dense, hub):
    cora = synthetic.synthetic_citation("cora")
    profiling.reset()
    g = build_graph(cora.src, cora.dst, cora.num_nodes, dense=dense)
    if dense == "auto":  # the planner kept a block in each direction
        assert g.fwd.dense is not None and g.bwd.dense is not None
    names = [r.name for r in profiling.spans()]
    parents = {r.name: r.parent for r in profiling.spans()}
    assert names[:2] == ["dgnn.graph.csr", "dgnn.graph.csc"]
    assert names[-1] == "dgnn.graph.build"
    for way in ("fwd", "bwd"):
        assert parents[f"dgnn.graph.bins.{way}"] == "dgnn.graph.build"
        for part in ("plan", "fill"):
            name = f"dgnn.graph.hub.{part}.{way}"
            assert (name in names) == (part in hub), name
            if part in hub:
                assert parents[name] == "dgnn.graph.build"
    roots = profiling.totals(roots=True)
    assert set(roots) == {"dgnn.graph.csr", "dgnn.graph.csc",
                          "dgnn.graph.build"}
    path = str(tmp_path / "g.npz")
    save_graph(path, g)
    load_graph(path)
    g.to("cpu")
    tot = profiling.totals()
    for name in ("dgnn.graph.cache.save", "dgnn.graph.cache.load",
                 "dgnn.graph.to"):
        assert tot[name][0] == 1 and tot[name][1] > 0, name


def test_one_long_row_is_the_whole_tail():
    rows = np.zeros((1000, 2), np.int64)
    rows[:, 0] = 1_000_000 + np.arange(1000)        # starts, ns
    rows[:, 1] = rows[:, 0] + 2_000                 # 2 us a row
    rows[17, 1] = rows[17, 0] + 50_000_000          # one row of 50 ms
    T, t95 = profiling.row_tail(rows)
    assert T == pytest.approx(50_000_017)
    assert t95 == pytest.approx(2_950 + 1, abs=2)
    assert profiling.tail_pct([rows]) == pytest.approx(100.0, abs=0.01)


def test_equal_rows_have_no_tail():
    rows = np.zeros((4096, 2), np.int64)
    rows[:, 0] = 5_000
    rows[:, 1] = 5_000 + 3_000_000
    assert profiling.row_tail(rows) == (3_000_000.0, 3_000_000.0)
    two = [rows, rows + 10_000_000]
    assert profiling.tail_pct(two) == pytest.approx(0.0, abs=1e-9)
    assert profiling.tail_pct([]) is None
    assert profiling.tail_pct([np.zeros((0, 2), np.int64)]) is None


def _series(per_replay_ms, replays_a_sample=29):
    """Points of a replay series: a sample every ``replays_a_sample``
    replays, the replays between two samples at the given ms each."""
    t, c, points = 0.0, 0, [(0.0, 0, False)]
    for ms in per_replay_ms:
        t += ms * replays_a_sample
        c += replays_a_sample
        points.append((t, c, False))
    return points


def test_a_slow_first_third_is_a_third_of_the_replays():
    ms = [1.756] * 200 + [1.641] * 400
    share = profiling.slow_share(_series(ms))
    assert share == pytest.approx(100 / 3, abs=0.5)
    assert profiling.slow_share(_series([1.641] * 600)) == 0.0


def test_profiled_samples_and_the_first_interval_are_left_out():
    points = _series([5.0] + [1.641] * 100)  # the first: warm-up, waits
    assert profiling.slow_share(points) == 0.0
    # the samples a profiler took (slow under it) are not the window's
    points += [(points[-1][0] + 3 * 29, points[-1][1] + 29, True),
               (points[-1][0] + 6 * 29, points[-1][1] + 58, True)]
    assert profiling.slow_share(points) == 0.0
    assert profiling.slow_share(_series([1.7])) is None


# ---------------------------------------------------------------------------
# on a card: the hub-block kernels' row spans
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _gmm_inputs(device, n, K=2, D=2, F=64, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    return dict(beta=r(n, D), alpha=r(n, D), feat=r(n, K, F),
                mu=r(K, D), isig=r(K, D).abs() + 0.5)


@pytest.mark.cuda
def test_cuda_eager_launches_write_row_spans_under_a_profiler(cuda_device):
    from dgnn_tpu_torch.ops import dense

    src, dst, n = _graph(1200)
    db = build_graph(src, dst, n, dense=(512, 600)).fwd.dense.to(cuda_device)
    x = _gmm_inputs(cuda_device, n)
    args = (db, x["beta"], x["alpha"], x["feat"], x["mu"], x["isig"])
    want = dense.dense_gmm_fwd(*args, use_tanh=True)
    torch.cuda.synchronize()
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = dense.dense_gmm_fwd(*args, use_tanh=True)
        torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    [(name, rows)] = profiling.row_spans()
    assert name == "dense_gmm_fwd_kernel<model, 8>"
    assert rows.shape == (db.row_ids.shape[0], 2)
    assert (rows[:, 1] >= rows[:, 0]).all() and rows.min() > 0
    kernel = [e for e in prof.events() if "dense_gmm_fwd_kernel" in e.name]
    assert len(kernel) == 1
    spread_us = (rows[:, 1].max() - rows[:, 0].min()) / 1e3
    assert spread_us <= kernel[0].time_range.elapsed_us() * 1.02 + 2


@pytest.mark.cuda
def test_cuda_replays_write_row_spans_of_a_graph_captured_without(
        cuda_device):
    from dgnn_tpu_torch.ops import dense
    from dgnn_tpu_torch.utils import StepGraph

    src, dst, n = _graph(1200)
    g = build_graph(src, dst, n, dense=(512, 600)).to(cuda_device)
    x = _gmm_inputs(cuda_device, n)
    out = {}

    def step():
        out["fwd"] = dense.dense_gmm_fwd(g.fwd.dense, x["beta"], x["alpha"],
                                         x["feat"], x["mu"], x["isig"],
                                         use_tanh=True)

    graph = StepGraph(step, cuda_device, warmup=1)
    try:
        assert graph.launches_per_replay() == {"dense_gmm_fwd": 1}
        graph.replay(2)
        torch.cuda.synchronize()
        acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            graph.replay(3)
            torch.cuda.synchronize()
        [(name, rows)] = profiling.row_spans()
        assert name == "dense_gmm_fwd_kernel<model, 8>"
        assert (rows[:, 1] >= rows[:, 0]).all() and rows.min() > 0
        host = [e for e in prof.events()
                if e.name == "dgnn.stepgraph.replay"]
        assert all(e.device_type == torch.autograd.DeviceType.CPU
                   for e in host)  # no device-side mirror
        kernels = sorted(e.time_range.start for e in prof.events()
                         if "dense_gmm_fwd_kernel" in e.name)
        assert len(host) == 3 and len(kernels) == 3
        for h, k in zip(sorted(e.time_range.start for e in host), kernels):
            assert h <= k
        assert profiling.replay_points()[0] == (0.0, 2, False)
    finally:
        graph.close()
    assert profiling.row_spans() == []
