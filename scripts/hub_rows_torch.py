"""The hub-block kernels (K5 to K8) inside a cell of the benchmark, on the
card: their row spans, what the probes cost, and the recorder's host cost.

    python scripts/hub_rows_torch.py --workload monet.reddit.train \\
        --seed 7 [--host-calls 0] [--turns 2] [--out FILE]

Sets the cell up as ``gnnbench/run.py`` does (the graphs cached under
``gnnbench/.cache``), then:

1. host microseconds a replay call spends in the recorder (its probe
   check, series sample and span; ``--host-calls`` calls a batch, in turns
   with a bare call, the graph's launch left out);
2. profiled stretches of the cell's ``trace_steps`` steps (requests), in
   turns with the probes on, as a profiler sets them, and held off (the
   recorder told that no profiler records): each hub-block kernel's device
   ms a launch from the profiler, and the steps' ms from CUDA events;
3. from the last stretch with the probes on: each launch's spans, one a
   warp's work item (a block row, or for K7/K8 on a work list a piece of
   a row; quantiles of an item's time, T, t95, the tail, where the longest
   items lie in launch order), T against the profiler's duration of the
   launch, and each replay's ``dgnn.stepgraph.replay`` span against its
   first kernel;
4. the MoNet kernels' work lists (ops/dense.py ``gmm_work``) of the cell's
   blocks: budget, pieces a launch, rows cut, the share of the block's
   edges in them, and the pieces a replay walks (its K7/K8 launches times
   their block's pieces); where a block has one, the same step (request)
   captured again over copies of the blocks held to a warp a block row
   (``hold_work``), and profiled
   stretches of both in turns, the probes off: K7/K8's own ms a launch,
   the merge kernel's, and the steps' ms, with the list ("list") and
   without ("row").

Prints one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CACHE = ROOT / "gnnbench" / ".cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))

from dgnn_tpu_torch.utils import profiling  # noqa: E402

HUB = ("dense_gat_fwd_kernel", "dense_gat_bwd_kernel",
       "dense_gmm_fwd_kernel", "dense_gmm_bwd_kernel")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def setup(workload: str, seed: int, dev):
    from gnnbench import graphs
    from gnnbench.harness import Bench, make_inputs, start

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    c = Bench(spec, ROOT, ROOT / "gnnbench").cell(workload)
    data = graphs.load_csr(c.traffic, CACHE, log)
    host_graph = graphs.port_graph(data, c.cfg["dense"], CACHE, log)
    inputs = make_inputs(c, data, seed, dev)
    prog, rep, _ = start(c, inputs, host_graph, dev)
    torch.cuda.synchronize()
    return c, prog, rep


class _NoLaunch:
    def replay(self):
        pass


def host_us(rep, calls: int, turns: int) -> dict:
    """Host us a replay call spends in the recorder: ``StepGraph.replay``
    with its CUDA graph swapped for a call that launches nothing, against
    that call alone, in turns (the device idle: nothing queues)."""
    sg, graph, bare = rep.graph, rep.graph.graph, _NoLaunch()
    out = {"recorder": [], "bare": []}
    sg.graph = bare
    try:
        for _ in range(turns):
            for kind, fn in (("recorder", sg.replay), ("bare", bare.replay),
                             ("bare", bare.replay), ("recorder", sg.replay)):
                t0 = time.perf_counter_ns()
                for _ in range(calls):
                    fn()
                out[kind].append((time.perf_counter_ns() - t0) / 1e3 / calls)
    finally:
        sg.graph = graph
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in out.items()}


def stretch(rep, steps: int, infer: bool, probes: bool):
    """One profiled stretch of ``steps`` replays (requests); the probes on
    as a profiler sets them, or held off."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    real = profiling.recording
    if not probes:  # the recorder is told that no profiler records
        profiling.recording = lambda: False
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=acts) as prof:
            start.record()
            if infer:
                for _ in range(steps):
                    rep.replay()
                    torch.cuda.synchronize()
            else:
                rep.replay(steps)
            end.record()
            torch.cuda.synchronize()
    finally:
        profiling.recording = real
    dev, host = [], []
    for ev in prof.events():
        rec = (ev.name, ev.time_range.start, ev.time_range.end)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(rec)
        else:
            host.append(rec)
    return dev, host, start.elapsed_time(end) / steps


def probe_name(kernel: str) -> str | None:
    """The recorder's name (ops/dense.py ``_probe``) of a hub-block kernel
    as the profiler names it, or None for another kernel: GAT's template
    arguments; for MoNet's, "model" where the held sizes are the models'
    (``GMM_FWD_MODEL``, ``GMM_BWD_MODEL``), else "general", and the
    columns a lane."""
    from dgnn_tpu_torch.ops import dense

    for k in HUB:
        if k + "<" in kernel:
            args = kernel.split(k + "<", 1)[1].split(">")[0].split(", ")
            if k.startswith("dense_gmm"):
                model = (dense.GMM_FWD_MODEL if "fwd" in k
                         else dense.GMM_BWD_MODEL)
                held = tuple(int(a) for a in args[:-1])
                args = ["model" if held == model else "general", args[-1]]
            return f"{k}<{', '.join(args)}>"
    return None


MERGE = "dense_rows_merge_kernel"


def kernel_ms(dev) -> dict:
    by = {}
    for n, s, e in dev:
        name = MERGE if MERGE in n else probe_name(n)
        if name is not None:
            by.setdefault(name, []).append((e - s) / 1e3)
    return {k: {"launches": len(v), "ms": statistics.mean(v)}
            for k, v in by.items()}


def shape(name: str, rows: np.ndarray, dev) -> dict:
    """One launch's row spans against the profiler's last launch of it."""
    t0 = rows[:, 0].min()
    dur = (rows[:, 1] - rows[:, 0]) / 1e3          # us a row
    T, t95 = profiling.row_tail(rows)
    order = np.argsort(-dur)
    top = order[:10]
    top1 = order[:max(1, len(order) // 100)]
    ends = np.sort(rows[:, 1] - t0)
    prof = [(e - s) for n, s, e in dev if probe_name(n) == name]
    out = {
        "R": int(len(rows)),
        "row_us": {q: float(np.percentile(dur, p)) for q, p in
                   (("p50", 50), ("p90", 90), ("p99", 99), ("p999", 99.9),
                    ("max", 100))},
        "rows_over_1ms": int((dur > 1e3).sum()),
        "T_ms": T / 1e6, "t95_ms": t95 / 1e6,
        "tail_pct": 100.0 * (T - t95) / T if T > 0 else None,
        "ended_by": {f: float(np.searchsorted(ends, f * T) / len(ends))
                     for f in (0.1, 0.25, 0.5, 0.75, 0.9)},
        "longest": [{"r": int(r), "start_ms": float((rows[r, 0] - t0) / 1e6),
                     "ms": float(dur[r] / 1e3)} for r in top],
        "longest_1pct_r": {"min": int(top1.min()),
                           "median": float(np.median(top1)),
                           "max": int(top1.max())},
        "last_start_ms": float((rows[:, 0].max() - t0) / 1e6),
    }
    if prof:
        out["profiler_us"] = prof[-1]
        out["span_over_profiler"] = (T / 1e3) / prof[-1]
    return out


def replay_spans(dev, host, steps: int) -> dict:
    """Each replay's span against that replay's first kernel: the kernels
    taken in start order, ``steps`` equal runs of them."""
    spans = sorted(s for n, s, _ in host if n == "dgnn.stepgraph.replay")
    kernels = sorted(s for n, s, _ in dev
                     if not n.lower().startswith(("memcpy", "memset")))
    per = len(kernels) // steps if steps else 0
    firsts = [kernels[i * per] for i in range(steps)] if per else []
    between = [sum(1 for k in kernels if a <= k < b)
               for a, b in zip(spans, spans[1:] + [float("inf")])]
    return {"spans": len(spans), "kernels": len(kernels),
            "kernels_a_replay": per, "kernels_after_each_span": between,
            "lead_us": [k - s for s, k in zip(spans, firsts)]}


def work_lists(graph) -> dict:
    """Each direction's hub-block work list, as the MoNet kernels walk it
    (made at the block's first launch, in the cell's warm-up)."""
    from dgnn_tpu_torch.ops import dense

    out = {}
    for way in ("fwd", "bwd"):
        db = getattr(graph, way).dense
        wl = None if db is None else dense.gmm_work(db)
        out[way] = None if wl is None else {
            "budget": wl.budget, "pieces": wl.num_pieces,
            "rows": int(db.row_ids.shape[0]), "split_rows": wl.split_rows,
            "slots": wl.slots, "edges": wl.edges,
            "split_edge_share": wl.split_share}
    return out


def pieces_per_replay(launches: dict, lists: dict, graph) -> dict:
    """Pieces (a warp's work item: a block row, or a piece of a cut row)
    that one replay's K7 (forward block) and K8 (backward block) walk."""
    out = {}
    for name, way in (("dense_gmm_fwd", "fwd"), ("dense_gmm_bwd", "bwd")):
        db = getattr(graph, way).dense
        if db is None or not launches.get(name):
            continue
        wl = lists[way]
        per = wl["pieces"] if wl else int(db.row_ids.shape[0])
        out[name] = launches[name] * per
    return out


def without_lists(graph):
    """``graph`` over copies of its blocks that walk a warp a block row."""
    from dgnn_tpu_torch.ops import dense

    def drop(adj):
        if adj.dense is None:
            return adj
        db = dataclasses.replace(adj.dense)
        dense.hold_work(db, None)
        return dataclasses.replace(adj, dense=db)

    return dataclasses.replace(graph, fwd=drop(graph.fwd),
                               bwd=drop(graph.bwd))


def before_after(prog, rep, steps: int, infer: bool, turns: int,
                 dev) -> dict:
    """K7/K8's own ms a launch, the merge's and the steps' ms, over the
    blocks with their work lists ("list", the cell's replayer) and without
    ("row", a copy of the program captured over the same blocks without
    them), in turns, the probes held off."""
    from gnnbench.harness import Replayer

    twin = prog.throwaway()
    twin.graph = without_lists(prog.graph)
    fn = twin.infer if infer else twin.step
    gens = [] if infer else [twin.drop_gen]
    base = Replayer(fn, dev, generators=gens, warmup=2)
    torch.cuda.synchronize()
    got = {"list": [], "row": []}
    ms = {"list": [], "row": []}
    try:
        for _ in range(turns):
            for kind, r in (("list", rep), ("row", base), ("row", base),
                            ("list", rep)):
                d, _, step_ms = stretch(r, steps, infer, False)
                got[kind].append(kernel_ms(d))
                ms[kind].append(step_ms)
    finally:
        base.close()
    names = sorted({k for t in got["list"] + got["row"] for k in t
                    if k.startswith(("dense_gmm", MERGE))})
    return {"step_ms": ms,
            "kernel_ms": {k: {kind: [t[k]["ms"] for t in got[kind] if k in t]
                              for kind in got} for k in names}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--host-calls", type=int, default=0)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    c, prog, rep = setup(args.workload, args.seed, dev)
    infer = c.traffic["mode"] != "train"
    steps = int(c.traffic["trace_steps"])
    launches = rep.graph.launches_per_replay()
    lists = work_lists(prog.graph)
    res = {"workload": args.workload, "card": torch.cuda.get_device_name(),
           "launches_per_replay": launches,
           "pieces_per_replay": pieces_per_replay(launches, lists,
                                                  prog.graph),
           "work_lists": lists}
    if args.host_calls:
        res["host_us"] = host_us(rep, args.host_calls, 3)
    on, off, ms = [], [], {"on": [], "off": []}
    last = None
    for _ in range(args.turns):
        for probes in (True, False, False, True):
            d, h, step_ms = stretch(rep, steps, infer, probes)
            (on if probes else off).append(kernel_ms(d))
            ms["on" if probes else "off"].append(step_ms)
            if probes:
                last = (d, h, profiling.row_spans())
    res["step_ms"] = ms
    res["kernel_ms"] = {k: {"on": [t[k]["ms"] for t in on if k in t],
                            "off": [t[k]["ms"] for t in off if k in t]}
                        for k in (on[0] if on else {})}
    d, h, rows = last
    res["rows"] = {name: shape(name, r, d) for name, r in rows}
    res["replays"] = replay_spans(d, h, steps)
    res["tail_pct"] = profiling.tail_pct([r for _, r in rows])
    if any(res["work_lists"].values()):
        res["before_after"] = before_after(prog, rep, steps, infer,
                                           args.turns, dev)
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    rep.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
