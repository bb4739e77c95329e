"""One cell of the benchmark: set-up, the measured window, the traced
stretch and the check, driven by the files the cell's names point to.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` reads:

- ``configs/<config>.json``: the configuration as it is run (widths,
  optimizer, ``source``, ``reduced``, ``assumed``);
- ``configs/<config>.py``: its ``Program`` (the port's model),
  ``leaves`` (the weights the benchmark makes), ``mp_passes`` and
  ``model_flops`` (operations and bytes, counted from the graph's size and
  the widths);
- ``reference/<config>.py``: its plain reference (``train``, ``infer``);
- ``traffic/<traffic>.json``: the graph and the window (``mode`` "train"
  or "infer");
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: each per-layer metric's reader, ``read(ctx)``,
  which returns a number or None where it finds nothing to read.

A later change adds a configuration, a traffic mix, a cell or a metric as
new files and entries, and edits none of these.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from . import check, graphs, peaks, trace, window
from .program import Replayer
from .reference.common import Edges

__all__ = ["Bench", "run_cell", "init_weights", "load_module", "make_inputs",
           "start", "release", "reference_side", "numbers", "CHECK_STEPS"]

# training steps the check follows: the first three of the program's own
CHECK_STEPS = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module named ``name`` (file names
    carry dots, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str, e2e_names) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in e2e_names


class Bench:
    """A benchmark (``BENCHMARK.json``'s dict) whose configuration files'
    paths are relative to ``root``, and whose cells' files lie under
    ``folder``."""

    def __init__(self, spec: dict, root: Path, folder: Path):
        self.spec, self.root, self.folder = spec, Path(root), Path(folder)

    def cell(self, name: str) -> types.SimpleNamespace:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} (known: {sorted(cells)})")
        w = cells[name]
        entry = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        f = self.folder
        e2e = [m for m in self.spec["end_to_end"] if _applies(m, name, ())]
        e2e_names = {m["name"] for m in e2e}
        layer = [m for m in self.spec["per_layer"]
                 if _applies(m, name, e2e_names)]
        return types.SimpleNamespace(
            name=name, workload=w,
            cfg=json.loads((self.root / entry["file"]).read_text()),
            cfg_mod=load_module(f / "configs" / f"{w['config']}.py",
                                f"gnnbench_config_{w['config']}"),
            ref=load_module(f / "reference" / f"{w['config']}.py",
                            f"gnnbench_reference_{w['config']}"),
            traffic=json.loads(
                (f / "traffic" / f"{w['traffic']}.json").read_text()),
            limits=json.loads((f / "limits" / f"{name}.json").read_text()),
            e2e=e2e, per_layer=layer,
            readers={m["name"]: load_module(
                f / "metrics" / f"{m['name']}.py",
                f"gnnbench_metric_{m['name']}") for m in layer})


def init_weights(leaves, gen, device) -> dict:
    """The weights a configuration lists (``leaves``: (name, shape, init)
    with init ("normal", std), ("zeros",) or ("ones",)), made on
    ``device`` from ``gen``, a tensor a leaf."""
    out = {}
    for name, shape, init in leaves:
        if init[0] == "normal":
            out[name] = torch.randn(shape, generator=gen,
                                    device=device) * init[1]
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    return out


def power_limit_w():
    """The card's power limit in W, from nvidia-smi; None where it cannot
    be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _e2e_value(name: str, state: dict):
    stem, _, rest = name.partition(".")
    if stem == "train_ms":
        return state.get("train_ms")
    if stem == "infer_ms" and rest.startswith("p"):
        lat = state.get("latencies_ms")
        return None if lat is None else window.percentile(lat,
                                                          float(rest[1:]))
    return state.get(name)


def make_inputs(c, data, seed: int, dev) -> types.SimpleNamespace:
    """The cell's features, labels and weights, made on ``dev`` from
    ``seed``, and the seed of its dropout generator."""
    n, f, ncls = data.num_nodes, data.n_feats, data.n_classes
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn(n, f, generator=gen, device=dev)
    labels = torch.randint(0, ncls, (n,), generator=gen, device=dev)
    weights = init_weights(c.cfg_mod.leaves(c.cfg, f, ncls), gen, dev)
    return types.SimpleNamespace(feats=feats, labels=labels,
                                 weights=weights, drop_seed=seed + 1)


def start(c, inputs, host_graph, dev, warm: bool = True):
    """The port's program on ``dev``, captured and, in training, driven
    through its first CHECK_STEPS steps by the captured step itself.
    ``warm``: warm a throwaway copy up first (the first program of a
    process).  Returns (program, replayer, what the check reads of the
    first steps: their losses, the first gradients as the optimizer took
    them, the parameters after them; None for inference)."""
    prog = c.cfg_mod.Program(c.cfg, c.traffic, host_graph, inputs.feats,
                             inputs.labels, inputs.weights, inputs.drop_seed,
                             dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if c.traffic["mode"] != "train":
        rep = Replayer(prog.infer, dev, warmup=2)
        sync()
        return prog, rep, None
    if warm:
        twin = prog.throwaway()
        r = Replayer(twin.step, dev, generators=[twin.drop_gen], warmup=2)
        r.replay(1)
        sync()
        r.close()
        del twin, r
    rep = Replayer(prog.step, dev, generators=[prog.drop_gen])
    losses, first = [], None
    for t in range(CHECK_STEPS):
        rep.replay(1)
        losses.append(float(prog.loss))
        if t == 0:
            first = {k: v.clone() for k, v in prog.first_grads().items()}
    return prog, rep, dict(losses=losses, first=first, after=prog.params())


def release() -> None:
    """Hand the device memory of what the caller has dropped back: call
    it after closing the replayer and deleting the program."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_side(c, data, inputs, edges, lowp=None, fault=None):
    """What the reference gives in the program's place: its first steps
    (training) or its logits (inference), with the per-edge operands
    stored in the traffic's ``gather_dtype`` as the configuration states,
    or in the precision ``lowp`` (the control); or with a ``fault``
    planted ("half": the loss over half the nodes, or half the logits
    zeroed; "altered": one logit of the answer altered)."""
    n, ncls = data.num_nodes, data.n_classes
    rows = c.traffic["gather_dtype"]
    if c.traffic["mode"] == "train":
        ref = c.ref.train(c.cfg, inputs.weights, inputs.feats,
                          inputs.labels, edges, ncls, CHECK_STEPS,
                          inputs.drop_seed, lowp=lowp, rows=rows,
                          fault=fault)
        return dict(losses=ref["losses"], first=ref["first_grads"],
                    after=ref["params"])
    out = c.ref.infer(c.cfg, inputs.weights, inputs.feats, edges, ncls,
                      lowp=lowp, rows=rows)
    if fault == "half":
        out[n // 2:] = 0.0
    elif fault == "altered":
        i = int(out[0].abs().argmax())
        out[0, i] = -out[0, i]
    return [out]


def numbers(c, inputs, prog_side, ref_side) -> dict:
    """The numbers the check compares, of the program's side against the
    reference's (``reference_side`` with no fault)."""
    if c.traffic["mode"] == "train":
        w = inputs.weights
        return check.training_numbers(
            prog_side["losses"], ref_side["losses"], prog_side["first"],
            ref_side["first"],
            {k: v - w[k] for k, v in prog_side["after"].items()},
            {k: ref_side["after"][k] - w[k] for k in prog_side["after"]})
    dev = ref_side[0].device
    return check.inference_numbers([o.to(dev) for o in prog_side],
                                   ref_side[0])


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             traced: bool, device, cache_dir: Path, t_start: float) -> dict:
    """Run the cell ``name`` on ``device``; returns its result line."""
    c = bench.cell(name)
    cfg, tr = c.cfg, c.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    data = graphs.load_csr(tr, cache_dir, log)
    host_graph = graphs.port_graph(data, cfg["dense"], cache_dir, log)
    n, f, ncls = data.num_nodes, data.n_feats, data.n_classes
    t0 = time.perf_counter()
    inputs = make_inputs(c, data, seed, dev)
    sync()
    log(f"setup stage inputs and weights on the device: "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    train = tr["mode"] == "train"
    prog, rep, first = start(c, inputs, host_graph, dev)
    del host_graph
    log(f"setup stage program, warm-up, capture"
        f"{', first steps' if train else ''}: "
        f"{time.perf_counter() - t0:.3f} s")
    state = {"setup_s": time.time() - t_start}

    kept = []
    if train:
        marker = window.cuda_marker if cuda else (lambda: (lambda: None))
        steps, wall = window.train_window(rep.replay, seconds,
                                          marker=marker)
        state["train_ms"] = window.train_ms(steps, wall)
        attempted, failed = steps, int(prog.nonfinite)
        log(f"window: {steps} steps in {wall:.6f} s, "
            f"{state['train_ms']:.6f} ms a step")
    else:
        def request():
            return window.request(rep.replay, sync)
        rng = np.random.default_rng(seed)
        k = int(tr["sampled"])

        def keep(i):  # a reservoir of k requests' outputs, drawn from seed
            if i < k:
                kept.append(prog.out.to("cpu"))
            else:
                j = int(rng.integers(0, i + 1))
                if j < k:
                    kept[j] = prog.out.to("cpu")

        lat = window.infer_window(request, seconds, after=keep)
        state["latencies_ms"] = lat
        attempted = len(lat)
        failed = sum(1 for o in kept if not bool(torch.isfinite(o).all()))
        log(f"window: {len(lat)} requests, median "
            f"{window.percentile(lat, 50):.6f} ms, p95 "
            f"{window.percentile(lat, 95):.6f} ms, max {max(lat):.6f} ms")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    state["peak_mb"] = peak / 2 ** 20

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit_w": power_limit_w() if cuda else None}
    result_extra = {}
    per_layer = {}
    if traced:
        steps_t = int(tr["trace_steps"])
        if train:
            def stretch():
                rep.replay(steps_t)
                sync()
        else:
            def stretch():
                for _ in range(steps_t):
                    window.request(rep.replay, sync)
        tr_ = trace.profile(stretch, steps_t)
        device_info.update(busy_s=tr_.busy_s, window_s=tr_.window_s)
        result_extra["breakdown"] = tr_.breakdown()
        log(f"trace: {tr_.steps} steps, {tr_.launches()} launches, busy "
            f"{tr_.busy_s:.6f} of {tr_.window_s:.6f} s")
        log("trace: own kernels " + json.dumps(tr_.names(trace.OWN)))
        pk = peaks.PEAKS.get(kind)
        gbytes = 2 if tr.get("gather_dtype") == "bfloat16" else 4
        mode = tr["mode"]
        ctx = types.SimpleNamespace(
            trace=tr_, e2e={m["name"]: _e2e_value(m["name"], state)
                            for m in c.e2e},
            peaks=pk,
            least_mp_s=(peaks.least_seconds(c.cfg_mod.mp_passes(
                cfg, n, data.num_edges, f, ncls, gbytes, mode), pk)
                if pk else None),
            model_flops=c.cfg_mod.model_flops(cfg, n, data.num_edges, f,
                                              ncls, mode))
        for m in c.per_layer:
            v = c.readers[m["name"]].read(ctx)
            if v is not None:
                per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
    rep.close()
    del rep, prog
    release()

    t0 = time.perf_counter()
    edges = Edges(data.row_ptr, data.col_ind, dev)
    nums = numbers(c, inputs, first if train else kept,
                   reference_side(c, data, inputs, edges))
    sync()
    log(f"check: reference {time.perf_counter() - t0:.3f} s")
    log("check: every number " + json.dumps(nums))
    correct = check.judge(nums, c.limits) and failed == 0

    metrics = {}
    if traced:
        metrics = per_layer
    else:
        for m in c.e2e:
            v = _e2e_value(m["name"], state)
            if v is None or not math.isfinite(v):
                raise RuntimeError(f"{name} does not give {m['name']}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info, **result_extra,
            "checks": {k: {"value": nums.get(k), "limit": v}
                       for k, v in c.limits.items()}}
