"""The readings a cell's limits are set from, at the cell's own size, in
one process: the program's numbers on many seeds (the lower readings),
and the control's and the planted faults' (the upper ones).

    python3 gnnbench/control.py --workload gat.reddit.train \\
        --seeds 11 12 13 14 15 16 17 18 19 20 21 22 --faulted 3 \\
        --out control_gat.reddit.train.jsonl

For each seed: the program as a run starts it (captured, then its first
steps, or three requests), then the reference, and the numbers the check
compares.  For the first ``--faulted`` seeds also the reference put in the
program's place in the control's precision (the traffic's ``control``:
the precision one step below the cell's), and with the faults planted
("half": the loss over half the nodes, or half the logits zeroed;
"altered": one logit of an answer altered).  A state left unchanged reads
1 by ``delta_gap`` and needs no run.  One JSON line a reading, on
standard output and in ``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

FOLDER = Path(__file__).resolve().parent
sys.path.insert(0, str(FOLDER.parent))

import run  # noqa: E402,F401  (the caches' fixed directories)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faulted", type=int, default=3)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from gnnbench import graphs, harness
    from gnnbench.reference.common import Edges

    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    c = harness.Bench(spec, run.ROOT, FOLDER).cell(args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    data = graphs.load_csr(c.traffic, run.CACHE, harness.log)
    host = graphs.port_graph(data, c.cfg["dense"], run.CACHE, harness.log)
    train = c.traffic["mode"] == "train"
    edges = None
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as fh:
        def emit(rec):
            line = json.dumps(dict(workload=args.workload, **rec))
            print(line, flush=True)
            fh.write(line + "\n")
            fh.flush()

        for i, seed in enumerate(args.seeds):
            t0 = time.perf_counter()
            inputs = harness.make_inputs(c, data, seed, dev)
            prog, rep, side = harness.start(c, inputs, host, dev,
                                            warm=i == 0)
            if not train:
                side = []
                for _ in range(3):
                    rep.replay(1)
                    side.append(prog.out.clone())
            rep.close()
            del rep, prog
            harness.release()
            if edges is None:
                edges = Edges(data.row_ptr, data.col_ind, dev)
            ref = harness.reference_side(c, data, inputs, edges)
            losses = (dict(losses=side["losses"], ref_losses=ref["losses"])
                      if train else {})
            emit(dict(seed=seed, reading="program",
                      seconds=time.perf_counter() - t0, **losses,
                      **harness.numbers(c, inputs, side, ref)))
            if i >= args.faulted:
                continue
            planted = [("control", dict(lowp=c.traffic["control"])),
                       ("half", dict(fault="half"))]
            if not train:
                planted.append(("altered", dict(fault="altered")))
            for name, kw in planted:
                t0 = time.perf_counter()
                rs = harness.reference_side(c, data, inputs, edges, **kw)
                losses = dict(losses=rs["losses"]) if train else {}
                emit(dict(seed=seed, reading=name,
                          seconds=time.perf_counter() - t0, **losses,
                          **harness.numbers(c, inputs, rs, ref)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
