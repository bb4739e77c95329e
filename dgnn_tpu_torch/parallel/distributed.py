"""Process groups for the sharded path, and a launcher of one process a
rank.

Port of the runtime half of ``dgnn_tpu/parallel/distributed.py``: where the
JAX package forms one process per host and a device mesh
(``initialize_cluster``, ``graph_mesh``), here each shard is a process of
its own in one ``torch.distributed`` group.  ``initialize_cluster`` forms
the group: NCCL where every rank has a card of its own, gloo otherwise (on
the CPU, and for P ranks sharing one card, which NCCL refuses).
``run_ranks`` starts P such processes on this host with
``torch.multiprocessing``'s spawn (never fork: a forked child cannot use
the parent's CUDA context) and a free localhost port.

The JAX module's ``ScalingReport`` models the halo exchange with TPU link
rates and is not ported.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["initialize_cluster", "graph_group", "choose_backend",
           "free_port", "run_ranks"]


def choose_backend(device: str = "cuda", world_size: int = 1) -> str:
    """"nccl" when the ranks run on CUDA with a card each, else "gloo"."""
    if device == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_cluster(coordinator_address: str, num_processes: int,
                       process_id: int, *, device: str = "cuda") -> str:
    """Join (or form) the process group of ``num_processes`` ranks.

    ``coordinator_address``: "host:port" of rank 0 (nothing in the
    environment announces a cluster, so the caller names it);
    ``device``: where the ranks' tensors live, "cuda" or "cpu"; the
    backend is ``choose_backend``'s.  Returns the backend."""
    backend = choose_backend(device, num_processes)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return backend


def graph_group():
    """The process group the shards exchange halos in (the default group:
    one rank a shard, ranks = shards), the counterpart of the JAX
    package's ``graph_mesh``."""
    return dist.group.WORLD


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device, fn, args, out_dir):
    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    else:
        torch.cuda.set_device(0 if torch.cuda.device_count() < world
                              else rank)
    initialize_cluster(f"localhost:{port}", world, rank, device=device)
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world: int, *args, device: str = "cuda") -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes that
    form one process group (``initialize_cluster`` on a free localhost
    port), and return their results in rank order.

    ``fn`` and ``args`` must pickle: ``fn`` a module-level function (one in
    the ``__main__`` script works too).  ``device``: "cuda" puts rank r on
    card r, or every rank on card 0 when there are fewer cards than ranks
    (gloo then); "cpu" runs gloo with one torch thread a rank.
    Build the CUDA kernels (ops._build.load) before calling, so that the
    ranks load the library and do not each compile it.  A rank's
    exception is raised here (torch.multiprocessing.ProcessRaisedException)."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_rank_main,
                           args=(world, free_port(), device, fn, args,
                                 out_dir),
                           nprocs=world, join=True, start_method="spawn")
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
