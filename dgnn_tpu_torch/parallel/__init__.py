"""The sharded path: row-partitioned graph shards (partition), their
layers and the batch-data-parallel DGCNN on ``torch.distributed`` (spmd),
the process groups (distributed) and the trainers' ranks (trainer).  Port
of ``dgnn_tpu/parallel``."""

from .distributed import (choose_backend, free_port, graph_group,
                          initialize_cluster, run_ranks)
from .partition import GraphShards, ShardView, partition_graph, shard_view
from .spmd import (ALLREDUCES, EXCHANGES, GlobalBatchNorm, ShardedDGCNN,
                   ShardedGAT, ShardedGATConv, ShardedGMMConv,
                   ShardedMoNet, allreduce_grads, batch_parallel,
                   exchange_route, halo_exchange, merge_binned,
                   reset_exchanges, shard_edge_data)

__all__ = ["GraphShards", "partition_graph", "ShardedGAT", "ShardedGATConv",
           "ShardedGMMConv", "ShardedMoNet", "ShardedDGCNN", "GlobalBatchNorm",
           "halo_exchange", "merge_binned",
           "shard_edge_data", "ShardView", "shard_view", "allreduce_grads",
           "exchange_route", "batch_parallel", "EXCHANGES", "ALLREDUCES",
           "reset_exchanges",
           "initialize_cluster", "graph_group", "choose_backend",
           "free_port", "run_ranks"]
