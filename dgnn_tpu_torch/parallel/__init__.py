"""The sharded path: row-partitioned graph shards (partition), their
layers on ``torch.distributed`` (spmd) and the process groups (distributed).
Port of ``dgnn_tpu/parallel``."""

from .distributed import (choose_backend, free_port, graph_group,
                          initialize_cluster, run_ranks)
from .partition import GraphShards, ShardView, partition_graph, shard_view
from .spmd import (EXCHANGES, ShardedGAT, ShardedGATConv, ShardedGMMConv,
                   ShardedMoNet, allreduce_grads, batch_parallel,
                   exchange_route, halo_exchange, merge_binned,
                   reset_exchanges, shard_edge_data)

__all__ = ["GraphShards", "partition_graph", "ShardedGAT", "ShardedGATConv",
           "ShardedGMMConv", "ShardedMoNet", "halo_exchange", "merge_binned",
           "shard_edge_data", "ShardView", "shard_view", "allreduce_grads",
           "exchange_route", "batch_parallel", "EXCHANGES",
           "reset_exchanges",
           "initialize_cluster", "graph_group", "choose_backend",
           "free_port", "run_ranks"]
