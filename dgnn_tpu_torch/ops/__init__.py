from .edgeconv import edge_conv_max, edge_conv_max_dense
from .gat import gat_aggregate
from .gmm import NodePseudo, gmm_aggregate_node

__all__ = ["edge_conv_max", "edge_conv_max_dense", "gat_aggregate",
           "gmm_aggregate_node", "NodePseudo"]
