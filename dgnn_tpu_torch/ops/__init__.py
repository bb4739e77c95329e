from . import common, reference
from .edgeconv import edge_conv_max, edge_conv_max_dense
from .gat import gat_aggregate
from .gmm import (NodePseudo, gaussian_weights, gmm_aggregate,
                  gmm_aggregate_node)
from .naive import gat_naive, gmm_naive
from .primitives import edge_softmax, edge_transpose, sddmm, spmm

__all__ = ["common", "edge_conv_max", "edge_conv_max_dense", "edge_softmax",
           "edge_transpose", "gat_aggregate", "gat_naive", "gaussian_weights",
           "gmm_aggregate", "gmm_aggregate_node", "gmm_naive", "NodePseudo",
           "reference", "sddmm", "spmm"]
