from . import bins, common, dense, ec_tiles, gather, reference
from . import edgeconv as _edgeconv
from .edgeconv import edge_conv_max, edge_conv_max_dense
from .gat import gat_aggregate
from .gmm import (NodePseudo, gaussian_weights, gmm_aggregate,
                  gmm_aggregate_node)
from .naive import gat_naive, gmm_naive
from .primitives import edge_softmax, edge_transpose, sddmm, spmm

__all__ = ["common", "edge_conv_max", "edge_conv_max_dense", "edge_softmax",
           "edge_transpose", "gat_aggregate", "gat_naive", "gaussian_weights",
           "gmm_aggregate", "gmm_aggregate_node", "gmm_naive", "NodePseudo",
           "reference", "sddmm", "spmm", "all_launches",
           "reset_all_launches"]

# the modules whose wrappers count their kernels' launches (``LAUNCHES``)
_COUNTED = (bins, dense, ec_tiles, _edgeconv, gather)


def all_launches() -> dict:
    """Every kernel wrapper's launch count, one dict."""
    return {k: v for mod in _COUNTED for k, v in mod.LAUNCHES.items()}


def reset_all_launches() -> None:
    for mod in _COUNTED:
        mod.reset_launches()
