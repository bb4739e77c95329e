from .cache import load_graph, save_graph
from .knn import knn_graph, knn_mask_neg
from .structure import (
    BinnedAdj,
    CombineTable,
    DenseBlock,
    Graph,
    build_graph,
    build_graph_from_csr,
    from_binned,
)

__all__ = ["BinnedAdj", "CombineTable", "DenseBlock", "Graph", "build_graph",
           "build_graph_from_csr", "from_binned", "knn_graph", "knn_mask_neg",
           "load_graph", "save_graph"]
