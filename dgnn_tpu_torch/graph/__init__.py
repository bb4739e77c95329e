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
           "build_graph_from_csr", "from_binned"]
