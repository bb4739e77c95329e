from .loaders import data_dir, load_citation_dataset, load_modelnet
from .synthetic import (
    CITATION_SHAPES,
    CitationData,
    rmat_edges,
    structure_task_from_csr,
    synthetic_citation,
    synthetic_point_clouds,
)

__all__ = [
    "CITATION_SHAPES",
    "CitationData",
    "data_dir",
    "load_citation_dataset",
    "load_modelnet",
    "rmat_edges",
    "structure_task_from_csr",
    "synthetic_citation",
    "synthetic_point_clouds",
]
