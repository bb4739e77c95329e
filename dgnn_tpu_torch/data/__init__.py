from .loaders import load_citation_dataset
from .synthetic import (
    CITATION_SHAPES,
    CitationData,
    rmat_edges,
    synthetic_citation,
)

__all__ = [
    "CITATION_SHAPES",
    "CitationData",
    "load_citation_dataset",
    "rmat_edges",
    "synthetic_citation",
]
