from .gat import gat_aggregate

__all__ = ["gat_aggregate"]
