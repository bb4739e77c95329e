from .gat import gat_aggregate
from .gmm import NodePseudo, gmm_aggregate_node

__all__ = ["gat_aggregate", "gmm_aggregate_node", "NodePseudo"]
