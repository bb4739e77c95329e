from .convert import flax_gat_state_dict, load_flax_gat
from .gat import GAT, GATConv

__all__ = ["GAT", "GATConv", "flax_gat_state_dict", "load_flax_gat"]
