from .convert import (flax_gat_state_dict, flax_monet_state_dict,
                      load_flax_gat, load_flax_monet)
from .gat import GAT, GATConv
from .monet import GMMConv, MoNet

__all__ = ["GAT", "GATConv", "GMMConv", "MoNet", "flax_gat_state_dict",
           "flax_monet_state_dict", "load_flax_gat", "load_flax_monet"]
