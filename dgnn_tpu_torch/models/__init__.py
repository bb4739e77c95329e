from .convert import (flax_dgcnn_state_dict, flax_gat_state_dict,
                      flax_monet_state_dict, load_flax_dgcnn, load_flax_gat,
                      load_flax_monet)
from .dgcnn import DGCNN, BatchNorm, EdgeConv
from .gat import GAT, GATConv
from .monet import GMMConv, MoNet

__all__ = ["BatchNorm", "DGCNN", "EdgeConv", "GAT", "GATConv", "GMMConv",
           "MoNet", "flax_dgcnn_state_dict", "flax_gat_state_dict",
           "flax_monet_state_dict", "load_flax_dgcnn", "load_flax_gat",
           "load_flax_monet"]
