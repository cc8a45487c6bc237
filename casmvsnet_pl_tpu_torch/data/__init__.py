from .dtu import DTUDataset
from .loader import DataLoader, collate, prefetch_to_device
from .pfm import read_pfm, save_pfm
from .synthetic import PlaneScene, write_dtu_tree

__all__ = ["DTUDataset", "PlaneScene", "write_dtu_tree", "DataLoader",
           "collate", "prefetch_to_device", "read_pfm",
           "save_pfm"]
