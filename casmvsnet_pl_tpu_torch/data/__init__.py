from .blendedmvs import BlendedMVSDataset
from .dtu import DTUDataset
from .loader import DataLoader, collate, prefetch_to_device
from .pfm import read_pfm, save_pfm
from .synthetic import (PlaneScene, write_blendedmvs_tree, write_dtu_tree,
                        write_tanks_tree)
from .tanks import TanksDataset

dataset_dict = {
    "dtu": DTUDataset,
    "tanks": TanksDataset,
    "blendedmvs": BlendedMVSDataset,
}

__all__ = ["DTUDataset", "BlendedMVSDataset", "TanksDataset", "dataset_dict",
           "PlaneScene", "write_dtu_tree", "write_blendedmvs_tree",
           "write_tanks_tree", "DataLoader", "collate", "prefetch_to_device",
           "read_pfm", "save_pfm"]
