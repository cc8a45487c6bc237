"""Depth-map fusion into coloured point clouds, on one device."""
from .consistency import check_geo_consistency
from .fuse import backproject, fuse_and_write, fuse_scan, upsample_proba
from .ply import read_ply, write_ply
from .spill import SpillCache

__all__ = ["check_geo_consistency", "fuse_scan", "fuse_and_write",
           "backproject", "upsample_proba", "write_ply", "read_ply",
           "SpillCache"]
