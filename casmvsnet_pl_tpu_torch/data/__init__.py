from .loader import DataLoader, collate, pad_batch, prefetch_to_device
from .synthetic import PlaneScene

__all__ = ["PlaneScene", "DataLoader", "collate", "pad_batch",
           "prefetch_to_device"]
