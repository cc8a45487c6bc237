from .checkpoints import (TopKCheckpointManager, extract_model_params,
                          load_checkpoint, partial_load, save_checkpoint)
from .convert import state_dict_from_jax
from .optimizers import (Lookahead, OptimConfig, RAdam, make_lr_schedule,
                         make_optimizer)

__all__ = ["state_dict_from_jax", "OptimConfig", "make_lr_schedule",
           "make_optimizer", "RAdam", "Lookahead", "save_checkpoint",
           "load_checkpoint", "extract_model_params", "partial_load",
           "TopKCheckpointManager"]
