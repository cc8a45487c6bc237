from .checkpoints import (TopKCheckpointManager, extract_model_params,
                          load_checkpoint, partial_load, save_checkpoint)
from .convert import jax_from_state_dict, state_dict_from_jax
from .optimizers import (Lookahead, OptimConfig, RAdam, make_lr_schedule,
                         make_optimizer)
from .torch_convert import convert_checkpoint

__all__ = ["state_dict_from_jax", "jax_from_state_dict", "convert_checkpoint",
           "OptimConfig", "make_lr_schedule", "make_optimizer", "RAdam",
           "Lookahead", "save_checkpoint", "load_checkpoint",
           "extract_model_params", "partial_load", "TopKCheckpointManager"]
