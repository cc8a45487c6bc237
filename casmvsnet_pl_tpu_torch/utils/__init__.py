from .checkpoints import (TopKCheckpointManager, extract_model_params,
                          load_checkpoint, partial_load, save_checkpoint)
from .convert import jax_from_state_dict, state_dict_from_jax
from .jax_init import jax_initial_weights
from .optimizers import (Lookahead, OptimConfig, RAdam, make_lr_schedule,
                         make_optimizer)
from .profiling import (StepTimer, call_times, card, device_memory_stats,
                        device_time, live_array_bytes, log_compile_time,
                        measurement_device, span, span_summary, trace)
from .torch_convert import convert_checkpoint

__all__ = ["state_dict_from_jax", "jax_from_state_dict", "jax_initial_weights",
           "convert_checkpoint",
           "OptimConfig", "make_lr_schedule", "make_optimizer", "RAdam",
           "Lookahead", "save_checkpoint", "load_checkpoint",
           "extract_model_params", "partial_load", "TopKCheckpointManager",
           "trace", "StepTimer", "device_memory_stats", "live_array_bytes",
           "log_compile_time", "device_time", "call_times",
           "measurement_device", "card", "span", "span_summary"]
