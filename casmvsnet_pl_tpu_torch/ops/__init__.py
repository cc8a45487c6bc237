from .geometry import (depth_regression, get_depth_values,
                       initial_depth_values, pixel_grid, project_to_src,
                       resize_bilinear, upsample2x)
from .grid_sample import grid_sample, grid_sample_batched
from .plane_sweep import (build_cost_volume, plain_cost_volume,
                          plain_cost_volume_bwd)

__all__ = [
    "pixel_grid", "project_to_src", "get_depth_values", "initial_depth_values",
    "depth_regression", "resize_bilinear", "upsample2x",
    "grid_sample", "grid_sample_batched",
    "build_cost_volume", "plain_cost_volume", "plain_cost_volume_bwd",
]
