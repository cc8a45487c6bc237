from .geometry import (depth_regression, get_depth_values,
                       initial_depth_values, pixel_grid, project_to_src,
                       resize_bilinear, upsample2x)
from .grid_sample import (grid_sample, grid_sample_batched, pack_quad,
                          pack_quad_adjoint, quad_weights)
from .plane_sweep import (build_cost_volume, plain_cost_volume,
                          plain_cost_volume_bwd, plain_quad_cost_volume,
                          quad_cost_volume, quad_rows)

__all__ = [
    "pixel_grid", "project_to_src", "get_depth_values", "initial_depth_values",
    "depth_regression", "resize_bilinear", "upsample2x",
    "grid_sample", "grid_sample_batched", "pack_quad", "pack_quad_adjoint",
    "quad_weights", "build_cost_volume", "plain_cost_volume",
    "plain_cost_volume_bwd", "quad_cost_volume", "plain_quad_cost_volume",
    "quad_rows",
]
