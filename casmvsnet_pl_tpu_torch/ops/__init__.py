from .geometry import (depth_regression, get_depth_values,
                       initial_depth_values, pixel_grid, project_to_src,
                       resize_bilinear, upsample2x)
from .grid_sample import (grid_sample, grid_sample_batched, grid_sample_quad,
                          pack_quad, pack_quad_adjoint, plain_grid_sample_quad,
                          quad_weights)
from .plane_sweep import (build_cost_volume, groupwise_cost_volume,
                          plain_cost_volume, plain_cost_volume_bwd,
                          plain_quad_cost_volume, quad_cost_volume, quad_rows,
                          variance_cost_volume, warp_src_feature,
                          warp_src_quad_batched)

__all__ = [
    "pixel_grid", "project_to_src", "get_depth_values", "initial_depth_values",
    "depth_regression", "resize_bilinear", "upsample2x",
    "grid_sample", "grid_sample_batched", "grid_sample_quad",
    "plain_grid_sample_quad", "pack_quad", "pack_quad_adjoint",
    "quad_weights", "warp_src_feature", "warp_src_quad_batched",
    "variance_cost_volume", "groupwise_cost_volume", "build_cost_volume",
    "plain_cost_volume", "plain_cost_volume_bwd", "quad_cost_volume",
    "plain_quad_cost_volume", "quad_rows",
]
