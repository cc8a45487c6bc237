"""Hand-written CUDA kernels for Hopper, built from ``csrc/`` at first use."""
from .cost_epilogue import (groupwise_epilogue_bwd_cuda,  # noqa: F401
                            groupwise_epilogue_cuda, variance_epilogue_bwd_cuda,
                            variance_epilogue_cuda)
from .cost_volume import cost_volume_bwd_cuda, cost_volume_cuda  # noqa: F401
from .deform_conv import deform_conv_bwd_cuda, deform_conv_cuda  # noqa: F401
from .fmt_layer import fmt_layer_cuda  # noqa: F401
from .in_conv import in_conv_cuda  # noqa: F401
from .library import LIBRARY
from .prob_conv import prob_conv_cuda  # noqa: F401
from .tap_reduce import tap_reduce_bwd_cuda, tap_reduce_cuda  # noqa: F401
from .probes import (lane_gather_cuda, lane_prefix_copy_cuda,  # noqa: F401
                     patch_epilogue_t_cuda, row_gather_bulk_cuda,
                     row_gather_cp_async_cuda, row_gather_ldg_cuda,
                     variance_dblk_cuda, variance_v3_cuda)

# every kernel above by name: launch_counts() -> {name: launches}, and
# reset_launches() sets each count to 0
launch_counts = LIBRARY.launch_counts
reset_launches = LIBRARY.reset_launches
