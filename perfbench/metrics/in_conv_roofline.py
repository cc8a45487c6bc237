"""in_conv_roofline: CostRegNet's one-channel input block's least time
over its device time (%), per map: the bound of ``counts/in_conv.py`` (18
bytes a voxel in bf16 at 3.35 TB/s against 432 operations a voxel on the
tensor cores) summed over the three levels, over the time of the traced
launches of every kernel whose name holds ``in_conv_kernel`` a map
(``csrc/in_conv.cu``). None where no such kernel ran (a program that runs
the block in cuDNN, or a configuration whose volume has more than one
channel)."""
from perfbench.counts.in_conv import map_bound_s, one_channel
from perfbench.readers import kernel_seconds, per_unit


def read(run):
    n, sec = kernel_seconds(run, lambda k: "in_conv_kernel" in k)
    per = per_unit(run, sec)
    if not n or not per or not one_channel(run["config"]):
        return None
    return 100.0 * map_bound_s(run["config"], run["img_wh"],
                               run["mix"]["batch"]) / per
