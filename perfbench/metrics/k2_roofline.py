"""k2_roofline: K2's least time over its device time (%), per step: the
frozen bound of ``counts/roofline.py`` for the backward (``cv_work(...,
backward=True)``) summed over the levels, over the time of the traced
``cost_volume_bwd_kernel`` launches a step (``csrc/cost_volume_bwd.cu``)."""
from perfbench.counts.roofline import cascade_bound_s
from perfbench.readers import kernel_seconds, per_unit


def read(run):
    n, sec = kernel_seconds(run, lambda k: "cost_volume_bwd_kernel" in k)
    per = per_unit(run, sec)
    if not n or not per:
        return None
    least = cascade_bound_s(run["config"], run["img_wh"],
                            run["mix"]["n_views"], run["mix"]["batch"],
                            backward=True)
    return 100.0 * least / per
