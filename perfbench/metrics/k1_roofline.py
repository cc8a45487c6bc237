"""k1_roofline: K1's least time over its device time (%), per map: the
frozen bound of ``counts/roofline.py`` (bytes read and written once at
3.35 TB/s, float32 operations at 67 TFLOP/s) summed over the cascade's
levels, over the time of the traced ``cost_volume_kernel`` launches a
map (``csrc/cost_volume.cu``)."""
from perfbench.counts.roofline import cascade_bound_s
from perfbench.readers import kernel_seconds, per_unit


def read(run):
    n, sec = kernel_seconds(run, lambda k: "cost_volume_kernel" in k)
    per = per_unit(run, sec)
    if not n or not per:
        return None
    least = cascade_bound_s(run["config"], run["img_wh"],
                            run["mix"]["n_views"], run["mix"]["batch"])
    return 100.0 * least / per
