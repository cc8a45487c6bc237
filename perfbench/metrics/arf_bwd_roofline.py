"""arf_bwd_roofline: the deformable conv's backward kernel's least time
over its device time (%), per step: the bound of
``counts/deform_conv_bwd.py`` (bytes once at 3.35 TB/s; the sampling at
67 TFLOP/s on the CUDA cores, the two contractions on bf16 at C >= 16 at
the tensor cores' rate, as the forward's bound prices them) summed
over the ARF's nine convs, over the time of the traced
``deform_conv_bwd_kernel`` launches a step (``csrc/deform_conv_bwd.cu``).
None where no such kernel ran."""
from perfbench.counts.deform_conv_bwd import arf_bwd_bound_s
from perfbench.readers import kernel_seconds, per_unit


def read(run):
    n, sec = kernel_seconds(run, lambda k: "deform_conv_bwd_kernel" in k)
    per = per_unit(run, sec)
    if not n or not per or "arf" not in run["config"]:
        return None
    least = arf_bwd_bound_s(run["config"], run["img_wh"],
                            run["mix"]["n_views"], run["mix"]["batch"])
    return 100.0 * least / per
