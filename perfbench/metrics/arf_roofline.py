"""arf_roofline: the deformable-conv kernel's least time over its device
time (%), per map: the bound of ``counts/deform_conv.py`` (bytes once at
3.35 TB/s; the sampling at 67 TFLOP/s on the CUDA cores, the bf16
contraction at C >= 16 at the dense bf16 tensor rate) summed over the
ARF's nine convs, over the time of the traced ``deform_conv_kernel`` and
``deform_conv_kernel_mma`` launches a map (``csrc/deform_conv.cu``). None
where no such kernel ran."""
from perfbench.counts.deform_conv import arf_bound_s
from perfbench.readers import kernel_seconds, per_unit


def read(run):
    n, sec = kernel_seconds(run, lambda k: "deform_conv_kernel" in k)
    per = per_unit(run, sec)
    if not n or not per or "arf" not in run["config"]:
        return None
    least = arf_bound_s(run["config"], run["img_wh"], run["mix"]["n_views"],
                        run["mix"]["batch"])
    return 100.0 * least / per
