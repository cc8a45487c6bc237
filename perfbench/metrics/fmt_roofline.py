"""fmt_roofline: the FMT's layer kernels' least time over their device
time (%), per map: the bound of ``counts/fmt_layer.py`` (each layer's
input, source and output once at 3.35 TB/s; its projections and MLP at the
dense bf16 tensor rate, its attention at 67 TFLOP/s on the CUDA cores)
summed over the FMT's eight layers, over the time of the traced launches
of every kernel whose name holds ``fmt_layer_`` a map (``csrc/
fmt_layer.cu``: the reduction and the pass). None where no such kernel ran:
a program without them, or a configuration without an FMT."""
from perfbench.counts.fmt_layer import fmt_bound_s
from perfbench.readers import kernel_seconds, per_unit


def read(run):
    n, sec = kernel_seconds(run, lambda k: "fmt_layer_" in k)
    per = per_unit(run, sec)
    if not n or not per or "fmt" not in run["config"]:
        return None
    least = fmt_bound_s(run["config"], run["img_wh"], run["mix"]["n_views"],
                        run["mix"]["batch"])
    return 100.0 * least / per
