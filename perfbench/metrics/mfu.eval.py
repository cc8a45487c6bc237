"""mfu.eval: the model's operations over the traced eval window against the
card's published bf16 peak (%): the frozen count of one forward at the
cell's shape (``counts/flops.py``: convolutions plus cost volumes) times
the maps of the window, over the window, over the peak."""
from perfbench.counts.flops import model_flops, peak_bf16
from perfbench.reference.model import CascadeMVSNet


def read(run):
    peak = peak_bf16(run["card"])
    t = run["trace"]
    if peak is None or not run["units"] or t["window_s"] <= 0:
        return None
    flops = model_flops(CascadeMVSNet(run["config"]), run["config"],
                        run["img_wh"], run["mix"]["n_views"],
                        run["mix"]["batch"])
    return 100.0 * flops * run["units"] / t["window_s"] / peak
