"""mfu.train: the model's operations over the traced training window
against the cards' published bf16 peak (%): the frozen count of one
training step (forward and backward) at each rank's batch, times the steps
and the ranks, over the window, over the ranks' peak."""
from perfbench.counts.flops import model_flops, peak_bf16
from perfbench.reference.model import CascadeMVSNet


def read(run):
    peak = peak_bf16(run["card"])
    t = run["trace"]
    if peak is None or not run["units"] or t["window_s"] <= 0:
        return None
    flops = model_flops(CascadeMVSNet(run["config"]), run["config"],
                        run["img_wh"], run["mix"]["n_views"],
                        run["mix"]["batch"], train=True)
    return 100.0 * flops * run["units"] / t["window_s"] / peak
