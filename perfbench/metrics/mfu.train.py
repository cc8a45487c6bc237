"""mfu.train: the model's operations over the traced training window
against the cards' published bf16 peak (%): the frozen count of one
training step (forward and backward; the architecture's ``flops``) at
each rank's batch, times the steps and the ranks, over the window, over
the ranks' peak."""
from perfbench.counts.flops import peak_bf16
from perfbench.harness import architecture


def read(run):
    peak = peak_bf16(run["card"])
    t = run["trace"]
    if peak is None or not run["units"] or t["window_s"] <= 0:
        return None
    cfg = run["config"]
    flops = architecture(cfg).flops(cfg, run["img_wh"], run["mix"]["n_views"],
                                    run["mix"]["batch"], train=True)
    return 100.0 * flops * run["units"] / t["window_s"] / peak
