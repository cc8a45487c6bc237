"""mfu.eval: the model's operations over the traced eval window against the
card's published bf16 peak (%): the frozen count of one forward at the
cell's shape (the architecture's ``flops``: for CasMVSNet, convolutions
plus cost volumes) times the maps of the window, over the window, over the
peak."""
from perfbench.counts.flops import peak_bf16
from perfbench.harness import architecture


def read(run):
    peak = peak_bf16(run["card"])
    t = run["trace"]
    if peak is None or not run["units"] or t["window_s"] <= 0:
        return None
    cfg = run["config"]
    flops = architecture(cfg).flops(cfg, run["img_wh"], run["mix"]["n_views"],
                                    run["mix"]["batch"])
    return 100.0 * flops * run["units"] / t["window_s"] / peak
