"""The frozen counts against the port's own arithmetic at small shapes:
the FLOP count against ``utils/flops.py`` (forward: its analytic count;
training step: ``FlopCounterMode`` over the port's ``train_step``), and
K1/K2's bytes and operations against ``probes/common.py::cv_work``."""
from __future__ import annotations

import pytest
import torch

from perfbench import program, scenes
from perfbench.counts import flops, roofline
from perfbench.harness import architecture, load_json


@pytest.mark.parametrize("name", ("casmvsnet", "casmvsnet_gwc8"))
@pytest.mark.parametrize("wh,views,batch", [((64, 48), 3, 2),
                                            ((96, 64), 5, 1)])
def test_forward_flops_match_the_port(name, wh, views, batch):
    from casmvsnet_pl_tpu_torch.utils.flops import forward_flops
    cfg = load_json("configs", f"{name}.json")
    port = program.port_model(cfg, program.draw_weights(cfg, 0, "cpu"), "cpu")
    want = forward_flops(port, wh, views, batch)["total"]
    got = architecture(cfg).flops(cfg, wh, views, batch)
    assert got == want


@pytest.mark.parametrize("name", ("casmvsnet", "casmvsnet_gwc8"))
def test_train_flops_match_the_counter(name):
    from casmvsnet_pl_tpu_torch.utils.flops import (cost_volume_flops,
                                                    counted_conv_flops)
    cfg = load_json("configs", f"{name}.json")
    w = program.draw_weights(cfg, 0, "cpu")
    tr, state = program.trainer(cfg, w, "cpu")
    b = scenes.make_batch(0, [0, 1], (64, 64), 3, 60.0, cfg, "cpu")
    conv = sum(counted_conv_flops(state.model, tr.train_step, state,
                                  b).values())
    cv = cost_volume_flops(cfg["n_depths"], cfg["feature_channels"],
                           (64, 64), 3, 2, cfg["num_groups"], backward=True)
    got = architecture(cfg).flops(cfg, (64, 64), 3, 2, train=True)
    assert got == conv + cv


@pytest.mark.parametrize("backward", (False, True))
@pytest.mark.parametrize("kind,groups", (("variance", 1), ("groupwise", 8)))
def test_cv_work_matches_the_probes(backward, kind, groups):
    """The probes read variance from G = 1: the same numbers for the two
    published cost volumes."""
    from casmvsnet_pl_tpu_torch.probes.common import bound, cv_work
    for args in [(2, 3, 48, 128, 160, 32), (1, 5, 8, 864, 1152, 8),
                 (2, 3, 32, 256, 320, 16)]:
        want = cv_work(*args, groups, 2, backward)
        assert roofline.cv_work(*args, kind, groups, 2, backward) == want
        assert roofline.bound_s(*want) == pytest.approx(
            bound(*want)[0] * 1e-3, rel=1e-12)


def test_peak_is_the_data_sheet():
    from casmvsnet_pl_tpu_torch.utils.flops import PEAK_FLOPS
    for card, rates in PEAK_FLOPS.items():
        assert flops.peak_bf16(card) == rates[torch.bfloat16]
    assert flops.peak_bf16("some other card") is None
