"""The K1 probe's pieces that run without a card (``probes/k1.py``): the
ptxas log it reads registers from, its cases' inputs, and that it needs a
card."""
import torch

from casmvsnet_pl_tpu_torch.probes import common, k1

LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118cost_volume_kernelI13__nv_bfloat16Li32ELi1EEEvPKT_PKfS6_PS2_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118cost_volume_kernelI13__nv_bfloat16Li32ELi1EEEvPKT_PKfS6_PS2_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118cost_volume_kernelIfLi16ELi4EEEvPKT_PKfS5_PS1_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118cost_volume_kernelIfLi16ELi4EEEvPKT_PKfS5_PS1_iiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122cost_volume_bwd_kernelIfLi8ELi1ELi2EEEvPKT_PKfS5_S3_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122cost_volume_bwd_kernelIfLi8ELi1ELi2EEEvPKT_PKfS5_S3_Pfiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 160 registers, used 0 barriers, 400 bytes cmem[0]
"""


def test_registers_reads_k1_entries_of_a_ptxas_log():
    assert k1.registers(LOG) == {"bf16 C=32 G=1": [127, 0],
                                 "f32 C=16 G=4": [72, 4]}


def test_eval_case_is_the_eval_configuration():
    img_wh, views, batch, groups = k1.CASES["eval"]
    assert (img_wh, views, batch, groups) == ((1152, 864), 5, 1, 1)
    assert common.default_levels(img_wh) == [
        (2, 32, 48, 216, 288), (1, 16, 32, 432, 576), (0, 8, 8, 864, 1152)]


def test_plane_levels_take_the_view_count():
    """Five views give four projections per level, the cascade's depth
    windows, and per-view projections that differ."""
    levels = common.plane_levels("cpu", 2, (64, 48), n_views=5)
    for l, C, D, h, w in common.default_levels((64, 48)):
        proj, dv = levels[l]
        assert proj.shape == (2, 4, 3, 4) and dv.shape == (2, D, h, w)
        assert not torch.equal(proj[:, 0], proj[:, 3])
        assert bool((dv[:, 1:] > dv[:, :-1]).all())


def test_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert k1.main([]) == 1
