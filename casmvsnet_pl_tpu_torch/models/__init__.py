from .blocks import ConvBnAct, ConvTransposeBnAct3D
from .cascade import CascadeMVSNet
from .cost_reg import CostRegNet
from .feature_net import FeatureNet
from .fmt import FMT
from .transmvsnet import TransMVSNet

ARCHS = ("casmvsnet", "transmvsnet")


def build_model(arch: str = "casmvsnet", n_depths=(8, 32, 48),
                interval_ratios=(1.0, 2.0, 4.0), num_groups: int = 1,
                sampling: str = "auto") -> CascadeMVSNet:
    """The model of ``arch`` (``--arch`` of the CLIs): ``CascadeMVSNet``
    with ``num_groups`` (1: the variance), or ``TransMVSNet``, whose volume
    is the one-group correlation (``num_groups`` must be 1)."""
    if arch == "casmvsnet":
        return CascadeMVSNet(n_depths=tuple(n_depths),
                             interval_ratios=tuple(interval_ratios),
                             num_groups=num_groups, sampling=sampling)
    if arch == "transmvsnet":
        if num_groups != 1:
            raise ValueError("TransMVSNet's cost volume is the one-group "
                             f"correlation; --num_groups {num_groups} does "
                             "not apply")
        return TransMVSNet(n_depths=tuple(n_depths),
                           interval_ratios=tuple(interval_ratios),
                           sampling=sampling)
    raise ValueError(f"unknown arch {arch!r} (not in {ARCHS})")


__all__ = ["ConvBnAct", "ConvTransposeBnAct3D", "FeatureNet", "CostRegNet",
           "CascadeMVSNet", "FMT", "TransMVSNet", "ARCHS", "build_model"]
