from .blocks import ConvBnAct, ConvTransposeBnAct3D
from .cascade import CascadeMVSNet
from .cost_reg import CostRegNet
from .feature_net import FeatureNet

__all__ = ["ConvBnAct", "ConvTransposeBnAct3D", "FeatureNet", "CostRegNet",
           "CascadeMVSNet"]
