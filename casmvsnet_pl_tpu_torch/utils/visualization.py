"""Colour maps for the trainer's TensorBoard image panels.

Counterpart of ``casmvsnet_pl_tpu/utils/visualization.py`` without OpenCV:
depth maps are normalized over their positive range and JET-coloured,
probability maps BONE-coloured, through 256-entry RGB tables equal to the
bit to ``cv2.applyColorMap``'s ``COLORMAP_JET`` and ``COLORMAP_BONE``
(OpenCV's tables, interpolated from their breakpoints by ``colormap.cpp``,
with its BGR order turned to RGB; ``tests/test_torch_port_tensorboard.py``
holds them against OpenCV). Returns (H, W, 3) float32 in [0, 1],
channels last.
"""
from __future__ import annotations

import numpy as np

# 256 RGB triples each, as hex: entry i is the colour of the byte value i
_JET = (
    "00008000008400008800008c00009000009400009800009c0000a00000a40000"
    "a80000ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d000"
    "00d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028"
    "ff002cff0030ff0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff00"
    "54ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8"
    "ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00"
    "d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2aff"
    "d62effd232ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56"
    "ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff"
    "56aeff52b2ff4eb6ff4abaff46beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6"
    "ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd4"
    "00ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000ffac00ff"
    "a800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff54"
    "00ff5000ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff"
    "2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d400"
    "00d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac0000a8"
    "0000a40000a000009c00009800009400009000008c0000880000840000800000")
_BONE = (
    "00000001010102020203030404040504040605050706060807070a08080b0909"
    "0c0a0a0d0a0a0e0b0b100c0c110d0d120e0e130f0f1510101611111712121812"
    "121913131b14141c15151d16161e17171f1818211818221919231a1a241b1b25"
    "1c1c271d1d281e1e291f1f2a20202b20202d21212e22222f2323302424322525"
    "332626342626352727362828382929392a2a3a2b2b3b2c2c3c2d2d3e2e2e3f2e"
    "2e402f2f4130304231314432324533334634344734344835354a36364b37374c"
    "38384d39394f3a3a503b3b513c3c523c3c533d3d553e3e563f3f574040584141"
    "5942425b42425c43435d44445e45455f4646614747624848634949644949664a"
    "4a674b4b684c4c694d4d6a4e4e6c4f4f6d50506e50506f515170525271535373"
    "545474555575565776575876575977585a78595b795a5d7a5b5e7b5c5f7c5d60"
    "7d5e617e5e637e5f647f606580616681626782636983646a84656b84666c8566"
    "6e86676f876870886971896a728a6b748b6c758c6c768c6d778d6e788e6f7a8f"
    "707b90717c91727d92737e927480937481947582957683967784977886987987"
    "997a889a7a899a7b8a9b7c8c9c7d8d9d7e8e9e7f8f9f8091a08192a08293a182"
    "94a28395a38497a48598a58699a6879aa7889ba8889da8899ea98a9faa8ba0ab"
    "8ca1ac8da3ad8ea4ae8fa5ae90a6af90a8b091a9b192aab293abb394acb495ae"
    "b596afb696b0b697b1b798b2b899b4b99ab5ba9bb6bb9cb7bc9db8bc9ebabd9e"
    "bbbe9fbcbfa0bdc0a1bec1a2c0c2a3c1c3a4c2c4a4c3c4a5c4c5a6c6c6a7c7c7"
    "a9c8c8aac9c9abcacaaccbcbaecbcbafccccb1cdcdb2ceceb3cfcfb5d0d0b6d1"
    "d1b8d2d2b9d2d2bad3d3bcd4d4bdd5d5bed6d6c0d7d7c1d8d8c3d8d8c4d9d9c5"
    "dadac7dbdbc8dcdcc9ddddcbdedeccdfdfcee0e0cfe0e0d0e1e1d2e2e2d3e3e3"
    "d4e4e4d6e5e5d7e6e6d8e7e7dae7e7dbe8e8dde9e9deeaeadfebebe1ecece2ed"
    "ede4eeeee5eeeee6efefe8f0f0e9f1f1eaf2f2ecf3f3edf4f4eff4f4f0f5f5f1"
    "f6f6f3f7f7f4f8f8f5f9f9f7fafaf8fbfbfafcfcfbfcfcfcfdfdfefefeffffff")
COLORMAPS = {name: np.frombuffer(bytes.fromhex(table), np.uint8)
             .reshape(256, 3) for name, table in (("jet", _JET),
                                                  ("bone", _BONE))}


def apply_colormap(x_u8: np.ndarray, cmap: str) -> np.ndarray:
    """(H, W) uint8 -> (H, W, 3) RGB float32 in [0, 1] through the
    colour map's table."""
    return COLORMAPS[cmap][x_u8].astype(np.float32) / 255.0


def visualize_depth(depth: np.ndarray, cmap: str = "jet") -> np.ndarray:
    """(H, W) depth -> (H, W, 3) RGB; normalized over positive depths."""
    x = np.nan_to_num(np.asarray(depth, np.float32))
    positive = x[x > 0]
    mi = positive.min() if positive.size else 0.0
    ma = x.max() if x.size else 1.0
    x = (x - mi) / (ma - mi + 1e-8)
    return apply_colormap((255 * np.clip(x, 0, 1)).astype(np.uint8), cmap)


def visualize_prob(prob: np.ndarray, cmap: str = "bone") -> np.ndarray:
    """(H, W) probability in [0, 1] -> (H, W, 3) RGB."""
    x = np.nan_to_num(np.asarray(prob, np.float32))
    return apply_colormap((255 * np.clip(x, 0, 1)).astype(np.uint8), cmap)
