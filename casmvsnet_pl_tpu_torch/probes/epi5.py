"""TPU kernel #12 on the card: the 4x4 patch epilogue in the transposed,
pixel-on-lanes layout.

Counterpart of ``scripts/probe_epi5.py``. The patch sampler gathers one
4x4xCh patch row per (pixel, group of g = 8 depths) from a stride-1 patch
table and extracts each depth's bilinear sample with hat weights. The TPU
probe asked whether putting the pixels on the lanes (rows transposed to
(16 Ch, hw)) makes that epilogue cheap, and compared four samplers of one
source view per level: the quad sampler, the lane-layout epilogue
("validfold"), the transposed epilogue in XLA ("tfma") and in Pallas. Here
the Pallas kernel is ``kernels/probes.py::patch_epilogue_t_cuda``, the
quad sampler is the port's ``grid_sample_quad`` (TPU kernel #7 inside), and
"tfma" and "validfold" are PyTorch. Levels as the probe's (B=2, 640x512 at
level 0, the probe rig at a 50 mm baseline, features from ``randn`` in
bf16): l0 D=8 C=8, l1 D=32 C=16 in 2 channel splits, l2 D=48 C=32 in 4
(Ch = 8 in every split).

The patch table, the window origins and the row gather are this module's
own copies of the probe scripts' ``_pack_patches`` (``scripts/
probe_patch.py:198``), ``_coords_origin`` and ``_gather_rows``
(``scripts/probe_patch2.py:41-78``), on the port's ``project_to_src``; the
port's ``ops`` carries no patch packer.

Plain version: :func:`plain_patch_epilogue_t` (the probe's "tfma" in the
kernel's layout). :func:`patch_epilogue_t` takes a CUDA tensor to the
kernel and a CPU tensor to the plain version.

    python -m casmvsnet_pl_tpu_torch.probes.epi5
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.probes import patch_epilogue_t_cuda
from ..ops.geometry import project_to_src
from . import common

Tensor = torch.Tensor

B, PH, PW, G = 2, 4, 4, 8
LEVELS = (("l0", 0, 8, 8, 1), ("l1", 1, 32, 16, 2), ("l2", 2, 48, 32, 4))
HW0 = (512, 640)            # level-0 image (H, W)
EPI_TOL = 1e-5


def _lookat(center):
    z = -center / np.linalg.norm(center)
    up = np.array([0.0, -1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    E = np.eye(4)
    E[:3, :3] = R
    E[:3, 3] = -R @ center
    return E


def rig_proj(baseline_mm: float, W: int = 640, H: int = 512,
             radius: float = 650.0):
    """(ref, src) 4x4 projections of the probes' convergent DTU-like rig:
    cameras on a 650 mm sphere looking at the origin, focal 2892.33 px at
    1600 width, the source at ``baseline_mm`` from the reference."""
    f = 2892.33 * W / 1600.0
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    th = baseline_mm / radius
    c_ref = np.array([0.0, 0.0, -radius])
    c_src = radius * np.array([np.sin(th * 0.9), np.sin(th * 0.45), 0.0])
    c_src[2] = -np.sqrt(radius ** 2 - c_src[0] ** 2 - c_src[1] ** 2)
    mats = []
    for c in (c_ref, c_src):
        P = np.eye(4)
        P[:3] = K @ _lookat(c)[:3]
        mats.append(P)
    return mats[0], mats[1]


def setup(level: int, D: int, C: int, batch: int = B, baseline=50.0,
          hw0=HW0):
    """The probe's inputs of one level as numpy arrays: features (B, H, W,
    C) f32 from randn (the probe casts them to bf16), projections (B, 3,
    4), depths (B, D, H, W) around 650 mm; and H, W."""
    s = 2 ** level
    H, W = hw0[0] // s, hw0[1] // s
    rng = np.random.RandomState(0)
    ref, src = rig_proj(baseline, W, H)
    rel = (src @ np.linalg.inv(ref))[:3].astype(np.float32)
    proj = np.tile(rel, (batch, 1, 1))
    step = 2.65 * (2 ** level if level else 1.0)
    base = 650.0 + (np.arange(D, dtype=np.float32) - D / 2) * step
    depths = np.tile(base[:, None, None], (batch, 1, H, W)).astype(np.float32)
    feat = rng.randn(batch, H, W, C).astype(np.float32)
    return feat, proj, depths, H, W


def pack_patches(feat: Tensor, ph: int = PH, pw: int = PW) -> Tensor:
    """(B, H, W, C) -> (B, H+2, W+2, ph pw C) stride-1 patch table, zero
    padded: entry [y, x] holds pixels [y-1, y-1+ph) x [x-1, x-1+pw), lane
    (dy pw + dx) C + c."""
    Bn, H, W, C = feat.shape
    p = F.pad(feat, (0, 0, 1, pw, 1, ph))
    win = p.unfold(1, ph, 1).unfold(2, pw, 1)     # (B, H+2, W+2, C, ph, pw)
    return win.permute(0, 1, 2, 4, 5, 3).reshape(Bn, H + 2, W + 2,
                                                 ph * pw * C)


def coords_origin(proj: Tensor, depths: Tensor, H: int, W: int, g: int = G):
    """Project, group g consecutive depths, and take each group's window
    origin: x, y (B, ng, g, hw) f32, valid, and x_org, y_org (B, ng, hw),
    the floor of the group's smallest valid coordinate clipped to [-1,
    W-1] x [-1, H-1]."""
    Bn, D = depths.shape[:2]
    ng, hw = D // g, H * W
    coords = project_to_src(proj, depths, H, W)
    x = coords[..., 0].reshape(Bn, ng, g, hw)
    y = coords[..., 1].reshape(Bn, ng, g, hw)
    valid = (x > -1.0) & (x < float(W)) & (y > -1.0) & (y < float(H))
    big = torch.full_like(x, 1e9)
    x_org = torch.where(valid, x, big).amin(2).floor().clamp(-1.0, W - 1.0)
    y_org = torch.where(valid, y, big).amin(2).floor().clamp(-1.0, H - 1.0)
    return x, y, valid, x_org, y_org


def frac_coords(x, y, valid, x_org, y_org, ph: int = PH, pw: int = PW):
    """The samples' coordinates in their group's patch, (B, ng, g, hw) f32
    each; an invalid sample gets fx = -9, so all its hats are 0."""
    fx = torch.where(valid, (x - x_org[:, :, None]).clamp(0.0, pw - 1.0),
                     torch.full_like(x, -9.0))
    fy = (y - y_org[:, :, None]).clamp(0.0, ph - 1.0)
    return fx, fy


def gather_rows(table: Tensor, x_org: Tensor, y_org: Tensor) -> Tensor:
    """One patch row per (b, group, pixel): table (B, Ht, Wt, L) -> (B, ng,
    hw, L)."""
    Bn, Ht, Wt, L = table.shape
    ng, hw = x_org.shape[1:]
    idx = ((y_org.long() + 1) * Wt + x_org.long() + 1).reshape(Bn, -1)
    idx = idx + (torch.arange(Bn, device=idx.device) * (Ht * Wt))[:, None]
    return table.reshape(-1, L).index_select(0, idx.reshape(-1)).reshape(
        Bn, ng, hw, L)


def _hat(t: Tensor) -> Tensor:
    return (1.0 - t.abs()).clamp(min=0.0)


def plain_patch_epilogue_t(rowsT: Tensor, fx: Tensor, fy: Tensor) -> Tensor:
    """rowsT (n_i, 16 Ch, hw), fx and fy (n_i, g, hw) f32 -> (n_i, g, Ch,
    hw) f32: sum over dy, then dx, of hat(fx - dx) hat(fy - dy) times the
    tap's channels, each product and sum rounded in that order."""
    n_i, L, hw = rowsT.shape
    g, Ch = fx.shape[1], L // (PH * PW)
    out = torch.zeros((n_i, g, Ch, hw), dtype=torch.float32,
                      device=rowsT.device)
    for dy in range(PH):
        hy = _hat(fy - float(dy))
        for dx in range(PW):
            w = (_hat(fx - float(dx)) * hy)[:, :, None, :]
            k = dy * PW + dx
            out = out + w * rowsT[:, None, k * Ch:(k + 1) * Ch, :].float()
    return out


def patch_epilogue_t(rowsT: Tensor, fx: Tensor, fy: Tensor) -> Tensor:
    """TPU kernel #12: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU one."""
    if rowsT.is_cuda:
        return patch_epilogue_t_cuda(rowsT, fx, fy)
    return plain_patch_epilogue_t(rowsT, fx, fy)


def transposed_epilogue(rowsT: Tensor, fx: Tensor, fy: Tensor,
                        epilogue=patch_epilogue_t) -> Tensor:
    """rowsT (B, ng, L, hw), fx and fy (B, ng, g, hw) -> (B, D, hw, Ch)
    f32 through ``epilogue`` in the (n_i, ...) layout."""
    Bn, ng, L, hw = rowsT.shape
    g = fx.shape[2]
    o = epilogue(rowsT.reshape(Bn * ng, L, hw), fx.reshape(Bn * ng, g, hw),
                 fy.reshape(Bn * ng, g, hw))
    return o.reshape(Bn, ng * g, L // (PH * PW), hw).transpose(-1, -2)


def validfold_epilogue(rows: Tensor, fx: Tensor, fy: Tensor) -> Tensor:
    """The probe's lane-layout epilogue ("validfold"): rows (B, ng, hw, L)
    times per-lane hat weights cast to the rows' dtype, summed over the 16
    taps in float32 -> (B, D, hw, Ch) f32."""
    Bn, ng, hw, L = rows.shape
    Ch = L // (PH * PW)
    lane = torch.arange(L, device=rows.device)
    dxl = ((lane // Ch) % PW).float()
    dyl = (lane // (PW * Ch)).float()
    w = _hat(fx[..., None] - dxl) * _hat(fy[..., None] - dyl)
    prod = rows[:, :, None] * w.to(rows.dtype)          # (B, ng, g, hw, L)
    o = prod.float().reshape(Bn, ng, -1, hw, PH * PW, Ch).sum(-2)
    return o.reshape(Bn, -1, hw, Ch)


def patch_view(feat: Tensor, proj: Tensor, depths: Tensor, H: int, W: int,
               splits: int = 1, variant: str = "kernel") -> Tensor:
    """One source view sampled through the patch table: feat (B, H, W, C),
    proj (B, 3, 4), depths (B, D, H, W) -> (B, D, hw, C) f32. ``variant``
    "kernel" (:func:`patch_epilogue_t`), "tfma"
    (:func:`plain_patch_epilogue_t`) or "validfold"; C splits into
    ``splits`` tables that share one set of hats."""
    x, y, valid, x_org, y_org = coords_origin(proj, depths, H, W)
    fx, fy = frac_coords(x, y, valid, x_org, y_org)
    cs = feat.shape[-1] // splits
    outs = []
    for s in range(splits):
        rows = gather_rows(pack_patches(feat[..., s * cs:(s + 1) * cs]),
                           x_org, y_org)
        if variant == "validfold":
            outs.append(validfold_epilogue(rows, fx, fy))
            continue
        epi = plain_patch_epilogue_t if variant == "tfma" else \
            patch_epilogue_t
        outs.append(transposed_epilogue(rows.transpose(-1, -2).contiguous(),
                                        fx, fy, epi))
    return outs[0] if splits == 1 else torch.cat(outs, dim=-1)


def quad_view(feat: Tensor, proj: Tensor, depths: Tensor, H: int,
              W: int) -> Tensor:
    """The same view through the port's packed-quad sampler: (B, D, H, W,
    C) in feat's dtype."""
    from ..ops import grid_sample_quad, pack_quad
    return grid_sample_quad(pack_quad(feat), project_to_src(proj, depths, H,
                                                            W), H, W)


def epilogue_work(rowsT: Tensor, g: int) -> tuple[float, float]:
    """(bytes, float32 operations) of the epilogue on rowsT (n_i, 16 Ch,
    hw): rowsT, fx and fy read once, the f32 output written once; per
    (i, j, pixel) 8 hats of 4 operations and 16 weights, and 32 per
    channel (16 products and 16 sums)."""
    n_i, L, hw = rowsT.shape
    Ch = L // (PH * PW)
    nbytes = rowsT.numel() * rowsT.element_size() + 2 * n_i * g * hw * 4 \
        + n_i * g * Ch * hw * 4
    return nbytes, n_i * g * hw * (8 * 4 + 16 + 32 * Ch)


def main(device="cuda", card_name: str | None = None) -> list:
    """Per level and channel split: the kernel against the plain version
    (f32 out <= 1e-5, on bf16 and f32 rows), then timed; then the probe's
    four samplers of the view, in ms and ns per sample. Returns the
    kernel's timed results (one per split)."""
    card_name = card_name or common.card()
    results = []
    for name, level, D, C, splits in LEVELS:
        feat, proj, depths, H, W = setup(level, D, C, hw0=HW0)
        feat = torch.from_numpy(feat).to(device).to(torch.bfloat16)
        proj, depths = (torch.from_numpy(a).to(device) for a in (proj,
                                                                 depths))
        x, y, valid, x_org, y_org = coords_origin(proj, depths, H, W)
        fx, fy = frac_coords(x, y, valid, x_org, y_org)
        n_i, hw, cs = B * (D // G), H * W, C // splits
        fx, fy = fx.reshape(n_i, G, hw), fy.reshape(n_i, G, hw)
        for s in range(splits):
            rows = gather_rows(pack_patches(feat[..., s * cs:(s + 1) * cs]),
                               x_org, y_org)
            rowsT = rows.transpose(-1, -2).reshape(n_i, -1, hw).contiguous()
            del rows
            err = max(common.check_close(
                f"patch_epilogue_t_cuda {name} split {s} {t.dtype} rows",
                patch_epilogue_t_cuda(t, fx, fy),
                plain_patch_epilogue_t(t, fx, fy), EPI_TOL)
                for t in (rowsT, rowsT.float()))
            results.append(common.timed(
                patch_epilogue_t_cuda.name, "all splits",
                f"{name} split {s}/{splits} bf16 rowsT {tuple(rowsT.shape)} "
                f"g={G}", lambda: patch_epilogue_t_cuda(rowsT, fx, fy),
                lambda: plain_patch_epilogue_t(rowsT, fx, fy),
                epilogue_work(rowsT, G), err, card_name, (20, 3)))
            del rowsT
        del x, y, valid, x_org, y_org, fx, fy
        views = {"quad": lambda: quad_view(feat, proj, depths, H, W)}
        for variant in ("validfold", "tfma", "kernel"):
            views[variant] = (lambda v=variant: patch_view(
                feat, proj, depths, H, W, splits, v))
        k_out, t_out = views["kernel"](), views["tfma"]()
        err = common.check_close(f"{name} patch view, kernel against tfma",
                                 k_out, t_out, EPI_TOL)
        diffs = {v: (views[v]().reshape(k_out.shape).float() - k_out)
                 .abs().max().item() for v in ("quad", "validfold")}
        del k_out, t_out
        n = B * D * hw
        times = {v: common.cuda_ms(fn, 5) for v, fn in views.items()}
        print(f"probe {name} C{C} D{D} split{splits} view of one source, "
              f"B={B}: " + ", ".join(
                  f"{v} {t!r} ms ({t * 1e6 / n!r} ns/sample)"
                  for v, t in times.items())
              + f"; kernel view against tfma max_abs_err {err!r}, against "
              f"quad {diffs['quad']!r}, validfold {diffs['validfold']!r} "
              f"[{card_name}]", flush=True)
        del feat, proj, depths, views
    return results


if __name__ == "__main__":
    main()
