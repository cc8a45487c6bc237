"""The JAX package's initial weights, made without JAX.

``casmvsnet_pl_tpu``'s ``MVSTrainer.init_state(batch, seed)`` runs flax's
``model.init`` with ``jax.random.PRNGKey(seed)``: every kernel is
``lecun_normal`` (a normal truncated to two standard deviations, scaled to
variance 1/fan_in), biases and BatchNorm shifts are 0, BatchNorm scales
and running variances 1, running means 0. Each kernel's key is the root key
folded with the SHA-1 of its module path and the scope's first rng count,
as ``flax/core/scope.py::LazyRng`` derives it, and its values come from
``jax.random``'s threefry-2x32 counter hash (``jax_threefry_partitionable``,
JAX's default) through ``jax.random.truncated_normal``'s uniform and
``erf_inv``.

Here the same steps run in numpy: the keys and random bits are JAX's to the
bit; ``erf`` / ``erf_inv`` use the single-precision approximation that XLA
uses, so a weight can differ from JAX's by a few float32 ulps (XLA may fuse
the polynomial's multiply-adds). :func:`jax_initial_weights` returns a state
dict of the port, as ``utils/convert.py::state_dict_from_jax`` would from
``init_state``'s parameters (``tests/test_torch_port_jax_init.py`` holds
the two to each other).
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from .convert import jax_from_state_dict, state_dict_from_jax

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (``jax._src.prng._threefry2x32_lowering``)
    of the counter words ``x0``, ``x1`` under ``key`` (2 uint32)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32."""
    return np.array([0, seed], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    y0, y1 = threefry2x32(key, np.array([0], np.uint32),
                          np.array([data], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def param_key(root: np.ndarray, path, count: int = 1) -> np.ndarray:
    """The key of the ``count``-th ``make_rng('params')`` in the flax scope
    at ``path`` (module names from the root), ``LazyRng``'s SHA-1 fold."""
    m = hashlib.sha1()
    for x in (*path, count):
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], byteorder="big"))


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` as uint32 (partitionable threefry:
    the flat index as a 64-bit counter, its two words hashed and xor-ed)."""
    n = math.prod(shape)
    index = np.arange(n, dtype=np.uint64)
    hi = (index >> np.uint64(32)).astype(np.uint32)
    lo = (index & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def erf_inv32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` (Giles' single-precision approximation)."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):         # x = +-1: w = inf
        w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    ws = w - np.float32(2.5)
    wl = np.sqrt(w) - np.float32(3.0)
    ps = np.float32(2.81022636e-08)
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
              1.50140941):
        ps = np.float32(c) + ps * ws
    pl = np.float32(-0.000200214257)
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682):
        pl = np.float32(c) + pl * wl
    out = np.where(small, ps, pl) * x
    return np.where(np.abs(x) == 1, np.copysign(np.float32(np.inf), x), out)


def truncated_normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.truncated_normal(key, -2, 2, shape)``, float32: a
    uniform in [erf(-2/√2), erf(2/√2)) through √2 erf_inv, clipped inside
    (-2, 2)."""
    sqrt2 = np.float32(math.sqrt(2))
    lo, hi = np.float32(-2.0), np.float32(2.0)
    a = np.float32(math.erf(float(lo / sqrt2)))
    b = np.float32(math.erf(float(hi / sqrt2)))
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
              ).view(np.float32) - np.float32(1.0)
    u = np.maximum(a, floats * (b - a) + a)
    out = sqrt2 * erf_inv32(u)
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)),
                   np.nextafter(hi, np.float32(-np.inf)))


def lecun_normal(key: np.ndarray, shape) -> np.ndarray:
    """flax's default kernel initializer: ``variance_scaling(1.0, "fan_in",
    "truncated_normal")`` with fan_in = shape[-2] x the receptive field."""
    fan_in = math.prod(shape) / shape[-1]
    variance = np.float32(1.0 / fan_in)
    stddev = np.sqrt(variance) / np.float32(.87962566103423978)
    return truncated_normal(key, shape) * stddev


def _initial(tree: dict, root: np.ndarray, path: tuple) -> dict:
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out[name] = _initial(value, root, path + (name,))
        elif name == "kernel":
            out[name] = lecun_normal(param_key(root, path), value.shape)
        elif name in ("scale", "var"):
            out[name] = np.ones(value.shape, np.float32)
        else:                                   # bias, mean
            out[name] = np.zeros(value.shape, np.float32)
    return out


def jax_initial_weights(model: torch.nn.Module, seed: int = 0
                        ) -> dict[str, torch.Tensor]:
    """The state dict that the JAX package's ``init_state(batch, seed)``
    gives the same configuration of ``CascadeMVSNet``, converted by
    ``state_dict_from_jax``; ``model`` gives only names and shapes."""
    params, stats = jax_from_state_dict(model.state_dict())
    root = prng_key(seed)
    return state_dict_from_jax(_initial(params, root, ()),
                               _initial(stats, root, ()))
