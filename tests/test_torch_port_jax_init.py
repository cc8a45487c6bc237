"""``utils/jax_init.py`` against JAX: the JAX package's initial weights made
without JAX.

The PRNG keys, ``fold_in`` and the random bits are held to ``jax.random``
to the bit; ``erf_inv`` to XLA's within 2 float32 ulps (measured 2, over
200001 points in (-1, 1)); a truncated normal and every weight of the
model to JAX's within 2.4e-7 absolute (measured: 7.2e-7 on the standard
truncated normal, whose values reach 2; 2.4e-7 on the scaled kernels),
for two seeds and two configurations (variance, and groupwise G=8, whose
cost regularizers take 8 channels). ~15 s, most of it the JAX init's
compile.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from casmvsnet_pl_tpu.models import CascadeMVSNet as JaxCascade
from casmvsnet_pl_tpu_torch.data import PlaneScene
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
from casmvsnet_pl_tpu_torch.utils import state_dict_from_jax
from casmvsnet_pl_tpu_torch.utils import jax_init


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1])
def test_keys_and_bits_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert (np.asarray(key) == jax_init.prng_key(seed)).all()
    for data in (0, 1, 12345, 2 ** 32 - 1):
        assert (np.asarray(jax.random.fold_in(key, data))
                == jax_init.fold_in(jax_init.prng_key(seed), data)).all()
    sub = jax.random.fold_in(key, 3)
    for shape in ((1,), (7,), (3, 5, 7), (3, 3, 3, 8, 16)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(sub, shape)),
            jax_init.random_bits(np.asarray(sub), shape))


def test_erf_inv_and_truncated_normal_near_jax():
    x = np.linspace(-0.99999, 0.99999, 200001).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = jax_init.erf_inv32(x)
    assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want))).all()
    assert np.isinf(jax_init.erf_inv32(np.float32([-1, 1]))).all()
    key = jax.random.fold_in(jax.random.PRNGKey(0), 7)
    want = np.asarray(jax.random.truncated_normal(key, -2, 2, (64, 64, 3)))
    got = jax_init.truncated_normal(np.asarray(key), (64, 64, 3))
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got).max() < 2.0


@pytest.fixture(scope="module")
def jax_inputs():
    scene = PlaneScene(img_wh=(32, 32), n_views=3)
    imgs, proj, _ = scene.model_inputs()
    return imgs, proj


@pytest.mark.parametrize("num_groups", [1, 8])
def test_initial_weights_equal_jax_init(jax_inputs, num_groups):
    """Every parameter and BatchNorm statistic of ``init_state``'s weights
    (``model.init`` under ``jax.jit``, as the JAX trainer calls it), seeds
    0 and 1."""
    imgs, proj = jax_inputs
    init = jax.jit(JaxCascade(n_depths=(8, 8, 16), num_groups=num_groups).init)
    model = CascadeMVSNet(n_depths=(8, 8, 16), num_groups=num_groups)
    for seed in (0, 1):
        variables = init(jax.random.PRNGKey(seed), imgs, proj, 425.0, 2.65)
        want = state_dict_from_jax(*jax.device_get(
            (variables["params"], variables["batch_stats"])))
        got = jax_init.jax_initial_weights(model, seed)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            assert got[name].shape == want[name].shape, name
            err = (got[name].double() - want[name].double()).abs().max()
            assert err <= 2.4e-7, (name, float(err))
        model.load_state_dict(got, strict=True)
