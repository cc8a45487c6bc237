"""Data parallelism of the port (``casmvsnet_pl_tpu_torch/parallel``) on the
CPU: two ranks over gloo against one process, and against the JAX trainer
on a two-device mesh.

One spawn of two ranks (``parallel.spawn``, a join timeout of 240 s) runs
every two-rank step of this file; the one-process steps run here. The
steps are one SGD step (lr 1e-2, no momentum, no weight decay) of
``entry.data_parallel_step``:
  - a global batch of 4 distinct 32x32 plane scenes (``plane_sample``
    0-3), n_depths 8/8/8, in float64 (the model, the batch and BatchNorm's
    sums; the loss is float32 in both) and in float32 for weight seeds 0-2;
  - the JAX comparison: the 2 distinct 64x64 scenes of
    ``tests/test_torch_port_train_step.py``, from the JAX trainer's
    initial weights (``state_dict_from_jax``), against ``MVSTrainer`` on
    ``make_mesh(2)``.

Measured (two ranks against one process, one intra-op thread each;
gradients by leaf relative L2, the prob convs' biases, whose exact
gradient is 0, against their weights' gradient; buffers by max abs error
over the largest value, at least 1): float64: loss equal, gradients
within 2.6e-14 (6.3e-7 with 8 threads here and 4 a rank), buffers within
6.2e-16. float32, seeds 0-2: loss within 4.4e-7 relative, gradients
within 4.6e-2 / 8.8e-3 / 1.7e-2, buffers within 6.7e-7 (with 8 threads
here and 4 a rank: gradients 6.7e-5 to 2.3e-3, and up to 2.0e-2 with 2
here and 8 a rank). The float32 gradients are that far apart because
this small step amplifies rounding (a 1e-7 rescaling of the images moves
one leaf by 1.7 %, tests/test_torch_port_train_step.py); the float64
case is what shows that the two-rank gradient is the one-process one.
Bounds, 10x or more above the worst measured: float64 gradients 1e-5 and
buffers 1e-12, float32 gradients 0.5 and buffers 1e-4; the loss to rtol
1e-5. Against JAX: the loss and logs equal to rtol 1e-7 or better,
BatchNorm statistics within 3.0e-7.
"""
import jax
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu.data.loader import DataLoader as JaxLoader
from casmvsnet_pl_tpu.engine import MVSTrainer as JaxTrainer
from casmvsnet_pl_tpu.models import CascadeMVSNet as JaxCascade
from casmvsnet_pl_tpu.parallel import make_mesh
from casmvsnet_pl_tpu.utils import OptimConfig as JaxOptimConfig
from casmvsnet_pl_tpu_torch.data import DataLoader, PlaneScene, collate
from casmvsnet_pl_tpu_torch.entry import data_parallel_step
from casmvsnet_pl_tpu_torch.losses import sl1_loss
from casmvsnet_pl_tpu_torch.parallel import spawn
from casmvsnet_pl_tpu_torch.utils import state_dict_from_jax

import torch_dist_workers

SEEDS = (0, 1, 2)
STEP = dict(batch=4, img_wh=(32, 32), n_depths=(8, 8, 8), lr=1e-2)
BOUNDS = {"float64": (1e-5, 1e-12), "float32": (0.5, 1e-4)}
JOIN_TIMEOUT_S = 240


def _jax_samples(n=2):
    """tests/test_torch_port_train_step.py's scenes."""
    out = []
    for i in range(n):
        scene = PlaneScene(img_wh=(64, 64), n_views=3, z0=440.0 + 8.0 * i,
                           slope_x=0.05 * (i - 4), seed=i)
        imgs, proj, depths = scene.model_inputs()
        out.append({
            "imgs": imgs[0], "proj_mats": proj[0],
            "init_depth_min": np.float32(425.0),
            "depth_interval": np.float32(2.65),
            "depths": {k: v[0] for k, v in depths.items()},
            "masks": {k: np.ones(v[0].shape, bool)
                      for k, v in depths.items()},
        })
    return out


def _cases():
    yield "float64", dict(STEP, dtype=torch.float64)
    for seed in SEEDS:
        yield f"float32-{seed}", dict(STEP, seed=seed)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here and in each rank (``spawn`` splits this
    process's threads): the tier-1 run puts several test processes on the
    host's cores, where more threads each slow these steps many times
    over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """{case: (one process, rank 0, rank 1)} of saved steps, and the JAX
    trainer's step on a two-device mesh."""
    tmp = tmp_path_factory.mktemp("dp")
    kw = dict(optimizer="sgd", lr=1e-2, momentum=0.0, weight_decay=0.0)
    jt = JaxTrainer(JaxCascade(n_depths=(8, 8, 8)), JaxOptimConfig(**kw),
                    steps_per_epoch=10, mesh=make_mesh(2))
    batch = collate(_jax_samples())
    jstate = jt.init_state(batch, seed=0)
    start = state_dict_from_jax(*jax.device_get((jstate.params,
                                                 jstate.batch_stats)))
    jstate, jlogs = jt.train_step(jstate, jt._device_batch(batch))
    jax_out = {"logs": {k: float(v) for k, v in
                        jax.device_get(jlogs).items()},
               "buffers": state_dict_from_jax(*jax.device_get(
                   (jstate.params, jstate.batch_stats)))}

    specs = {name: dict(spec, out=str(tmp / name)) for name, spec in _cases()}
    specs["jax"] = dict(batch=batch, img_wh=(64, 64), n_depths=(8, 8, 8),
                        lr=1e-2, weights=start, out=str(tmp / "jax"))
    spawn(torch_dist_workers.steps, 2, (list(specs.values()),), cpu=True,
          timeout_s=JOIN_TIMEOUT_S, pg_timeout_s=JOIN_TIMEOUT_S)
    out = {}
    for name, spec in specs.items():
        if name != "jax":
            data_parallel_step(0, 1, torch.device("cpu"),
                               dict(spec, out=spec["out"] + ".one"))
    for name, spec in specs.items():
        ranks = [torch.load(f"{spec['out']}.{r}") for r in range(2)]
        one = None if name == "jax" else torch.load(spec["out"] + ".one.0")
        out[name] = (one, *ranks)
    return out, jax_out


def _leaf_errors(got: dict, want: dict) -> dict:
    def scale(k):
        return want[k.replace("prob.bias", "prob.weight")].double().norm()
    return {k: ((got[k].double() - want[k].double()).norm()
                / scale(k)).item() for k in want}


def _buffer_errors(got: dict, want: dict) -> dict:
    return {k: ((got[k].double() - w.double()).abs().max()
                / w.double().abs().max().clamp(min=1.0)).item()
            for k, w in want.items() if w.is_floating_point()}


@pytest.mark.parametrize("case", [name for name, _ in _cases()])
def test_two_ranks_match_one_process(runs, case):
    results, _ = runs
    one, r0, r1 = results[case]
    grad_tol, buf_tol = BOUNDS[case.split("-")[0]]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-5)
    assert r0["logs"] == r1["logs"]
    for k in ("train/abs_err", "train/acc_1mm", "train/acc_2mm",
              "train/acc_4mm"):
        np.testing.assert_allclose(r0["logs"][k], one["logs"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # DistributedDataParallel leaves every rank the same averaged gradient
    for k, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][k]), k
    grads = _leaf_errors(r0["grads"], one["grads"])
    assert len(grads) == len(one["grads"]) > 0
    worst = max(grads, key=grads.get)
    assert grads[worst] < grad_tol, (worst, grads[worst])
    bufs = _buffer_errors(r0["buffers"], one["buffers"])
    assert any(k.endswith("running_var") for k in bufs)
    worst = max(bufs, key=bufs.get)
    assert bufs[worst] < buf_tol, (worst, bufs[worst])
    for k in bufs:          # synced statistics: equal on both ranks
        assert torch.equal(r0["buffers"][k], r1["buffers"][k]), k


def test_two_ranks_match_jax_on_two_devices(runs):
    """Loss and logs (rtol 1e-4) and BatchNorm statistics (1e-5 abs) of the
    two-rank step against the JAX trainer's on ``make_mesh(2)``, the
    tolerances of tests/test_torch_port_train_step.py."""
    results, jax_out = runs
    _, r0, _ = results["jax"]
    assert r0["logs"].keys() == jax_out["logs"].keys()
    for k, v in jax_out["logs"].items():
        np.testing.assert_allclose(r0["logs"][k], v, rtol=1e-4, err_msg=k)
    n = 0
    for k, want in jax_out["buffers"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(r0["buffers"][k].numpy(),
                                       want.numpy(), atol=1e-5, rtol=0,
                                       err_msg=k)
            n += 1
    assert n == sum(k.endswith("running_var") for k in r0["buffers"]) * 2


class _Rows:
    """Samples whose arrays carry their index, with masks."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"imgs": np.full((2, 3), i, np.float32),
                "masks": {"level_0": np.ones((2, 2), bool)},
                "depths": {"level_0": np.full((2, 2), i, np.float32)},
                "scan_vid": ("s", int(i))}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("split", ["train", "val"])
def test_rank_rows_are_the_jax_loaders_global_batches(split, world):
    """Every rank's rows, stacked in rank order, are the JAX loader's
    global batch with the same seed, for two epochs; the val split's last
    batch padded with mask-zeroed repeats before it is split."""
    ds, b = _Rows(11), 4
    kw = (dict(shuffle=True, seed=3) if split == "train"
          else dict(shuffle=False, drop_last=False, pad_last=True))
    want = JaxLoader(ds, b, num_workers=2, **kw)
    ranks = [DataLoader(ds, b, num_workers=2, rank=r, world=world, **kw)
             for r in range(world)]
    assert all(len(r) == len(want) for r in ranks)
    for _ in range(2):
        got = [list(r) for r in ranks]
        for bi, w in enumerate(want):
            rows = [g[bi] for g in got]
            np.testing.assert_array_equal(
                np.concatenate([r["imgs"] for r in rows]), w["imgs"])
            for key in ("masks", "depths"):
                np.testing.assert_array_equal(
                    np.concatenate([r[key]["level_0"] for r in rows]),
                    w[key]["level_0"])
            assert sum((r["scan_vid"] for r in rows), []) == \
                list(w["scan_vid"])
    if split == "val":
        assert not w["masks"]["level_0"][-1].any()    # a padded row


def test_global_count_loss_is_not_a_mean_of_rank_means(tmp_path):
    """Masks that differ between the ranks: each rank's global-count share,
    averaged over the ranks, is the one-process loss of the global batch
    (and its gradients the global loss's, times N); the mean of the
    ranks' own masked means is not."""
    rng = np.random.RandomState(0)
    shapes = {"level_0": (4, 8, 8), "level_1": (4, 4, 4), "level_2": (4, 2, 2)}
    data = {"results": {}, "depths": {}, "masks": {}}
    for l, shape in enumerate(shapes.values()):
        data["results"][f"depth_{l}"] = (rng.rand(*shape) * 6).astype(
            np.float32)
        data["depths"][f"level_{l}"] = (rng.rand(*shape) * 6).astype(
            np.float32)
        mask = rng.rand(*shape) < 0.9
        mask[2:] &= rng.rand(2, *shape[1:]) < 0.2     # rank 1: few pixels
        data["masks"][f"level_{l}"] = mask
    out = str(tmp_path / "loss")
    spawn(torch_dist_workers.loss_shares, 2, (data, out), cpu=True,
          timeout_s=JOIN_TIMEOUT_S, pg_timeout_s=JOIN_TIMEOUT_S)
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]

    results = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in data["results"].items()}
    loss = sl1_loss(results, {k: torch.from_numpy(v) for k, v in
                              data["depths"].items()},
                    {k: torch.from_numpy(v) for k, v in
                     data["masks"].items()})
    loss.backward()
    whole = float(loss.detach())
    shares = np.mean([r["share"] for r in ranks])
    np.testing.assert_allclose(shares, whole, rtol=1e-6)
    for k, v in results.items():
        got = np.concatenate([r["grads"][k] for r in ranks]) / 2
        np.testing.assert_allclose(got, v.grad.numpy(), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    own = np.mean([r["own"] for r in ranks])
    assert abs(own - whole) > 0.01 * whole, (own, whole)


def test_batch_means_are_the_masked_means():
    """One process: the train logs' means from the metric sums are
    ``abs_error_mean`` and ``acc_threshold_mean`` (held against the JAX
    package in tests/test_torch_port_optim.py)."""
    from casmvsnet_pl_tpu_torch.metrics import (abs_error_mean,
                                                acc_threshold_mean,
                                                batch_means)
    g = torch.Generator().manual_seed(0)
    pred = torch.rand(2, 16, 16, generator=g) * 8
    gt = torch.rand(2, 16, 16, generator=g) * 8
    mask = torch.rand(2, 16, 16, generator=g) < 0.7
    got = batch_means(pred, gt, mask)
    assert got.keys() == {"abs_err", "acc_1mm", "acc_2mm", "acc_4mm"}
    assert torch.equal(got["abs_err"], abs_error_mean(pred, gt, mask))
    for t in (1, 2, 4):
        assert torch.equal(got[f"acc_{t}mm"],
                           acc_threshold_mean(pred, gt, mask, float(t)))
