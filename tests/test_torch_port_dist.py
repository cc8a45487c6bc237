"""Data parallelism of the port (``casmvsnet_pl_tpu_torch/parallel``) on the
CPU: two and four ranks over gloo against one process, and against the JAX
trainer on a two- and a four-device mesh; ``spawn`` and
``initialize_distributed`` refusing more NCCL ranks than cards, and
``spawn`` building the kernel library before CUDA ranks start.

One spawn of two ranks and one of four (``parallel.spawn``, a join
timeout of 240 s) run every step of this file on several ranks; the
one-process steps run here. The steps are one SGD step (lr 1e-2, no
momentum, no weight decay) of ``entry.data_parallel_step``:
  - a global batch of 4 distinct 32x32 plane scenes (``plane_sample``
    0-3), n_depths 8/8/8, in float64 (the model, the batch and BatchNorm's
    sums; the loss is float32 in both) and in float32 for weight seeds 0-2
    (four ranks: seed 0, one row a rank);
  - the JAX comparison: the 2 (4) distinct 64x64 scenes of
    ``tests/test_torch_port_train_step.py``, from the JAX trainer's
    initial weights (``state_dict_from_jax``), against ``MVSTrainer`` on
    ``make_mesh(2)`` (``make_mesh(4)``), the counterpart of
    ``__graft_entry__.py::dryrun_multichip`` and ``scripts/debug_dp.py``.

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
BatchNorm statistics within 3.0e-7. Four ranks are held to the same
bounds.
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
from casmvsnet_pl_tpu_torch.parallel import (initialize_distributed,
                                             spawn)
from casmvsnet_pl_tpu_torch.utils import state_dict_from_jax

import torch_dist_workers

SEEDS = (0, 1, 2)
STEP = dict(batch=4, img_wh=(32, 32), n_depths=(8, 8, 8), lr=1e-2)
BOUNDS = {"float64": (1e-5, 1e-12), "float32": (0.5, 1e-4)}
JOIN_TIMEOUT_S = 240
FOUR_RANKS = ["float64", "float32-0"]


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


def _jax_mesh_step(n: int) -> tuple:
    """(global batch, starting weights, the JAX trainer's step on
    ``make_mesh(n)``: its logs and BatchNorm statistics) on n scenes."""
    kw = dict(optimizer="sgd", lr=1e-2, momentum=0.0, weight_decay=0.0)
    jt = JaxTrainer(JaxCascade(n_depths=(8, 8, 8)), JaxOptimConfig(**kw),
                    steps_per_epoch=10, mesh=make_mesh(n))
    batch = collate(_jax_samples(n))
    jstate = jt.init_state(batch, seed=0)
    start = state_dict_from_jax(*jax.device_get((jstate.params,
                                                 jstate.batch_stats)))
    jstate, jlogs = jt.train_step(jstate, jt._device_batch(batch))
    return batch, start, {
        "logs": {k: float(v) for k, v in jax.device_get(jlogs).items()},
        "buffers": state_dict_from_jax(*jax.device_get(
            (jstate.params, jstate.batch_stats)))}


@pytest.fixture(scope="module")
def one(tmp_path_factory, one_thread):
    """{case: the one-process step} of every case of :func:`_cases`."""
    tmp = tmp_path_factory.mktemp("one")
    out = {}
    for name, spec in _cases():
        data_parallel_step(0, 1, torch.device("cpu"),
                           dict(spec, out=str(tmp / name)))
        out[name] = torch.load(str(tmp / name) + ".0")
    return out


def _spawned_runs(tmp, world: int, cases: list, one: dict) -> tuple:
    """{case: (one process, rank 0, ..., rank world-1)} of saved steps,
    ``cases`` and the JAX comparison's step in one spawn of ``world``
    ranks, and the JAX trainer's step on ``make_mesh(world)``."""
    batch, start, jax_out = _jax_mesh_step(world)
    specs = {name: dict(spec, out=str(tmp / name)) for name, spec in _cases()
             if name in cases}
    specs["jax"] = dict(batch=batch, img_wh=(64, 64), n_depths=(8, 8, 8),
                        lr=1e-2, weights=start, out=str(tmp / "jax"))
    spawn(torch_dist_workers.steps, world, (list(specs.values()),),
          cpu=True, timeout_s=JOIN_TIMEOUT_S, pg_timeout_s=JOIN_TIMEOUT_S)
    out = {}
    for name, spec in specs.items():
        ranks = [torch.load(f"{spec['out']}.{r}") for r in range(world)]
        out[name] = (one.get(name), *ranks)
    return out, jax_out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one):
    """Two ranks: every case, and the JAX comparison on two devices."""
    return _spawned_runs(tmp_path_factory.mktemp("dp"), 2,
                         [name for name, _ in _cases()], one)


@pytest.fixture(scope="module")
def runs4(tmp_path_factory, one):
    """Four ranks (one row each): float64, float32 seed 0, and the JAX
    comparison on four devices."""
    return _spawned_runs(tmp_path_factory.mktemp("dp4"), 4, FOUR_RANKS, one)


def _leaf_errors(got: dict, want: dict) -> dict:
    def scale(k):
        return want[k.replace("prob.bias", "prob.weight")].double().norm()
    return {k: ((got[k].double() - want[k].double()).norm()
                / scale(k)).item() for k in want}


def _buffer_errors(got: dict, want: dict) -> dict:
    return {k: ((got[k].double() - w.double()).abs().max()
                / w.double().abs().max().clamp(min=1.0)).item()
            for k, w in want.items() if w.is_floating_point()}


def _check_ranks_match_one_process(results: dict, case: str) -> None:
    one, *ranks = results[case]
    r0 = ranks[0]
    grad_tol, buf_tol = BOUNDS[case.split("-")[0]]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-5)
    assert all(r["logs"] == r0["logs"] for r in ranks[1:])
    for k in ("train/abs_err", "train/acc_1mm", "train/acc_2mm",
              "train/acc_4mm"):
        np.testing.assert_allclose(r0["logs"][k], one["logs"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # DistributedDataParallel leaves every rank the same averaged gradient
    for r in ranks[1:]:
        for k, g in r0["grads"].items():
            assert torch.equal(g, r["grads"][k]), k
    grads = _leaf_errors(r0["grads"], one["grads"])
    assert len(grads) == len(one["grads"]) > 0
    worst = max(grads, key=grads.get)
    assert grads[worst] < grad_tol, (worst, grads[worst])
    bufs = _buffer_errors(r0["buffers"], one["buffers"])
    assert any(k.endswith("running_var") for k in bufs)
    worst = max(bufs, key=bufs.get)
    assert bufs[worst] < buf_tol, (worst, bufs[worst])
    for r in ranks[1:]:     # synced statistics: equal on every rank
        for k in bufs:
            assert torch.equal(r0["buffers"][k], r["buffers"][k]), k


def _check_ranks_match_jax(results: dict, jax_out: dict,
                           pixel: float = 0.0) -> None:
    """Loss and logs (rtol 1e-4) and BatchNorm statistics (1e-5 abs) of the
    ranks' step against the JAX trainer's on its mesh, the tolerances of
    tests/test_torch_port_train_step.py; the accuracies, counts of pixels
    under a threshold, also within ``pixel`` (one pixel's share)."""
    _, r0, *_ = results["jax"]
    assert r0["logs"].keys() == jax_out["logs"].keys()
    for k, v in jax_out["logs"].items():
        np.testing.assert_allclose(
            r0["logs"][k], v, rtol=1e-4,
            atol=pixel if k.startswith("train/acc") else 0.0, err_msg=k)
    n = 0
    for k, want in jax_out["buffers"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(r0["buffers"][k].numpy(),
                                       want.numpy(), atol=1e-5, rtol=0,
                                       err_msg=k)
            n += 1
    assert n == sum(k.endswith("running_var") for k in r0["buffers"]) * 2


@pytest.mark.parametrize("case", [name for name, _ in _cases()])
def test_two_ranks_match_one_process(runs, case):
    _check_ranks_match_one_process(runs[0], case)


@pytest.mark.parametrize("case", FOUR_RANKS)
def test_four_ranks_match_one_process(runs4, case):
    """Four ranks, one row each, against one process, to the bounds of two
    ranks; the four ranks' gradients and statistics equal to the bit."""
    _check_ranks_match_one_process(runs4[0], case)


def test_two_ranks_match_jax_on_two_devices(runs):
    _check_ranks_match_jax(*runs)


def test_four_ranks_match_jax_on_four_devices(runs4):
    """The counterpart of ``__graft_entry__.py::dryrun_multichip``: the
    port's four ranks against the JAX trainer on ``make_mesh(4)``. The
    accuracies may differ by one pixel of the 4x64x64: one pixel's error
    sits within rounding of the 2 mm threshold here (loss within 1.7e-7,
    abs_err 7.2e-8, acc_2mm one pixel, 4.6e-4 relative, measured)."""
    _check_ranks_match_jax(*runs4, pixel=1.0 / (4 * 64 * 64))


def test_nccl_refuses_more_ranks_than_cards(monkeypatch, tmp_path):
    """``spawn`` raises ``ValueError`` when NCCL ranks outnumber the cards,
    and ``initialize_distributed`` when this rank's index on its host
    (``LOCAL_RANK``, else the rank) has no card, before any rank starts or
    any process group forms. A world that spans hosts (more ranks than this
    host's cards, ``LOCAL_WORLD_SIZE`` unset) joins when each rank's local
    index has a card; gloo ranks may share a card."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from casmvsnet_pl_tpu_torch.kernels import cost_volume_cuda

    started, built = [], []
    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(mp, "start_processes",
                        lambda *a, **k: started.append(k) or _Ended())
    monkeypatch.setattr(cost_volume_cuda, "build", lambda: built.append(1))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: started.append(k))
    with pytest.raises(ValueError, match="2 NCCL ranks on this host, 1 "
                                         "cards visible"):
        spawn(torch_dist_workers.steps, 2, ([],))
    with pytest.raises(ValueError, match="NCCL"):
        spawn(torch_dist_workers.steps, 2, ([],), backend="nccl")
    init = "file://" + str(tmp_path / "store")
    for kw in (dict(device=torch.device("cuda", 1)), dict(backend="nccl")):
        with pytest.raises(ValueError, match="NCCL rank 1 has index 1 on "
                                             "this host"):
            initialize_distributed(1, 2, init, **kw)
    monkeypatch.setenv("LOCAL_RANK", "1")       # torchrun's, 2 on one card
    with pytest.raises(ValueError, match="NCCL rank 1 has index 1"):
        initialize_distributed(1, 2, "env://", device=torch.device("cuda", 1))
    assert not started and not built
    monkeypatch.setenv("WORLD_SIZE", "8")       # 8 ranks across hosts
    monkeypatch.setenv("LOCAL_RANK", "0")
    initialize_distributed(4, 8, "env://", device=torch.device("cuda", 0))
    monkeypatch.delenv("LOCAL_RANK")
    initialize_distributed(0, 8, "env://", device=torch.device("cuda", 0))
    assert [(k["rank"], k["world_size"]) for k in started] == [(4, 8),
                                                                (0, 8)]
    spawn(torch_dist_workers.steps, 2, ([],), backend="gloo")
    initialize_distributed(1, 2, init, backend="gloo",
                           device=torch.device("cuda", 0))
    assert len(started) == 4


class _Ended:
    """``start_processes``' context of ranks that have all ended."""

    processes = ()

    def join(self, timeout=None):
        return True


def test_spawn_builds_the_kernels_before_cuda_ranks_start(monkeypatch):
    """CUDA ranks find the kernel library built: ``spawn`` builds it before
    it starts them; CPU ranks build nothing."""
    import torch.multiprocessing as mp

    from casmvsnet_pl_tpu_torch.kernels import cost_volume_cuda

    order = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(cost_volume_cuda, "build",
                        lambda: order.append("build"))
    monkeypatch.setattr(mp, "start_processes", lambda *a, **k: order.append(
        ("start", k["nprocs"])) or _Ended())
    spawn(torch_dist_workers.steps, 4, ([],), timeout_s=5)
    assert order == ["build", ("start", 4)]
    spawn(torch_dist_workers.steps, 2, ([],), cpu=True, timeout_s=5)
    assert order == ["build", ("start", 4), ("start", 2)]


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
