"""The port's data-parallel training on several NVIDIA H100s of one host.

The multi-card companion of ``chip_smoke.py``, which stays on one card:

    python3 multicard_smoke.py                 # every visible card, 2 to 4

It exits 1 unless at least two cards are visible. Every check raises and
none is caught; a hang costs at most ``TIMEOUT_S`` (every collective and
every join of the ranks) or ``CLI_TIMEOUT_S`` (the CLI runs). It prints
every card's name and power limit, ``nvidia-smi topo -m`` and torch's
NCCL version, then:

- M1: one f32 SGD step (``scripts/debug_dp_torch.py``, phase 36's spec:
  global batch ``DP_BATCH`` of 640x512x3 plane scenes, n_depths 8/32/48,
  cuDNN's deterministic algorithms) on 2 ranks on 2 cards and on 4 ranks
  on 4 cards over NCCL, each against one process on card 0
  (``chip_smoke.dp_compare``: the loss, every gradient leaf, the
  BatchNorm statistics, the ranks' gradients equal to the bit, K1 and K2
  launched on every rank);
- M2: ``M2_STEPS`` bf16 Adam steps at ``PER_CARD`` samples a card on
  every card: every loss finite and falling, the parameters and buffers
  equal to the bit across the ranks at the end, and the first step's
  Python-side all-reduces (SyncBN's two a BatchNorm layer, the loss's mask
  counts, the logged metric sums and loss) the same on every rank, in the
  same order, all float32;
- M3: ``train_torch.py --num_devices N`` for ``CLI_EPOCHS`` bf16 epochs
  on a synthetic DTU tree at ``PER_CARD`` samples a card: one
  ``last.ckpt`` and one events file; its val metrics against one
  process's validation of that ``last.ckpt`` at the per-card batch (the
  same forwards); a one-process resume from it and a warm start; then the
  same run under ``torchrun`` (``env://``);
- M4: weak scaling of the bf16 Adam step at ``PER_CARD`` samples a card
  on 1, 2 and 4 cards: ms a step (CUDA events, median and range of
  ``M4_STEPS`` after ``M4_WARMUP``) on rank 0 and on the slowest rank,
  samples/s, efficiency against N times one card, peak memory a card, and
  from ``torch.profiler`` on rank 0 the kernels a step (count, time, busy
  share), the NCCL kernels' count and time, and the kernels that grew
  most against one card.

``python3 multicard_smoke.py train <train_torch.py flags>`` runs
``train_torch.main`` on the tree M3 writes (:class:`SmokeDTU`): the
process that M3 starts with ``--num_devices`` and under ``torchrun``.
"""
from __future__ import annotations

import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke
from casmvsnet_pl_tpu_torch.data import DTUDataset
from casmvsnet_pl_tpu_torch.kernels import (cost_volume_cuda, launch_counts,
                                            reset_launches)

DEVICE = "cuda"
IMG_WH = chip_smoke.IMG_WH
PER_CARD = 2            # samples a card in M2-M4: the B=2 step of chip_smoke
TRAIN_DTYPE = torch.bfloat16
M2_STEPS = 20
M4_WARMUP = 5
M4_STEPS = 30
M4_PROFILE_STEPS = 3
TIMEOUT_S = 600
CLI_TIMEOUT_S = 900
CLI_FLAGS = ("--precision", "bf16")
# M3's epochs: 4 x 4 steps of 8 samples leave accuracies above 0, so that
# their comparison with one process's validation checks something
CLI_EPOCHS = 4
VAL_RTOL = 1e-6         # M3's val metrics against one process's
# M3's tree: chip_smoke.py phase 33's
TRAIN_NATIVE_WH = chip_smoke.TRAIN_NATIVE_WH
TRAIN_CROP = chip_smoke.TRAIN_CROP
TRAIN_FOCAL = chip_smoke.TRAIN_FOCAL
TRAIN_SCANS = chip_smoke.TRAIN_SCANS
TRAIN_CAMS = 5
SCRIPT = os.path.abspath(__file__)
VAL_TAGS = ("val/abs_err", "val/acc_1mm", "val/acc_2mm", "val/acc_4mm")


def report() -> str:
    """Print torch's and NCCL's versions, every card's name and power limit
    and the cards' topology; return the cards' label for every number."""
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))} count "
          f"{torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = [line.strip() for line in smi.stdout.strip().splitlines()]
    for line in lines:
        print(line)
    # the topology is informative only: nvidia-smi in a container may refuse it
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    print(f"nvidia-smi topo -m (exit {topo.returncode}):\n"
          f"{(topo.stdout + topo.stderr).rstrip()}")
    n = torch.cuda.device_count()
    print("peer access (torch.cuda.can_device_access_peer), row to column: "
          + "; ".join(" ".join(str(int(i == j or torch.cuda.
                                       can_device_access_peer(i, j)))
                               for j in range(n)) for i in range(n)))
    if len(set(lines)) == 1:
        return f"{len(lines)} x {lines[0]}"
    return "; ".join(lines)


def over(world: int) -> str:
    return (f"on {world} cards over NCCL" if DEVICE == "cuda"
            else f"on the CPU over gloo ({world} processes)")


def worlds(cards: int) -> list[int]:
    return [n for n in (2, 4) if n <= cards]


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --- M1: one f32 SGD step, NCCL ranks against one process -------------------

def one_step(work: str, cards: int, card: str) -> None:
    """``scripts/debug_dp_torch.py`` on 2 and on 4 ranks (phase 36's spec),
    held to ``chip_smoke.dp_compare``'s bounds."""
    sys.path.append(os.path.join(os.path.dirname(SCRIPT), "scripts"))
    import debug_dp_torch

    W, H = IMG_WH
    # data_parallel_step turns TF32 off in this process; M3's one-process
    # validation must run as the ranks do
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    for world in worlds(cards):
        got = debug_dp_torch.main(
            ["--ranks", str(world), "--img_wh", str(W), str(H), "--n_depths",
             *map(str, chip_smoke.DP_N_DEPTHS)]
            + (["--cpu"] if DEVICE == "cpu" else []))
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
        chip_smoke.dp_compare(got["ranks"], got["spec"], over(world),
                              got["spawned"], got["reference"], card)
        del got
        if DEVICE == "cuda":
            torch.cuda.empty_cache()


# --- M2: bf16 Adam replicas --------------------------------------------------

def replica_rank(rank: int, world: int, device, spec: dict) -> None:
    """``spec["steps"]`` bf16 Adam steps of ``train_entry`` as one rank;
    saves the losses, the parameters and buffers at the end, the first
    step's Python-side all-reduces (dtype, shape) and the launches."""
    import torch.distributed as dist

    from casmvsnet_pl_tpu_torch.entry import train_entry
    from casmvsnet_pl_tpu_torch.models.blocks import _FlaxBatchNorm

    trainer, state, batch = train_entry(
        device, spec["dtype"], batch=PER_CARD * world, img_wh=spec["img_wh"],
        n_depths=spec["n_depths"], optimizer="adam", lr=1e-3)
    reset_launches()
    issued = []
    all_reduce = dist.all_reduce

    def recording(t, *args, **kwargs):
        issued.append((str(t.dtype), tuple(t.shape)))
        return all_reduce(t, *args, **kwargs)

    dist.all_reduce = recording
    try:
        state, logs = trainer.train_step(state, batch)
    finally:
        dist.all_reduce = all_reduce
    losses = [logs["train/loss"]]
    for _ in range(spec["steps"] - 1):
        state, logs = trainer.train_step(state, batch)
        losses.append(logs["train/loss"])
    synchronize(device)
    torch.save({
        "losses": [float(x) for x in losses], "issued": issued,
        "batch_norms": sum(isinstance(m, _FlaxBatchNorm)
                           for m in state.model.modules()),
        "params": {k: p.detach().cpu() for k, p in
                   state.model.named_parameters()},
        "buffers": {k: b.detach().cpu() for k, b in
                    state.model.named_buffers()},
        "launches": launch_counts()}, f"{spec['out']}.{rank}")


def replicas(work: str, cards: int, card: str) -> None:
    from casmvsnet_pl_tpu_torch.parallel import spawn

    world = min(cards, 4)
    spec = dict(img_wh=IMG_WH, n_depths=chip_smoke.DP_N_DEPTHS,
                dtype=TRAIN_DTYPE, steps=M2_STEPS,
                out=os.path.join(work, "m2"))
    t0 = time.perf_counter()
    spawn(replica_rank, world, (spec,), cpu=DEVICE == "cpu",
          timeout_s=TIMEOUT_S, pg_timeout_s=TIMEOUT_S)
    spawned = time.perf_counter() - t0
    ranks = [torch.load(f"{spec['out']}.{r}") for r in range(world)]
    first = ranks[0]
    params = all(torch.equal(first["params"][k], r["params"][k])
                 for r in ranks[1:] for k in first["params"])
    buffers = all(torch.equal(first["buffers"][k], r["buffers"][k])
                  for r in ranks[1:] for k in first["buffers"])
    issued = first["issued"]
    same_order = all(r["issued"] == issued for r in ranks[1:])
    dtypes = sorted({d for d, _ in issued})
    # SyncBN's forward and backward a layer, the loss's mask count a level,
    # the logged metric sums and the logged loss
    want = 2 * first["batch_norms"] + 3 + 1 + 1
    W, H = IMG_WH
    print(f"M2 bf16 Adam lr 1e-3, {M2_STEPS} steps on one global batch of "
          f"{PER_CARD * world} ({PER_CARD} a rank) at {W}x{H}x3, {world} "
          f"ranks {over(world)} ({spawned!r} s with the ranks' start): rank "
          f"0 losses {first['losses']!r}; parameters equal to the bit "
          f"across the ranks {params}, buffers {buffers}; the first step's "
          f"all-reduces from Python: {len(issued)} (expected {want}: "
          f"{first['batch_norms']} BatchNorm layers), dtypes {dtypes}, the "
          f"same on every rank in the same order {same_order}; launches "
          + ", ".join(f"rank {r} {x['launches']}" for r, x in
                      enumerate(ranks)) + f" [{card}]")
    for r in ranks:
        chip_smoke.expect_counts(
            r["launches"], chip_smoke.scaled(chip_smoke.DEFAULT_STEP,
                                             M2_STEPS), "M2 rank")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"M2: non-finite loss {r['losses']}")
    if not first["losses"][-1] < first["losses"][0]:
        raise AssertionError("M2: the loss did not fall")
    if not (params and buffers):
        raise AssertionError("M2: the replicas differ")
    if not (same_order and len(issued) == want
            and dtypes == ["torch.float32"]):
        raise AssertionError(f"M2: all-reduces {issued}")


# --- M3: the CLI, spawned and under torchrun ---------------------------------

class SmokeDTU(DTUDataset):
    """``DTUDataset`` on the tree of :func:`write_tree`, which carries its
    own rig (``rig.json``) and split lists (``lists/``), so that the class
    pickles by name into the ranks at any tree size."""

    def __init__(self, root_dir: str, split: str, **kw):
        with open(os.path.join(root_dir, "rig.json")) as f:
            rig = json.load(f)
        self.NATIVE_WH = tuple(rig["native_wh"])
        self.DEPTH_CROP = tuple(tuple(x) for x in rig["depth_crop"])
        self.N_CAMS = rig["n_cams"]
        self.LISTS_DIR = os.path.join(root_dir, "lists")
        super().__init__(root_dir, split, **kw)


def write_tree(work: str) -> str:
    """chip_smoke.py phase 33's synthetic DTU training tree, with its rig
    and lists inside; returns its root."""
    from casmvsnet_pl_tpu_torch.data import write_dtu_tree

    tree = os.path.join(work, "tree")
    write_dtu_tree(tree, scans=tuple(TRAIN_SCANS.values()),
                   n_cams=TRAIN_CAMS, img_wh=IMG_WH,
                   native_wh=TRAIN_NATIVE_WH, focal=TRAIN_FOCAL,
                   depth_crop=TRAIN_CROP)
    os.makedirs(os.path.join(tree, "lists"))
    for split, scan in TRAIN_SCANS.items():
        with open(os.path.join(tree, "lists", f"{split}.txt"), "w") as f:
            f.write(scan + "\n")
    with open(os.path.join(tree, "rig.json"), "w") as f:
        json.dump({"native_wh": TRAIN_NATIVE_WH, "depth_crop": TRAIN_CROP,
                   "n_cams": TRAIN_CAMS}, f)
    return tree


def cli_flags(tree: str, world: int, exp_name: str, *flags) -> list[str]:
    return ["--root_dir", tree, "--batch_size", str(PER_CARD * world),
            "--optimizer", "adam", "--lr", "1e-3", "--num_epochs",
            str(CLI_EPOCHS), "--exp_name", exp_name, *CLI_FLAGS, *flags]


def run_bounded(cmd: list[str], cwd: str) -> str:
    """Run ``cmd`` in ``cwd`` in a session of its own; after
    ``CLI_TIMEOUT_S`` every process of the session is killed. Raises
    unless it exits 0; returns its standard output."""
    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                             f"{err[-6000:]}")
    return out


def run_files(run_dir: str, exp_name: str, out: str, world: int):
    """The run's ``last.ckpt`` and its val metrics from its one events file;
    rank 0 alone printed."""
    from casmvsnet_pl_tpu_torch.utils.tensorboard import read_events, scalars

    ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpts", exp_name)))
    logs = os.listdir(os.path.join(run_dir, "logs", exp_name))
    said = [line for line in out.splitlines()
            if line.startswith("number of parameters")]
    if ckpts.count("last.ckpt") != 1 or len(logs) != 1:
        raise AssertionError(f"{exp_name}: checkpoints {ckpts}, events {logs}")
    if len(said) != 1 or f"on {world} device(s)" not in said[0]:
        raise AssertionError(f"{exp_name}: printed {said}")
    tags = scalars(read_events(os.path.join(run_dir, "logs", exp_name,
                                            logs[0])))
    metrics = {k: tags[k][-1][1] for k in VAL_TAGS}
    return os.path.join(run_dir, "ckpts", exp_name, "last.ckpt"), metrics, \
        ckpts


def one_process_val(tree: str, ckpt: str, hp) -> dict:
    """Validation of ``ckpt`` in this process at ``PER_CARD`` samples a
    batch, so that each forward is one rank's."""
    from casmvsnet_pl_tpu_torch.data import DataLoader
    from casmvsnet_pl_tpu_torch.engine import MVSTrainer
    from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
    from casmvsnet_pl_tpu_torch.utils import OptimConfig

    ds = SmokeDTU(tree, "val", n_views=hp.n_views, levels=hp.levels,
                  depth_interval=hp.depth_interval)
    loader = DataLoader(ds, PER_CARD, shuffle=False, drop_last=False,
                        pad_last=True, num_workers=hp.num_workers)
    model = CascadeMVSNet(n_depths=tuple(hp.n_depths),
                          interval_ratios=tuple(hp.interval_ratios),
                          num_groups=hp.num_groups, sampling=hp.sampling)
    trainer = MVSTrainer(
        model, OptimConfig(optimizer=hp.optimizer, lr=hp.lr),
        steps_per_epoch=1, device=torch.device(DEVICE, 0),
        dtype=torch.bfloat16 if hp.precision == "bf16" or hp.use_amp
        else torch.float32, levels=hp.levels)
    return trainer.validate(trainer.restore_state(ckpt), loader)


def cli(work: str, cards: int, card: str) -> None:
    import train_torch
    from casmvsnet_pl_tpu_torch.opt import get_opts
    from casmvsnet_pl_tpu_torch.utils import load_checkpoint

    world = min(cards, 4)
    t0 = time.perf_counter()
    tree = write_tree(work)
    spawned_dir, torchrun_dir = (os.path.join(work, d)
                                 for d in ("spawn", "torchrun"))
    os.makedirs(spawned_dir)
    os.makedirs(torchrun_dir)
    t1 = time.perf_counter()
    out = run_bounded([sys.executable, SCRIPT, "train",
                       *cli_flags(tree, world, "multi"), "--num_devices",
                       str(world)], spawned_dir)
    t2 = time.perf_counter()
    ckpt, metrics, ckpts = run_files(spawned_dir, "multi", out, world)
    hp = get_opts(cli_flags(tree, world, "multi"))
    one = one_process_val(tree, ckpt, hp)
    errors = {k: abs(metrics[k] - one[k]) / max(abs(one[k]), 1e-30)
              for k in VAL_TAGS}
    print(f"M3 train_torch.py --num_devices {world} --batch_size "
          f"{PER_CARD * world}, {CLI_EPOCHS} epochs {over(world)} "
          f"({t2 - t1!r} s, the "
          f"tree written in {t1 - t0!r} s): checkpoints {ckpts}; val "
          f"{metrics!r}; one process's validation of its last.ckpt at "
          f"batch {PER_CARD}: {one!r}; relative differences {errors!r} "
          f"(bound {VAL_RTOL}) [{card}]")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"M3: val metrics {metrics}")
    if not max(errors.values()) <= VAL_RTOL:
        raise AssertionError(f"M3: val metrics differ by {errors}")

    cwd = os.getcwd()
    os.chdir(spawned_dir)
    try:
        steps = None
        for what, epochs in (("--resume_path", "1"), ("--ckpt_path", "0")):
            trainer, state = train_torch.main(get_opts(cli_flags(
                tree, world, what.strip("-"), what, ckpt, "--num_devices",
                "1", "--num_epochs", epochs)), SmokeDTU)
            if what == "--resume_path":
                steps = state.step
                resumed = trainer.epoch_metrics[-1]
            else:
                saved = load_checkpoint(ckpt)["params"]
                loaded = all(torch.equal(p.detach().cpu(), saved[k])
                             for k, p in state.model.named_parameters())
            del trainer, state
    finally:
        os.chdir(cwd)
    per_epoch = len(SmokeDTU(tree, "train")) // (PER_CARD * world)
    print(f"M3 one process --resume_path last.ckpt, one more epoch: step "
          f"{steps} (after {per_epoch} a epoch), val {resumed!r}; "
          f"--ckpt_path last.ckpt: every parameter equal to the "
          f"checkpoint's {loaded}")
    if steps != (CLI_EPOCHS + 1) * per_epoch or not loaded or not all(
            math.isfinite(v) for v in resumed.values()):
        raise AssertionError("M3: the one-process resume or warm start")

    t3 = time.perf_counter()
    out = run_bounded([sys.executable, "-m", "torch.distributed.run",
                       "--standalone", "--nproc_per_node", str(world), SCRIPT,
                       "train", *cli_flags(tree, world, "torchrun")],
                      torchrun_dir)
    _, metrics, ckpts = run_files(torchrun_dir, "torchrun", out, world)
    print(f"M3 torchrun --nproc_per_node {world} train_torch.py, "
          f"{CLI_EPOCHS} epochs ({time.perf_counter() - t3!r} s): "
          f"checkpoints {ckpts}; val "
          f"{metrics!r} [{card}]")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"M3 torchrun: val metrics {metrics}")


# --- M4: weak scaling ------------------------------------------------------

def scaling_rank(rank: int, world: int, device, spec: dict) -> None:
    """The bf16 Adam step at ``PER_CARD`` samples a rank: warm-up, then
    each of ``spec["steps"]`` steps timed (CUDA events on the card), peak
    memory, and on rank 0 ``torch.profiler`` over ``spec["profile"]``
    more steps (the other ranks step alongside)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from casmvsnet_pl_tpu_torch.entry import train_entry

    cuda = device.type == "cuda"
    trainer, state, batch = train_entry(
        device, spec["dtype"], batch=PER_CARD * world, img_wh=spec["img_wh"],
        n_depths=spec["n_depths"], optimizer="adam", lr=1e-3)
    for _ in range(spec["warmup"]):
        state, _ = trainer.train_step(state, batch)
    synchronize(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(spec["steps"] + 1)]
    t0 = time.perf_counter()
    host = [t0]
    for i in range(spec["steps"]):
        if cuda:
            marks[i].record()
        state, _ = trainer.train_step(state, batch)
        host.append(time.perf_counter())
    if cuda:
        marks[-1].record()
    synchronize(device)
    wall = (time.perf_counter() - t0) * 1e3 / spec["steps"]
    if cuda:
        ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    else:
        ms = [(b - a) * 1e3 for a, b in zip(host[:-1], host[1:])]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kernels, profiled = {}, 0.0
    if rank == 0:
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with torch.profiler.profile(activities=activities) as prof:
            t1 = time.perf_counter()
            for _ in range(spec["profile"]):
                state, _ = trainer.train_step(state, batch)
            synchronize(device)
            profiled = (time.perf_counter() - t1) * 1e3 / spec["profile"]
        events = prof.key_averages()
        # annotations (DDP's forward, "nccl:all_reduce") also appear on
        # the device, spanning kernels: keep kernels only
        host = {e.key for e in events if e.device_type != DeviceType.CUDA}
        for e in events:
            if e.device_type != DeviceType.CUDA or e.key in host or \
                    getattr(e, "is_user_annotation", False):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels[e.key[:90]] = (e.count / spec["profile"],
                                   us / 1e3 / spec["profile"])
    else:
        for _ in range(spec["profile"]):
            state, _ = trainer.train_step(state, batch)
        synchronize(device)
    torch.save({"ms": ms, "wall": wall, "peak": peak, "kernels": kernels,
                "profiled_ms": profiled}, f"{spec['out']}.{rank}")


def scaling(work: str, cards: int, card: str) -> list[dict]:
    from casmvsnet_pl_tpu_torch.parallel import spawn

    rows = []
    for world in [1] + worlds(cards):
        spec = dict(img_wh=IMG_WH, n_depths=chip_smoke.DP_N_DEPTHS,
                    dtype=TRAIN_DTYPE, warmup=M4_WARMUP, steps=M4_STEPS,
                    profile=M4_PROFILE_STEPS,
                    out=os.path.join(work, f"m4.w{world}"))
        spawn(scaling_rank, world, (spec,), cpu=DEVICE == "cpu",
              timeout_s=TIMEOUT_S, pg_timeout_s=TIMEOUT_S)
        ranks = [torch.load(f"{spec['out']}.{r}") for r in range(world)]
        medians = [statistics.median(r["ms"]) for r in ranks]
        ms = medians[0]
        kernels = ranks[0]["kernels"]
        nccl = {k: v for k, v in kernels.items()
                if k.lower().startswith("nccl")}
        row = {"cards": world, "ms": ms, "slowest_ms": max(medians),
               "min_ms": min(ranks[0]["ms"]), "max_ms": max(ranks[0]["ms"]),
               "wall_ms": ranks[0]["wall"],
               "samples_s": PER_CARD * world * 1000.0 / ms,
               "peak_gib": max(r["peak"] for r in ranks) / 2 ** 30,
               "kernel_ms": sum(t for _, t in kernels.values()),
               "launches": sum(n for n, _ in kernels.values()),
               "nccl_count": sum(n for n, _ in nccl.values()),
               "nccl_ms": sum(t for _, t in nccl.values())}
        row["busy"] = row["kernel_ms"] / max(ranks[0]["profiled_ms"], 1e-9)
        row["efficiency"] = row["samples_s"] / (world * rows[0]["samples_s"]) \
            if rows else 1.0
        rows.append(row)
        W, H = IMG_WH
        timer = "CUDA events" if DEVICE == "cuda" else "host clock"
        print(f"M4 bf16 Adam step, {PER_CARD} samples a card at {W}x{H}x3, "
              f"{world} card(s) ({timer}, median of {M4_STEPS} after "
              f"{M4_WARMUP}): rank 0 {ms!r} ms (range {row['min_ms']!r} to "
              f"{row['max_ms']!r}; wall {row['wall_ms']!r} ms a step), "
              f"every rank's median {medians!r}, {row['samples_s']!r} "
              f"samples/s, efficiency {row['efficiency']!r}, peak memory "
              f"{row['peak_gib']!r} GiB a card; on rank 0 a step "
              f"(torch.profiler, {M4_PROFILE_STEPS} steps): "
              f"{row['launches']!r} kernels, {row['kernel_ms']!r} ms, busy "
              f"{100 * row['busy']!r} % of {ranks[0]['profiled_ms']!r} ms; "
              f"NCCL {row['nccl_count']!r} kernels {row['nccl_ms']!r} ms "
              f"{nccl!r} [{card}]")
        if world == 1:
            one_card = kernels
        else:
            grew = sorted(((t - one_card.get(k, (0, 0.0))[1],
                            n - one_card.get(k, (0, 0.0))[0], k)
                           for k, (n, t) in kernels.items()), reverse=True)
            print(f"M4 {world} cards against one, rank 0's kernels a step "
                  f"that grew most (ms, launches, name): "
                  + "; ".join(f"{dt!r} ms {dn!r} {k}" for dt, dn, k in
                              grew[:10]))
        if not all(math.isfinite(x) and x > 0 for x in ranks[0]["ms"]):
            raise AssertionError(f"M4: step times {ranks[0]['ms']}")
    print("M4 weak scaling " + json.dumps(rows))
    return rows


PHASES = {"M1": one_step, "M2": replicas, "M3": cli, "M4": scaling}


def main() -> int:
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print(f"multicard_smoke.py: needs at least two CUDA cards, {cards} "
              f"visible", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = report()
    chip_smoke.build_kernel(cost_volume_cuda)
    with tempfile.TemporaryDirectory(prefix="multicard_smoke_") as work:
        for name, phase in PHASES.items():
            t = time.perf_counter()
            phase(work, cards, card)
            print(f"{name}: {time.perf_counter() - t!r} s")
    print(f"multicard_smoke.py: {', '.join(PHASES)} passed in "
          f"{time.perf_counter() - t0!r} s [{card}]")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["train"]:
        import train_torch
        from casmvsnet_pl_tpu_torch.opt import get_opts
        train_torch.main(get_opts(sys.argv[2:]), SmokeDTU)
        sys.exit(0)
    sys.exit(main())
