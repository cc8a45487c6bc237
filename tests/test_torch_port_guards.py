"""Cheap guards on the port: no JAX, PIL, OpenCV or tensorboardX inside it
or in ``eval_torch.py`` and ``train_torch.py`` (nor msgpack or matplotlib
in the package, ``convert_ckpt_torch.py``, ``demo_torch.py`` and the
measurement scripts ``bench_torch.py`` and ``scripts/*_torch.py``, and the
data-parallel checks ``multicard_smoke.py`` and
``scripts/debug_dp_torch.py``), no CPU fallback on the card path, and its
main paths
(inference and a train step, default and quad configurations, the
packed-quad warp, and the probes' plain versions) run end to end on the
CPU at a small size without launching a kernel."""
import ast
import math
import os
import subprocess
import sys

import pytest
import torch

from casmvsnet_pl_tpu_torch.kernels import launch_counts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


BANNED = ('jax', 'jaxlib', 'flax', 'PIL', 'cv2', 'tensorboardX',
          'casmvsnet_pl_tpu')
# the port reads the JAX package's msgpack and draws the demo itself
BANNED_TOO = BANNED + ('msgpack', 'matplotlib')


def test_package_imports_no_jax_pil_or_cv2():
    """No JAX, PIL, OpenCV or tensorboardX in any module of the package."""
    code = (
        "import pkgutil, sys, casmvsnet_pl_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: __import__(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BANNED_TOO!r})\n"
        "assert len(mods) >= 60, mods\n"
        "for m in ('opt', 'parallel.dist', 'parallel.sync_bn', "
        "'utils.tensorboard', 'utils.visualization', 'data.jpeg', "
        "'data.blendedmvs', 'data.tanks', 'utils.msgpack', "
        "'utils.torch_convert', 'utils.profiling', 'utils.flops'):\n"
        "    assert 'casmvsnet_pl_tpu_torch.' + m in mods, m\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert "casmvsnet_pl_tpu_torch.entry" in names
    bad = [m for m in names if m.split(".")[0] in BANNED_TOO]
    assert not bad, bad


def test_entry_points_default_to_the_card():
    """The port runs on the card unless its caller asks for the CPU."""
    import inspect

    from casmvsnet_pl_tpu_torch.engine import MVSTrainer
    from casmvsnet_pl_tpu_torch.entry import entry, train_entry

    for fn in (entry, train_entry, MVSTrainer.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_entry_runs_on_cpu_at_small_size():
    from casmvsnet_pl_tpu_torch.entry import entry
    from casmvsnet_pl_tpu_torch.kernels import cost_volume_cuda

    fn, args = entry("cpu", batch=2, img_wh=(64, 32))
    before = cost_volume_cuda.launches
    depth, conf = fn(*args)
    assert cost_volume_cuda.launches == before
    assert depth.shape == (2, 32, 64) and conf.shape == (2, 8, 16)
    assert depth.dtype == conf.dtype == torch.float32
    assert torch.isfinite(depth).all() and torch.isfinite(conf).all()
    assert 0 <= conf.min() and conf.max() <= 1
    # the two samples are the same scene: the batch axis must not mix them
    torch.testing.assert_close(depth[0], depth[1])


def test_train_entry_steps_on_cpu_without_kernels():
    from casmvsnet_pl_tpu_torch.entry import train_entry
    from casmvsnet_pl_tpu_torch.kernels import (cost_volume_bwd_cuda,
                                                cost_volume_cuda)

    trainer, state, batch = train_entry("cpu", img_wh=(64, 32),
                                        n_depths=(8, 8, 8))
    assert trainer.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert batch["imgs"].shape == (2, 3, 32, 64, 3)
    launches = cost_volume_cuda.launches, cost_volume_bwd_cuda.launches
    state, logs = trainer.train_step(state, batch)
    assert (cost_volume_cuda.launches,
            cost_volume_bwd_cuda.launches) == launches == (0, 0)
    assert state.step == 1
    assert sorted(logs) == ["lr", "train/abs_err", "train/acc_1mm",
                            "train/acc_2mm", "train/acc_4mm", "train/loss"]
    assert all(math.isfinite(float(v)) for v in logs.values())
    grads = [p.grad for p in state.model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_bwd_kernel_refuses_cpu_tensors():
    from casmvsnet_pl_tpu_torch.kernels import cost_volume_bwd_cuda

    feats = torch.rand(1, 3, 8, 8, 8)
    proj = torch.zeros(1, 2, 3, 4)
    dv = torch.ones(1, 8, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cost_volume_bwd_cuda(feats, proj, dv, torch.zeros(1, 8, 8, 8, 8))
    assert cost_volume_bwd_cuda.launches == 0


def test_launch_registry_is_every_exported_kernel():
    """The library's registry holds exactly the ``*_cuda`` wrappers that
    ``kernels/__init__.py`` exports, each bound to it, with a count."""
    from casmvsnet_pl_tpu_torch import kernels

    exported = {n: getattr(kernels, n) for n in dir(kernels)
                if n.endswith("_cuda")}
    registry = kernels.LIBRARY.kernels
    assert set(registry) == set(exported)
    assert all(registry[n] is k and k.library is kernels.LIBRARY
               and k.name == n for n, k in exported.items())
    assert all(isinstance(k.launches, int) for k in registry.values())
    assert set(launch_counts()) == set(exported)


def test_reset_launches_zeroes_every_count():
    from casmvsnet_pl_tpu_torch import kernels

    registry = kernels.LIBRARY.kernels
    saved = {n: k.launches for n, k in registry.items()}
    try:
        for i, kernel in enumerate(registry.values()):
            kernel.launches = i + 1
        assert launch_counts() == {n: i + 1 for i, n in enumerate(registry)}
        kernels.reset_launches()
        assert launch_counts() == dict.fromkeys(registry, 0)
        assert all(k.launches == 0 for k in registry.values())
    finally:
        for n, count in saved.items():
            registry[n].launches = count


def test_kernels_register_by_name_with_their_own_library():
    """A kernel of another library, as ``probes/k1.py``'s K1 of an earlier
    tree is, stays out of the port's counts; a second kernel of a name
    already bound to a library raises. Construction builds nothing."""
    from casmvsnet_pl_tpu_torch.kernels.cost_volume import CostVolumeKernel
    from casmvsnet_pl_tpu_torch.kernels.library import (LIBRARY,
                                                        KernelLibrary)
    from casmvsnet_pl_tpu_torch.probes import k1

    before = launch_counts()
    other = KernelLibrary()
    parent = CostVolumeKernel(other, "parent", "cost_volume_fwd_parent")
    assert other.kernels == {"parent": parent}
    assert other.launch_counts() == {"parent": 0}
    assert launch_counts() == before
    with pytest.raises(ValueError, match="'parent' is already bound"):
        CostVolumeKernel(other, "parent", "cost_volume_fwd")
    with pytest.raises(ValueError, match="'cost_volume_cuda' is already"):
        CostVolumeKernel(LIBRARY, "cost_volume_cuda", "cost_volume_fwd")
    assert list(other.kernels) == ["parent"]
    assert launch_counts() == before
    assert issubclass(k1._Library, KernelLibrary)


def _module_name(path: str) -> list[str]:
    parts = os.path.relpath(path, REPO)[:-len(".py")].split(os.sep)
    return parts[:-1] if parts[-1] == "__init__" else parts


def _imports_from(path: str):
    """(absolute module, name) of each ``from ... import name`` in the
    source at ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    package = _module_name(path)
    if not path.endswith("__init__.py"):
        package = package[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level \
                else []
            module = ".".join(base + ([node.module] if node.module else []))
            for alias in node.names:
                yield module, alias.name


def test_kernel_library_is_imported_from_library_py():
    """What every kernel shares is imported from ``kernels/library.py``:
    no module of the package, nor ``chip_smoke.py`` or
    ``multicard_smoke.py``, imports it from ``kernels/cost_volume.py``; no
    module of ``kernels/`` but ``__init__.py`` imports from
    ``cost_volume.py``; and none imports an underscore name from a module
    of ``kernels/``."""
    pkg = os.path.join(REPO, "casmvsnet_pl_tpu_torch")
    kdir = os.path.join(pkg, "kernels")
    with open(os.path.join(kdir, "library.py")) as f:
        tree = ast.parse(f.read())
    owned = {n.name for n in tree.body if isinstance(
        n, (ast.FunctionDef, ast.ClassDef))}
    owned |= {t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)}
    assert {"Kernel", "KernelLibrary", "LIBRARY", "check_device",
            "check_layout", "find_nvcc", "DTYPE_CODES", "NVCC_FLAGS",
            "BUILD_DIR", "CSRC_DIR"} <= owned
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    files += [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                              "multicard_smoke.py")]
    cost_volume = "casmvsnet_pl_tpu_torch.kernels.cost_volume"
    bad = []
    for path in files:
        in_kernels = os.path.dirname(path) == kdir
        for module, name in _imports_from(path):
            if module == cost_volume and (name in owned or (
                    in_kernels and not path.endswith("__init__.py"))):
                bad.append((path, module, name))
            if module.startswith("casmvsnet_pl_tpu_torch.kernels") \
                    and name.startswith("_"):
                bad.append((path, module, name))
    assert len(files) > 60
    assert not bad, bad
    with open(os.path.join(kdir, "cost_volume.py")) as f:
        defined = {n.name for n in ast.parse(f.read()).body if isinstance(
            n, (ast.FunctionDef, ast.ClassDef))}
    assert not defined & owned, defined & owned


def test_quad_entry_runs_on_cpu_without_kernels():
    from casmvsnet_pl_tpu_torch.entry import entry

    before = launch_counts()
    # with TransMVSNet's DCN and its backward, FMT layer, in conv
    assert len(before) == 21
    fn, args = entry("cpu", img_wh=(64, 32), sampling="quad")
    assert args[0].sampling == "quad"
    depth, conf = fn(*args)
    assert launch_counts() == before
    assert depth.shape == (1, 32, 64) and conf.shape == (1, 8, 16)
    assert torch.isfinite(depth).all() and torch.isfinite(conf).all()


def test_quad_train_entry_steps_on_cpu_without_kernels():
    from casmvsnet_pl_tpu_torch.entry import train_entry

    trainer, state, batch = train_entry("cpu", img_wh=(64, 32),
                                        n_depths=(8, 8, 8), sampling="quad",
                                        num_groups=8)
    before = launch_counts()
    state, logs = trainer.train_step(state, batch)
    assert launch_counts() == before
    assert state.step == 1
    assert all(math.isfinite(float(v)) for v in logs.values())
    grads = [p.grad for p in state.model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("name", ["variance_epilogue_cuda",
                                  "groupwise_epilogue_cuda",
                                  "variance_epilogue_bwd_cuda",
                                  "groupwise_epilogue_bwd_cuda",
                                  "tap_reduce_cuda", "tap_reduce_bwd_cuda"])
def test_epilogue_kernels_refuse_cpu_tensors(name):
    from casmvsnet_pl_tpu_torch import kernels

    kernel = getattr(kernels, name)
    if name.startswith("tap_reduce"):
        args, kw = (torch.rand(37, 32), torch.rand(37, 4)), {}
        if "bwd" in name:
            args += (torch.rand(37, 8),)
    else:
        groups = 2 if "groupwise" in name else 1
        ref = torch.rand(1, 8, 8)
        rows = torch.rand(1, 2, 4, 8, 32)
        ws = torch.rand(1, 2, 4, 8, 4)
        args, kw = (ref, rows, ws), {"groups": groups}
        if "bwd" in name:
            args += (torch.rand(1, 4, 8, 8 if groups == 1 else groups),)
    with pytest.raises(ValueError, match="CUDA"):
        kernel(*args, **kw)
    assert kernel.launches == 0


def test_warp_runs_on_cpu_without_kernels():
    """The packed-quad warp and its backward on CPU tensors take the plain
    tap reduce: no kernel launches."""
    from casmvsnet_pl_tpu_torch.ops import pack_quad, warp_src_quad_batched

    feats = torch.rand(2, 12, 16, 8, requires_grad=True)
    proj = torch.eye(3, 4).repeat(2, 1, 1)
    proj[:, 0, 3] = 40.0
    proj.requires_grad_(True)
    dv = torch.linspace(430.0, 450.0, 4)[None, :, None, None].repeat(
        2, 1, 12, 16).requires_grad_(True)
    before = launch_counts()
    out = warp_src_quad_batched(pack_quad(feats), proj, dv, 12, 16)
    out.square().sum().backward()
    assert launch_counts() == before
    assert out.shape == (2, 4, 12, 16, 8)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (feats, proj, dv))


def test_window_sampling_raises():
    """entry("cpu", sampling="window") raises nothing: it runs the window
    mode at level 0 and the plain exact path at levels 1 and 2, and
    launches no kernel."""
    from casmvsnet_pl_tpu_torch.entry import entry

    fn, args = entry("cpu", img_wh=(64, 32), sampling="window")
    before = launch_counts()
    depth, conf = fn(*args)
    assert launch_counts() == before
    assert depth.shape == (1, 32, 64) and conf.shape == (1, 8, 16)
    assert torch.isfinite(depth).all() and torch.isfinite(conf).all()


PROBE_WRAPPERS = ["lane_prefix_copy_cuda", "row_gather_ldg_cuda",
                  "row_gather_cp_async_cuda", "row_gather_bulk_cuda",
                  "lane_gather_cuda", "variance_dblk_cuda", "variance_v3_cuda",
                  "patch_epilogue_t_cuda"]


@pytest.mark.parametrize("name", PROBE_WRAPPERS)
def test_probe_kernels_refuse_cpu_tensors(name):
    from casmvsnet_pl_tpu_torch import kernels

    kernel = getattr(kernels, name)
    ref, rows, ws = (torch.rand(1, 8, 8), torch.rand(1, 2, 4, 8, 32),
                     torch.rand(1, 2, 4, 8, 4))
    args = {"lane_prefix_copy_cuda": (torch.rand(37, 32),),
            "lane_gather_cuda": (torch.rand(8, 64),
                                 torch.zeros(16, dtype=torch.int64)),
            "variance_dblk_cuda": (ref, rows, ws, 2),
            "variance_v3_cuda": (ref, rows, ws),
            "patch_epilogue_t_cuda": (torch.rand(2, 128, 64),
                                      torch.rand(2, 8, 64),
                                      torch.rand(2, 8, 64))}.get(
        name, (torch.rand(37, 32), torch.zeros(5, dtype=torch.int64)))
    with pytest.raises(ValueError, match="CUDA"):
        kernel(*args)
    assert kernel.launches == 0


def test_probe_mains_default_to_the_card():
    """Each probe runs on the card unless its caller asks for the CPU."""
    import inspect

    from casmvsnet_pl_tpu_torch.probes import epi2, epi3, epi5, gather

    for mod in (epi2, epi3, epi5, gather):
        assert inspect.signature(mod.main).parameters["device"].default \
            == "cuda", mod.__name__


def test_probes_import_no_jax():
    code = (
        "import sys\n"
        "from casmvsnet_pl_tpu_torch.probes import epi2, epi3, epi5, gather\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'casmvsnet_pl_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_probe_dispatchers_take_cpu_tensors_to_plain_versions():
    """On CPU tensors the probes' dispatchers run the plain versions and
    launch nothing."""
    from casmvsnet_pl_tpu_torch.ops import cost_epilogue as ce
    from casmvsnet_pl_tpu_torch.probes import epi2, epi3, epi5, gather

    before = launch_counts()
    ref, rows, ws = (torch.rand(1, 8, 8), torch.rand(1, 2, 4, 8, 32),
                     torch.rand(1, 2, 4, 8, 4))
    plain = ce.plain_variance_epilogue(ref, rows, ws)
    assert torch.equal(epi2.variance_dblk(ref, rows, ws, 2), plain)
    assert torch.equal(epi3.variance_v3(ref, rows, ws), plain)
    assert torch.equal(epi3.lane_prefix_copy(rows), rows[..., :8])
    table, idx = torch.rand(20, 16), torch.tensor([3, 0, 19, 3])
    for form in gather.FORMS:
        assert torch.equal(gather.row_gather(table, idx, form), table[idx])
    assert torch.equal(gather.lane_gather(table.t(), idx), table.t()[:, idx])
    rowsT, fx = torch.rand(2, 128, 64), torch.rand(2, 8, 64) * 3
    assert torch.equal(epi5.patch_epilogue_t(rowsT, fx, fx),
                       epi5.plain_patch_epilogue_t(rowsT, fx, fx))
    assert launch_counts() == before


def _script_imports_nothing_banned(script, banned=BANNED):
    code = (
        "import sys\n"
        "sys.path.insert(0, 'scripts')\n"
        f"import {script}\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{banned!r})\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_eval_torch_imports_no_jax_pil_or_cv2():
    _script_imports_nothing_banned("eval_torch")


def test_train_torch_imports_no_jax_pil_cv2_or_tensorboardx():
    _script_imports_nothing_banned("train_torch")


@pytest.mark.parametrize("script", ["convert_ckpt_torch", "demo_torch"])
def test_new_scripts_import_no_jax_pil_cv2_msgpack_or_matplotlib(script):
    _script_imports_nothing_banned(script, BANNED_TOO)


MEASUREMENT_SCRIPTS = ["bench_torch", "flops_report_torch",
                       "profile_stages_torch", "profile_bwd_torch",
                       "profile_train_step_torch", "profile_eval_res_torch"]


@pytest.mark.parametrize("script", MEASUREMENT_SCRIPTS)
def test_measurement_scripts_import_no_jax(script):
    """bench_torch.py and scripts/*_torch.py: no JAX, PIL, OpenCV,
    tensorboardX, msgpack or matplotlib, nor the JAX package."""
    _script_imports_nothing_banned(script, BANNED_TOO)


@pytest.mark.parametrize("script", ["multicard_smoke", "debug_dp_torch"])
def test_data_parallel_scripts_import_no_jax(script):
    """multicard_smoke.py and scripts/debug_dp_torch.py: no JAX, flax or the
    JAX package (nor PIL, OpenCV, tensorboardX, msgpack or matplotlib)."""
    _script_imports_nothing_banned(script, BANNED_TOO)


@pytest.mark.parametrize("script", MEASUREMENT_SCRIPTS)
def test_measurement_scripts_default_to_the_card(script):
    import importlib
    scripts = os.path.join(REPO, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    mod = importlib.import_module(script)
    assert mod.parser().parse_args([]).device == "cuda"


def test_demo_torch_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "demo_torch.py"),
                           "--img_wh", "64", "64"], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not os.listdir(tmp_path)


def test_train_torch_defaults_to_the_card():
    import train_torch
    from casmvsnet_pl_tpu_torch.opt import get_opts

    args = get_opts([])
    assert not args.cpu
    assert train_torch.resolve_device(get_opts(["--cpu"])).type == "cpu"
    if torch.cuda.is_available():
        assert train_torch.resolve_device(args).type == "cuda"
    else:
        with pytest.raises(SystemExit, match="no CUDA device"):
            train_torch.resolve_device(args)


def test_eval_torch_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "eval_torch.py"),
                           "--root_dir", str(tmp_path)], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "results")


def test_fusion_defaults_to_the_card():
    import inspect

    import eval_torch
    from casmvsnet_pl_tpu_torch.fusion import fuse_scan

    assert inspect.signature(fuse_scan).parameters["device"].default == \
        "cuda"
    args = eval_torch.get_opts([])
    assert not args.cpu
    assert eval_torch.resolve_device(eval_torch.get_opts(["--cpu"])).type \
        == "cpu"
