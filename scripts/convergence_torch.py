"""The port's training convergence check on the card.

    python scripts/convergence_torch.py [EPOCHS]

The counterpart of ``scripts/tpu_convergence.py``: the JAX suite's
synthetic quality fit (``casmvsnet_pl_tpu_torch/engine/convergence.py``:
TinyDTU at 64x64, n_depths 8/8/16, 16 train and 5 val samples, batch 2,
Adam 1e-3 with a 12-epoch cosine; EPOCHS, 4 unless given) on one NVIDIA
GPU with the production settings: bf16 compute, the default cost volume
(K1 forward and K2 backward), from the JAX package's initial weights (its
``init_state``'s PRNGKey 0, made without JAX by ``utils/jax_init.py``),
the start of the TPU script. It prints the val trajectory and asserts the
thresholds of
``tests/test_train_loop.py::test_fit_quality_and_artifacts``. A
kernel-boundary or bf16 accumulation fault that shows only on the card
passes the CPU suite but fails here. There is no CPU path: without a CUDA
device it raises.
"""
from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from casmvsnet_pl_tpu_torch.engine import convergence  # noqa: E402
from casmvsnet_pl_tpu_torch.utils import jax_initial_weights  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("this script checks the training path on the "
                           "card; no CUDA device is available")
    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else convergence.EPOCHS
    with tempfile.TemporaryDirectory(prefix="convergence_torch_") as root:
        convergence.write_tiny_dtu(root)
        fit = convergence.quality_fit(
            root, "cuda", torch.bfloat16,
            weights=jax_initial_weights(convergence.model(), 0),
            epochs=epochs)
    before, after = fit["before"], fit["after"]
    print(f"{torch.cuda.get_device_name(0)}: untrained val abs_err="
          f"{before['val/abs_err']:.3f} acc2={before['val/acc_2mm']:.3f}; "
          f"after {epochs} epochs (bf16, K1/K2): abs_err="
          f"{after['val/abs_err']:.3f} acc2={after['val/acc_2mm']:.3f} "
          f"loss={after['val/loss']:.4f}; trajectory "
          f"{[round(x, 2) for x in convergence.trajectory(fit)]} mm; "
          f"launches {fit['launches']}; wall={fit['wall_s']:.1f}s",
          flush=True)
    failures = convergence.threshold_failures(fit)
    if failures:
        raise AssertionError(f"convergence check FAILED: {failures}")
    print("convergence check PASSED", flush=True)


if __name__ == "__main__":
    main()
