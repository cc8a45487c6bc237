"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. require a CUDA device (there is no CPU path);
  2. print the toolchain: torch, CUDA, the card, nvidia-smi, nvcc, triton;
  3. build the kernels from casmvsnet_pl_tpu_torch/csrc/ (one nvcc call);
  4. hold the cost-volume kernel (K1) against its plain PyTorch version at
     the three cascade level shapes (B=1), in f32 (<= 1e-4 abs) and bf16
     (<= 1 bf16 ulp of the plain f32 result), for variance and groupwise
     (G=8); and at the eval configuration's levels (1152x864, 5 views,
     B=1, variance): f32 equal to the bit, bf16 within 1 ulp;
  5. run the inference forward through ``entry``: f32 with the kernel
     against f32 with the plain cost volume (< 0.05 mm on depth_0), and the
     bf16 main path, counting exactly one K1 launch per level;
  6. time bf16 forwards at B=1 and B=4 with CUDA events;
  7. (below, after phase 43) print the kernels' JSON line (launches per
     main path; what each time covers; bounds), then {"ok": true,
     "device": ...} last;
  8. hold the backward kernel (K2) against its plain PyTorch version at the
     three level shapes at B=2, variance and groupwise (G=8), f32
     (<= 1e-5 abs + 1e-5 rel) and bf16 (<= 2 bf16 ulps of the rounded plain
     f32 result, + 1e-5 abs), and the autograd Function's gradient against
     autograd through the plain forward at L2 (f32);
  9. one f32 SGD train step through ``train_entry`` with the kernels and
     one with the plain cost volume, from the same state and batch: loss
     within rtol 1e-5, every gradient leaf within relative L2 1e-3 (the
     prob convs' biases, whose exact gradient is 0, against their weights'
     gradient norm; cuDNN deterministic, so that the cost volume is the
     only difference), and
     exactly 3 K1 + 3 K2 launches in the kernel step, none in the plain
     (beside the prob conv's 3 in each);
 10. the training main path at full width: bf16, 640x512x3, B=2, Adam
     lr 1e-3, 20 steps on one batch, counting 3 K1 + 3 K2 launches a step;
     every loss finite and the last below the first;
 11. time the bf16 train step (stages, step, samples/s, peak memory) with
     CUDA events.

The quad configuration (``sampling="quad"``: packed-quad rows reduced by
the cost epilogue kernels, TPU kernels #3-#6):
 12. hold #3 (variance) and #5 (groupwise, G=8) against their plain
     versions on the rows and weights that ``quad_rows`` builds from the
     plane scene, at the three level shapes (B=1): f32 <= 1e-5 abs, bf16
     <= 1 bf16 ulp of the plain f32 result;
 13. hold #4 and #6 against theirs at B=2 on d ref, d rows and d ws: f32
     <= 1e-5 abs + 1e-5 rel, bf16 <= 2 bf16 ulps of the rounded plain
     result + 1e-5;
 14. the f32 quad inference forward through ``entry(sampling="quad")``
     against the default path (< 0.05 mm on depth_0), then the bf16 quad
     forward: 3 #3 launches and no K1;
 15. one f32 SGD step through ``train_entry(sampling="quad")`` with the
     kernels and one with the plain quad route (autograd through
     ``plain_quad_cost_volume``), as phase 9: 3 #3 + 3 #4 launches and no
     K1/K2;
 16. 10 bf16 Adam steps with sampling="quad" at 640x512x3, B=2, as phase
     10;
 17. the groupwise (G=8) quad configuration: one bf16 forward (3 #5) and
     two bf16 Adam steps (3 #5 + 3 #6 a step);
 18. time the bf16 quad forward (B=1, 4) and train step, then every
     kernel (K1, K2, #3-#6) against its plain version per level, in turns
     plain/kernel/kernel/plain, each beside its bound; and K1 alone at
     B=2 (the train step's forward), at G=8 and at the eval configuration
     (``probes/k1.py``);
 19. profile the bf16 forward (B=1) and train step of the default and the
     quad configurations: device time by kernel name (``torch.profiler``).

The packed-quad warp (``warp_src_quad_batched``: ``grid_sample_quad``,
whose 4-tap reduce is TPU kernel #7 and its VJP #8):
 20. hold #7 and #8 against their plain versions on one source view's rows
     and weights from ``quad_rows`` at the three level shapes (B=2), and on
     a prefix of N = 100003 rows (no multiple of any block size): #7 out
     <= 1e-5 abs (f32 and bf16 rows); #8 d rows exact (f32) or within 1
     bf16 ulp (bf16), d w <= 1e-5 abs + 1e-5 rel;
 21. the warp path at full width: both source views at each level (C
     32/16/8, D 48/32/8, B=2), the plane scene's projections and depth
     windows. f32: the forward against ``grid_sample_batched`` at the same
     coordinates (<= 1e-5 abs), and the gradient of sum(out * G) for the
     source features (through ``pack_quad``), ``proj_mats`` and
     ``depth_values`` against autograd through the plain route (each leaf
     within relative L2 1e-4). Then the bf16 main path: forward and
     backward finite, exactly 6 #7 and 6 #8 launches and no other kernel;
 22. time #7 and #8 per level (bf16 rows of one source view, B=2) against
     their plain versions beside their bounds, and #7's library call, a
     batched ``torch.matmul`` of w (N, 1, 4) by the rows upcast to f32
     (N, 4, C); then profile the bf16 warp path of phase 21.

The probes (``casmvsnet_pl_tpu_torch/probes``: the card's counterparts of
the TPU probes, kernels #9-#13), each probe's ``main`` path at the probe's
full-width shapes, every configuration checked against its plain version
and timed in turns beside its bound; one "probes" path whose launches are
counted over phases 23-26:
 23. #13 (``probes/gather.py``): the three row-gather forms (ldg, cp_async,
     bulk) and the lane gather at the TPU probe's shapes, the probe's five
     gather forms in PyTorch equal, then the forms at the quad route's own
     gather (``quad_rows`` at B=1, 3 levels) beside ``index_select``; and
     #11 (``probes/epi3.py``): the lane-prefix copy at 1024 and 8192 rows
     per block beside ``rows[..., :C].contiguous()``. Bit-exact;
 24. #9 (``probes/epi2.py``): the variance epilogue with dblk in {1, 4, 8,
     D} depths per thread at the probe's L1 and L2 configs, beside #3;
 25. #10 (``probes/epi3.py``): the V=3 variance epilogue at 64-1024
     threads per block, beside #3. #9/#10: f32 <= 1e-5 abs, bf16 <= 1 bf16
     ulp of the plain f32 result;
 26. #12 (``probes/epi5.py``): the transposed patch epilogue per level and
     channel split (f32 out <= 1e-5 abs), and the probe's four samplers of
     one view (quad, validfold, tfma, the kernel) in ms and ns per sample;
 27. the host's cost of a launch: the time to enqueue one call
     (``probes/host.py``) of the lane gather, the ldg row gather, K1 and K2
     at small shapes, beside ``index_select`` at the gathers' probe shapes
     and the allocations K1 and K2 make (``new_empty``, ``new_zeros``).

The eval path (``eval_torch.py``: inference to PFM maps and their fusion,
``eval.py``'s two steps), in a temporary directory:
 28. print which of PIL, cv2, imageio, tqdm and tensorboardX import;
 29. write a synthetic DTU tree at DTU's test size (1 scan, 5 cameras,
     PNGs at 1600x1200) with the port's writer; print the host's decode
     and decode + PIL-bilinear resize (to 1152x864) ms per image;
 30. ``eval_torch.run_inference`` in bf16 over the 5 reference views at
     1152x864x5 (the DTU reader at ``img_wh`` 1152x864): exactly 15 K1
     launches and no other kernel; PFMs of (864, 1152) and (216, 288),
     depths finite and inside the swept range; ms per view (CUDA events,
     the forward alone and with the host's reading and writing, median of
     views 2-5) and peak memory;
 31. one f32 view, the model with K1 against the plain cost volume
     (< 0.05 mm on depth_0); a profile of one bf16 view's forward; one
     bf16 view with --num_groups 8 (3 K1 launches); one bf16 forward at
     1600x1184x5 for its peak memory;
 32. ``eval_torch.run_fusion`` on the card of the tree's ground-truth
     depths with proba 1, scored by the port's ``evaluate_scan`` in a
     40 mm box at the rig's centre (mean accuracy and overall < 0.1 mm),
     then of phase 30's PFMs (the point count); ms per reference view.

The training CLI (``train_torch.py``, ``train.py``'s counterpart), in a
temporary directory:
 33. write a synthetic DTU training tree at DTU's train size (one train
     and one val scan, 5 cameras, 7 lights: 35 samples a split; PNGs at
     640x512, depths and masks at 1600x1200, the focal length scaled to
     keep the 64x64 tree's field of view); its native depths are written
     so that the reader's half-resize and ``DEPTH_CROP`` line up with the
     images, which is checked on one sample (equal to the plane's depth);
 34. ``train_torch.main`` in-process: the default config in bf16, global
     batch 2, Adam lr 1e-3, one epoch (17 steps, 18 padded val batches):
     exactly 3 K1 + 3 K2 launches a step, 3 K1 a val batch and 3 K1 for
     the train panel's extra forward (the val panel reuses its batch's
     outputs), and no other kernel; a finite loss whose mean over the last
     3 steps is below that over the first 3; ``last.ckpt`` and an
     ``epoch=`` checkpoint; the events file's scalars and both panels read
     back through ``utils/tensorboard.py``. Prints ms per step (wall, a
     CUDA sync a step, the loader included; median of steps 3 onward),
     samples/s, the share of the step spent waiting on the loader, peak
     memory, and phase 11's ``train_entry`` step beside them;
 35. ``--resume_path last.ckpt`` for one more epoch: the step count goes
     on from 17 to 34 and Adam's state with it, the same launches; then
     ``--ckpt_path last.ckpt --prefixes_to_ignore cost_reg_0
     --num_epochs 0``: exactly the cost_reg_0 parameters are printed as
     ignored and keep their initial values, every other one is the
     checkpoint's;
 36. the data-parallel step: two ranks on the one card over gloo
     (``parallel.spawn``; NCCL refuses two ranks on one device), one f32
     SGD step (lr 1e-2) on a global batch of 4 distinct plane scenes at
     640x512x3 with K1/K2 and cuDNN deterministic, against one process on
     the same global batch: loss rtol 1e-5, BatchNorm running statistics
     within 1e-5 relative, every gradient leaf within relative L2 of the
     larger of 1e-3 and 3x the step's own float32 noise (one process on
     the batch with its rows permuted, two orders, measured in the same
     run; see ``dp_step``); 3 K1 + 3 K2 launches on each rank.

The JPEG datasets (BlendedMVS, Tanks and Temples), in a temporary
directory that holds phase 34's ``last.ckpt``:
 37. the port's JPEG codec on the host: the plane's texture at 1920x1080
     and 768x576, encoded and decoded baseline 4:2:0, 4:4:4, progressive
     and with a restart interval; ms per image (median of 3) and the round
     trip's PSNR (>= 40 dB: quality 95 gives 43-49 dB on this texture);
     the progressive and restart files (the same coefficients) decode
     equal to the baseline file;
 38. a synthetic BlendedMVS tree (one train and one val scene, 12 cameras
     each, JPEGs at 768x576); K1 (bit-equal in f32, 1 bf16 ulp) and K2 (as
     phase 8) against their plain versions at its train shapes
     (768x576x3, B=2); ``train_torch.main --dataset_name blendedmvs
     --depth_interval 192`` for one bf16 epoch at batch 2 (6 steps, 6 val
     batches): exactly 3 K1 + 3 K2 a step, 3 K1 a val batch and 3 for the
     panel, no other kernel; a finite loss whose last two steps average
     below the first two; ms per step (wall, the loader included),
     samples/s, the loader-wait share, peak memory; then the warm start
     ``--ckpt_path`` phase 34's DTU checkpoint: every parameter the
     checkpoint's;
 39. a synthetic Tanks and Temples tree (intermediate split, every scan's
     cameras, Family's JPEGs at 1920x1080, 5 cameras);
     ``eval_torch.run_inference`` in bf16 at 1152x864x5 over Family:
     exactly 15 K1 launches, depths finite and inside the swept range; ms
     per view (the forward, CUDA events; and with the JPEG reading), peak
     memory; one f32 view with K1 against the plain cost volume (within
     0.05 mm scaled from DTU's 2.65 mm interval to Family's 2.5e-3 units);
     one bf16 forward at 1920x1056x5 for its peak memory;
     ``eval_torch.run_fusion`` of the plane's exact depths (confidence 1):
     every fused point within 2.5e-5 units of the plane;
 40. ``eval_torch.main --dataset_name blendedmvs --split val --img_wh 768
     576 --save_visual`` on phase 38's tree: 36 K1 launches for its 12
     views, the PFMs' shapes, a PLY of finite points, and the two visual
     JPEGs a view decoded by the port; then ``eval_torch.run_fusion`` of
     the scene's ground-truth depths (confidence 1): a cloud of points,
     99.9 % of them within 1e-3 units of the plane z = 125 + 0.3 x and
     every one within 1 unit;

Checkpoints from outside the port (``convert_ckpt_torch.py``,
``utils/torch_convert.py``) and ``demo_torch.py``, on the default model's
seeded full-width weights with perturbed BatchNorm statistics:
 41. a reference Lightning ``.ckpt`` in PyTorch's legacy format (``model.``
     prefix, a ``loss.`` key, no ``num_batches_tracked``, ``hparams`` a
     Namespace, a scheduler object in ``lr_schedulers``), converted by
     ``convert_ckpt_torch.py`` in a subprocess: every weight equal to the
     original on the card; ``demo_torch.main`` from the converted file at
     640x512x3 in bf16: its depth and confidence maps against a forward of
     the original model in this process (expected equal to the bit; bound
     0.05 mm and 1e-2), exactly 3 K1 launches a forward, ms per view and
     views/s (CUDA events); one f32 forward of the converted model with K1
     against the plain cost volume (< 0.05 mm on depth_0);
 42. a checkpoint in the JAX package's layout (flax msgpack through
     ``utils/msgpack.py``: ``params`` and ``batch_stats`` in the JAX names
     and layouts, an Adam ``opt_state`` and a ``step``), converted: every
     weight equal to the original, the demo's maps equal to phase 41's;
 43. ``eval_torch`` with ``--ckpt_path`` the converted file (a
     ``strict=True`` load) for one view of phase 29's DTU tree at
     1152x864x5: 3 K1 launches, the PFMs' shapes, its depth map against
     the original model's forward (bound 0.05 mm).

The window mode (``sampling="window"``: level 0, C=8 and D=8, samples
depth groups in one clamped window in plain PyTorch on the card; levels 2
and 1 take K1/K2) and ``utils/profiling.py``:
 44. at the plane scene's level-0 shape (640x512, C=8, D=8, V=3, B=1 and
     2), the window sampler of each source view and the window cost
     volume (variance and G=8) on the card against the same functions run
     on the CPU and moved to the card: f32 <= 2e-6 abs, bf16 <= 2 bf16
     ulps; the share of groups whose span leaves the window; the level's
     bf16 cost volume timed against K1 (B=1 forward) and K1 + K2 (B=2
     forward + backward) at the same shape, in turns;
 45. the f32 forward through ``entry(sampling="window")`` against the
     default path (< 0.05 mm on depth_0 at the pixels in no overflowing
     level-0 group), then the bf16 window forward: exactly 2 K1 launches
     and no other kernel; bf16 forwards timed at B=1 and B=4 (beside
     phase 6's default path);
 46. one f32 SGD step through ``train_entry(sampling="window")`` with
     K1/K2 against the same route with the plain exact path, as phase 9;
     then 10 bf16 Adam steps at 640x512x3, B=2: 2 K1 + 2 K2 a step, a
     falling loss; ms per step and peak memory;
 47. ``eval_torch.run_inference --sampling window`` in bf16 over phase
     29's tree at 1152x864x5: exactly 10 K1 launches, depths finite and
     inside the swept range, ms per view and peak memory; the first view's
     depth_0 against the default path and its share of overflowing
     level-0 groups;
 48. ``utils/profiling.trace`` around one bf16 window forward writes a
     Chrome trace that names K1 twice; ``device_memory_stats()`` reports
     the card with a peak above 0; the window forward's and train step's
     device time by kernel name.

Training quality (``engine/convergence.py``: the JAX suite's 4-epoch
TinyDTU fit, ``tests/conftest.py::quality_fit``, at 64x64 with n_depths
8/8/16, and its fused cloud), in a temporary directory:
 49. the recipe's fit in f32 on the CPU (one thread, the plain cost volume)
     from ``init_weights`` seed 0, the reference trajectory; then the same
     weights in bf16 on the card through K1/K2: exactly 3 K1 + 3 K2 a
     train step, 3 K1 a val batch (before the fit, each epoch, after) and
     3 K1 an epoch's train panel, 3 prob convs a forward and no other
     kernel; the thresholds of
     ``tests/test_train_loop.py::test_fit_quality_and_artifacts`` (untrained
     abs_err > 8.0 mm, the val loss falls, abs_err < 4.0 mm, acc_2mm > 0.3),
     ``last.ckpt``, an ``epoch=`` checkpoint and an events file; the card's
     val abs_err within max(2.0 mm, 0.2 x the CPU's) of the CPU's before
     the fit and after every epoch. Then the fit from seeds 1-3 on the card,
     whose final abs_err and acc_2mm are printed, not held;
 50. the fit in bf16 on the card from the JAX package's own initial weights
     (``init_state``'s PRNGKey 0, made without JAX by
     ``utils/jax_init.py``; the start that the JAX suite's fused-cloud test
     and ``scripts/tpu_convergence.py`` use): exactly 3 K1 + 3 K2 a step
     and 3 K1 a val batch, its trajectory and thresholds printed; then
     ``eval_torch.run_inference`` in bf16 from its ``last.ckpt`` over the
     test scan (5 views at 64x64x3; 3 K1 a view), ``run_fusion`` (--conf 0.5
     --min_geo_consistent 2), and the cloud scored by
     ``evaluations/dtu/eval_dtu_torch.py`` in a subprocess against the
     plane's closed-form surface: more than 500 points, n_data > 500, n_stl
     > 1000, and mean accuracy, completeness and overall each below 12.0 mm
     (``tests/test_eval_pipeline.py::test_fused_cloud_quality``). The cloud
     of phase 49's checkpoint (seed 0) is scored the same way and printed,
     not held: from that start the recipe's cloud misses the bound on the
     CPU too, in the JAX package as in the port (``PERF.md`` §6).

Phases 51-53, which ran ``bench_torch.py`` and the five
``scripts/*_torch.py`` profilers at their defaults and counted their
launches, were removed: ``perfbench/`` measures the port, those scripts
feed none of its cells, and their own CPU tests cover them.

CostRegNet's last layer, the 8 -> 1 ``prob`` conv (``csrc/prob_conv.cu``,
no TPU counterpart):
 54. (run after phase 18) the kernel against ``F.conv3d`` (TF32 off) at
     the main path's shapes, eval's three levels (1152x864, B=1, bf16
     parameters) and the train step's (B=2, float32 parameters, as under
     autocast): f32 input and parameters within 1e-5 of sum |w x| + |b|,
     bf16 input within one bf16 ulp of the f32 conv of the same inputs (or
     that f32 bound); then timed against cuDNN's bf16 conv in turns, each
     beside its bound and its byte bound.

TransMVSNet's ARF, the modulated deformable 3x3 conv (``csrc/deform_conv.cu``,
no TPU counterpart):
 55. (run after phase 54) the kernel against its plain version
     (``ops/deform_conv.py::plain_deform_conv``) at the three levels'
     shapes of 1152x864x5 (5 images of 8, 16 and 32 channels, offsets of
     about a pixel): f32 within 1e-5 of the sum of |terms|, bf16 within
     one bf16 ulp of the f32 result of the same bf16 values (or that f32
     bound); then timed against the plain version in turns, each level
     beside its bound; then TransMVSNet's bf16 forward at 640x512x3
     (``entry(arch="transmvsnet")``), launching exactly K1 and the prob
     conv 3 times, the deformable conv 9 times and the FMT's layer kernel
     16 times (two launches a layer).

TransMVSNet's FMT, one LoFTR encoder layer a call (``csrc/fmt_layer.cu``,
no TPU counterpart):
 56. (run after phase 55) the FMT's eight layers (self and cross in turn)
     at the eval shape (5 views of 216x288 = 62,208 tokens, drawn Linear
     and LayerNorm parameters) through the kernel against the plain layer
     (``ops/fmt_layer.py::plain_fmt_layer``): float32 within 8e-4 of the
     plain float32 layers; bf16 no farther from the plain float32 layers on
     the same bf16 values than the plain bf16 layers are; then the eight
     layers timed in bf16 against the plain layers in turns, beside their
     bound (``perfbench/counts/fmt_layer.py``).

CostRegNet's input block at one input channel, the 3x3x3 conv 1 -> 8 with
eval BatchNorm and leaky ReLU 0.01 (``csrc/in_conv.cu``, no TPU
counterpart):
 57. (run after phase 56) the kernel against its plain version
     (``ops/in_conv.py::plain_in_conv``, TF32 off) at eval's three level
     shapes (1152x864, B=1), BatchNorm statistics drawn far from the
     identity: f32 within 2^-14 of the terms (sum |w x| |scale| + |mean
     scale| + |beta|), bf16 within one bf16 ulp of the f32 block of the
     same bf16 values (or that f32 bound); then timed in bf16 against
     cuDNN's conv + BatchNorm + leaky ReLU (the plain version and the
     library calls it replaced) in turns, beside its bound
     (``perfbench/counts/in_conv.py``). TransMVSNet's forward (phase 55's
     path) launches it once a level; no CasMVSNet path launches it.

TransMVSNet's training, the deformable conv's backward (``csrc/
deform_conv_bwd.cu``, no TPU counterpart):
 58. (run after phase 57) the backward kernel against the plain version's
     autograd (``torch.autograd.grad`` through ``plain_deform_conv``) at
     the training cell's three level shapes (B=2 x 5 views at 640x512, 8,
     16 and 32 channels, offsets of about a pixel): the gradients of x,
     of the offsets and masks and of the weight, f32 within 1e-4 of each
     gradient's largest magnitude, bf16 within two bf16 ulps of the f32
     plain gradients of the same bf16 values and that bound; then timed
     against the plain version's forward and backward in turns, beside
     its bound (``perfbench/counts/deform_conv_bwd.py``), and beside the
     binned scatter's spill share and global float atomics on d_x a pixel
     (``deform-conv-bwd-scatter`` lines); then TransMVSNet's
     bf16 Adam steps at 640x512x3 B=2 through ``train_entry(arch=
     "transmvsnet")`` (the focal loss), launching exactly K1, K2 and the
     prob conv 3 times a step and the deformable conv's forward and
     backward 9 times each, the loss falling; then the spill share at the
     ARF's own offsets: the training cell's model after its warm-up steps,
     one step read a level at a time.

Every cascade forward on the card launches the prob conv's kernel once a
level, and every path's launches count it beside K1 (or #3/#5). A plain
forward held against a kernel forward (phases 5, 31, 39, 41) takes
``F.conv3d`` for it and launches nothing, so the kernel meets its plain
version there too; the f32 steps of phases 9, 15 and 46 run the kernel on
both sides (``check_train_step`` says why).

Every kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and the float32 operations of
the function it computes over 67 TFLOP/s, the H100 SXM's published rates,
counted from this run's shapes (the lane-prefix copy's bytes are the
prefixes it must read and write, not the whole rows). The deformable
conv's bound (phase 55, ``perfbench/counts/deform_conv.py``) also counts
its bf16 contraction at C >= 16 at the dense bf16 tensor rate.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from casmvsnet_pl_tpu_torch.kernels import launch_counts, reset_launches
from casmvsnet_pl_tpu_torch.probes.common import (HBM_BYTES_PER_S, bf16_ulp,
                                                  bound, cuda_ms, cv_work,
                                                  default_levels,
                                                  epilogue_work, plane_levels)

DEVICE = "cuda"
IMG_WH = (640, 512)
F32_TOL = 1e-4          # abs, features in [0, 1): coordinates reach ~640 px
DEPTH_TOL_MM = 0.05     # tests/test_torch_parity.py
# K2 adds source-view shares with atomics, in an order that changes from run
# to run: f32 agrees with the plain backward to rounding; bf16 within 2 ulps
# of the rounded plain result, or within the f32 bound where cancellation
# leaves a value whose ulp is below the summation-order noise.
BWD_TOL = 1e-5
GRAD_REL_TOL = 1e-3     # train step, every gradient leaf, relative L2
TRAIN_STEPS = 20
# #3-#6 write every element once, with no atomics: f32 agrees with the
# plain versions to the order of their sums
EPI_TOL = 1e-5
# #7/#8 write every element once: f32 out and d rows are the plain
# versions' products and sums in their order; d w sums in another order
TAP_TOL = 1e-5
TAP_ODD_N = 100003
WARP_REL_TOL = 1e-4     # warp gradient leaves, relative L2
QUAD_TRAIN_STEPS = 10
G8_TRAIN_STEPS = 2

# kernel launches of one forward and of one train step, per configuration;
# every cascade forward on the card runs the prob conv's kernel once a level
PROB = {"prob_conv_cuda": 3}
DEFAULT_FWD = {"cost_volume_cuda": 3, **PROB}
DEFAULT_STEP = {"cost_volume_cuda": 3, "cost_volume_bwd_cuda": 3, **PROB}
QUAD_FWD = {"variance_epilogue_cuda": 3, **PROB}
QUAD_STEP = {"variance_epilogue_cuda": 3, "variance_epilogue_bwd_cuda": 3,
             **PROB}
G8_FWD = {"groupwise_epilogue_cuda": 3, **PROB}
G8_STEP = {"groupwise_epilogue_cuda": 3, "groupwise_epilogue_bwd_cuda": 3,
           **PROB}
# TransMVSNet's forward: K1 (its one-group correlation), CostRegNet's
# one-channel input block and the prob conv once a level, the ARF's three
# deformable convs a level, the FMT's eight layers at two launches each
TRANS_FWD = {"cost_volume_cuda": 3, "deform_conv_cuda": 9,
             "fmt_layer_cuda": 16, "in_conv_cuda": 3, **PROB}
# TransMVSNet's training step: K1, K2 and the prob conv once a level, the
# deformable conv's forward and backward once a conv; the FMT runs its
# plain layers under autograd and the input block its plain convs
TRANS_STEP = {"cost_volume_cuda": 3, "cost_volume_bwd_cuda": 3,
              "deform_conv_cuda": 9, "deform_conv_bwd_cuda": 9, **PROB}
TRANS_TRAIN_STEPS = 8
# forward and backward of both source views at each of the three levels
WARP_PATH = {"tap_reduce_cuda": 6, "tap_reduce_bwd_cuda": 6}


def levels(img_wh=None):
    """(level, C, D, h, w) of the default config, coarse to fine."""
    return default_levels(img_wh or IMG_WH)


def toolchain() -> str:
    """Print the toolchain report; return nvidia-smi's name and power limit."""
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    from casmvsnet_pl_tpu_torch.kernels.library import find_nvcc
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton
        print("triton:", triton.__version__)
    except ImportError as e:
        print("triton: not importable:", e)
    return card


def build_kernel(kernel) -> None:
    t0 = time.perf_counter()
    kernel.build()
    log = kernel.build_log
    print(log, file=sys.stderr)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    print(f"build: {time.perf_counter() - t0:.3f} s, {len(regs)} kernels "
          f"compiled, registers max {max(regs, default='n/a (cached)')}, "
          f"spill stores max {max(spills, default='n/a (cached)')} bytes")


def level_inputs(batch: int = 1, img_wh=None):
    """Per level: (proj (B, 2, 3, 4), depth windows (B, D, h, w)), built
    the way the cascade builds them, on the plane scene, repeated B
    times."""
    return plane_levels(DEVICE, batch, img_wh or IMG_WH)


def expect_counts(counts: dict, want: dict, what: str) -> None:
    """Every kernel launched exactly as ``want`` says (0 where unnamed)."""
    full = {n: want.get(n, 0) for n in counts}
    if counts != full:
        raise AssertionError(f"{what}: launches {counts}, expected {full}")


def scaled(want: dict, n: int) -> dict:
    return {name: count * n for name, count in want.items()}


def summed(*wants: dict) -> dict:
    """The launches of the runs of ``wants`` one after the other."""
    out = {}
    for want in wants:
        for name, count in want.items():
            out[name] = out.get(name, 0) + count
    return out


def plain_prob(run):
    """``run`` with the cascade's ``prob`` conv as ``F.conv3d`` in place of
    its kernel: a plain run launches no kernel, and the kernel meets its
    plain version wherever a kernel run is held against a plain one."""
    from casmvsnet_pl_tpu_torch.ops.prob_conv import plain_prob_conv

    def plainly():
        with mock.patch("casmvsnet_pl_tpu_torch.models.cost_reg.prob_conv",
                        plain_prob_conv):
            return run()
    return plainly


def check_kernel(kernel, plain, inputs) -> float:
    """Kernel vs plain at every level shape, for the variance, the
    groupwise correlation at G = 8 and at G = 1 (TransMVSNet's); returns the
    max f32 abs error."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    worst = 0.0
    for l, C, D, h, w in levels():
        proj, dv = inputs[l]
        feats = torch.rand((1, 3, h, w, C), generator=g, device=DEVICE)
        for kind, groups in (("variance", 1), ("groupwise", 8),
                             ("groupwise", 1)):
            name = kind if kind == "variance" else f"groupwise{groups}"
            k32 = kernel(feats, proj, dv, groups, kind)
            p32 = plain(feats, proj, dv, groups, kind)
            err = (k32 - p32).abs().max().item()
            worst = max(worst, err)
            fb = feats.to(torch.bfloat16)
            kb = kernel(fb, proj, dv, groups, kind)
            pb = plain(fb.float(), proj, dv, groups, kind).to(torch.bfloat16)
            ulps = ((kb.float() - pb.float()).abs()
                    / bf16_ulp(pb)).max().item()
            ndiff = (kb != pb).sum().item()
            print(f"kernel-check L{l} {name} out={tuple(k32.shape)} "
                  f"f32 max_abs_err={err!r} (bound {F32_TOL}) "
                  f"bf16 max_ulps={ulps!r} (bound 1) "
                  f"bf16 elements differing={ndiff}/{kb.numel()}")
            if not err <= F32_TOL:
                raise AssertionError(f"L{l} {name} f32 error {err}")
            if not ulps <= 1.0:
                raise AssertionError(f"L{l} {name} bf16 error {ulps} ulp")
    return worst


def check_outputs(depth, conf, batch: int) -> None:
    W, H = IMG_WH
    if tuple(depth.shape) != (batch, H, W) or tuple(conf.shape) != (
            batch, H // 4, W // 4):
        raise AssertionError("wrong output shapes")
    if not (torch.isfinite(depth).all() and torch.isfinite(conf).all()):
        raise AssertionError("non-finite outputs")
    if not (conf.min() >= 0 and conf.max() <= 1):
        raise AssertionError("confidence outside [0, 1]")


def sharpened_f32_forward(entry, sampling: str = "auto"):
    """(fn, args) of the f32 forward, with the softmax over depth sharpened
    so that depth_0 follows the cost volume."""
    fn, args = entry(DEVICE, torch.float32, img_wh=IMG_WH, sampling=sampling)
    with torch.no_grad():
        for l in range(3):
            getattr(args[0], f"cost_reg_{l}").prob.weight *= 30.0
    return fn, args


def counted(run, want: dict, what: str):
    """``run()`` between a reset and a read of the launch counts, which must
    be ``want``; returns its result."""
    reset_launches()
    out = run()
    torch.cuda.synchronize()
    expect_counts(launch_counts(), want, what)
    return out


def forward_main_path(entry, want: dict, label: str, **kw) -> dict:
    """One bf16 forward at B=1 through ``entry(**kw)``: its outputs checked
    and its launches exactly ``want``; returns the launches."""
    fn, args = entry(DEVICE, torch.bfloat16, img_wh=IMG_WH, **kw)
    reset_launches()
    depth, conf = fn(*args)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"forward bf16{label} main path: launches {counts}, depth_0 "
          f"{tuple(depth.shape)} range [{depth.min().item()!r}, "
          f"{depth.max().item()!r}], confidence_2 {tuple(conf.shape)} range "
          f"[{conf.min().item()!r}, {conf.max().item()!r}]")
    expect_counts(counts, want, f"bf16 forward{label}")
    check_outputs(depth, conf, 1)
    return counts


def check_forward(entry, plain) -> dict:
    """f32 kernel vs plain forward, then the bf16 main path; returns the
    launches counted over the main path's run."""
    fn, args = sharpened_f32_forward(entry)
    d_k, c_k = counted(lambda: fn(*args), DEFAULT_FWD, "f32 forward")
    d_p, c_p = counted(plain_prob(lambda: fn(*args, cost_volume=plain)),
                       {}, "f32 plain forward")
    dd = (d_k - d_p).abs().max().item()
    dc = (c_k - c_p).abs().max().item()
    print(f"forward f32 kernel vs plain: max|d depth_0|={dd!r} mm "
          f"(bound {DEPTH_TOL_MM}), max|d confidence_2|={dc!r}, "
          f"depth_0 range [{d_k.min().item()!r}, {d_k.max().item()!r}]")
    if not dd < DEPTH_TOL_MM:
        raise AssertionError(f"f32 depth_0 kernel vs plain {dd} mm")
    del fn, args
    return forward_main_path(entry, DEFAULT_FWD, "")


def check_quad_forward(entry) -> dict:
    """The f32 quad forward against the default path, then the bf16 quad
    main path; returns the latter's launches."""
    outs = {}
    for sampling, want in (("auto", DEFAULT_FWD), ("quad", QUAD_FWD)):
        fn, args = sharpened_f32_forward(entry, sampling)
        outs[sampling] = counted(lambda: fn(*args), want,
                                 f"f32 forward sampling={sampling}")
        del fn, args
    dd = (outs["quad"][0] - outs["auto"][0]).abs().max().item()
    dc = (outs["quad"][1] - outs["auto"][1]).abs().max().item()
    print(f"forward f32 sampling=quad vs default: max|d depth_0|={dd!r} mm "
          f"(bound {DEPTH_TOL_MM}), max|d confidence_2|={dc!r}")
    if not dd < DEPTH_TOL_MM:
        raise AssertionError(f"f32 quad depth_0 vs default {dd} mm")
    return forward_main_path(entry, QUAD_FWD, " sampling=quad",
                             sampling="quad")


def time_forward(entry, card, label: str = "", **kw) -> dict:
    """bf16 inference forward at B=1 and 4; returns {batch: ms}."""
    times = {}
    for batch in (1, 4):
        fn, args = entry(DEVICE, torch.bfloat16, batch=batch, img_wh=IMG_WH,
                         **kw)
        fn(*args)
        ms = cuda_ms(lambda: fn(*args), 10)
        print(f"timing forward{label} bf16 B={batch} {IMG_WH[0]}x"
              f"{IMG_WH[1]}x3: {ms!r} ms/forward, "
              f"{batch * 1000.0 / ms!r} maps/s [{card}]")
        times[batch] = ms
        del fn, args
    return times


def check_bwd(kernel_bwd, plain_bwd, inputs2, img_wh=None) -> float:
    """K2 vs its plain version at every level shape of ``img_wh`` (the
    train shape by default), B=2; returns the max f32 abs error."""
    g = torch.Generator(device=DEVICE).manual_seed(2)
    worst = 0.0
    for l, C, D, h, w in levels(img_wh):
        proj, dv = inputs2[l]
        feats = torch.rand((2, 3, h, w, C), generator=g, device=DEVICE)
        for groups in (1, 8):
            name = "variance" if groups == 1 else f"groupwise{groups}"
            go = torch.randn((2, D, h, w, C if groups == 1 else groups),
                             generator=g, device=DEVICE)
            k32 = kernel_bwd(feats, proj, dv, go, groups)
            p32 = plain_bwd(feats, proj, dv, go, groups)
            err = (k32 - p32).abs()
            worst = max(worst, err.max().item())
            f32_ok = bool((err <= BWD_TOL + BWD_TOL * p32.abs()).all())
            fb, gb = feats.to(torch.bfloat16), go.to(torch.bfloat16)
            kb = kernel_bwd(fb, proj, dv, gb, groups).float()
            pb = plain_bwd(fb.float(), proj, dv, gb.float(), groups
                           ).to(torch.bfloat16).float()
            eb = (kb - pb).abs()
            ulps = eb / bf16_ulp(pb)
            bf16_ok = bool((eb <= 2 * bf16_ulp(pb) + BWD_TOL).all())
            print(f"bwd-check L{l} {name} feats={tuple(feats.shape)} "
                  f"f32 max_abs_err={err.max().item()!r} max|grad|="
                  f"{p32.abs().max().item()!r} (bound {BWD_TOL} + "
                  f"{BWD_TOL} rel) bf16 max_ulps={ulps.max().item()!r} "
                  f"elements over 2 ulps={(ulps > 2).sum().item()}/"
                  f"{kb.numel()} max_abs_err={eb.max().item()!r}")
            if not f32_ok:
                raise AssertionError(f"L{l} {name} K2 f32 error {err.max()}")
            if not bf16_ok:
                raise AssertionError(f"L{l} {name} K2 bf16 error")
    # the autograd Function (K1 forward, K2 backward) at L2, f32
    from casmvsnet_pl_tpu_torch.ops import (build_cost_volume,
                                            plain_cost_volume)
    l, C, D, h, w = levels(img_wh)[0]
    proj, dv = inputs2[l]
    feats = torch.rand((2, 3, h, w, C), generator=g, device=DEVICE,
                       requires_grad=True)
    out = build_cost_volume(feats, proj, dv)
    go = torch.randn(out.shape, generator=g, device=DEVICE)
    got, = torch.autograd.grad(out, feats, go)
    ref, = torch.autograd.grad(plain_cost_volume(feats, proj, dv), feats, go)
    err = (got - ref).abs().max().item()
    print(f"autograd Function vs plain autograd L{l} f32: max_abs_err="
          f"{err!r}")
    if not bool(((got - ref).abs() <= BWD_TOL + BWD_TOL * ref.abs()).all()):
        raise AssertionError(f"Function gradient error {err}")
    return worst


def check_train_step(train_entry, plain, want: dict,
                     sampling: str = "auto") -> None:
    """f32 SGD step with the kernels against one with ``plain`` as the cost
    volume, from the same state and batch; the kernel step launches
    exactly ``want``, the plain step only the prob conv's kernel, as the
    kernel step does. Its output is not bit-equal to cuDNN's conv, and a
    change at float32 rounding there moves leaves whose gradient is a sum
    that cancels (BatchNorm biases of the U-Net) by ~5e-3, so both steps
    run it: the cost volume stays the only difference (phase 54 and
    ``tests/test_torch_port_prob_conv.py`` hold the kernel against
    ``F.conv3d``)."""
    runs = {}
    # cuDNN's default conv backward sums in a run-dependent order, which
    # moves some leaves by ~4e-3 between two identical plain steps; its
    # deterministic algorithms leave the cost volume as the only difference.
    torch.backends.cudnn.deterministic = True
    for name, cv in (("kernel", None), ("plain", plain)):
        trainer, state, batch = train_entry(
            DEVICE, torch.float32, img_wh=IMG_WH, optimizer="sgd", lr=1e-2,
            cost_volume=cv, sampling=sampling)
        reset_launches()
        state, logs = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        runs[name] = (float(logs["train/loss"]),
                      {n: p.grad.double() for n, p in
                       state.model.named_parameters()}, launch_counts())
        del trainer, state, batch
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    (lk, gk, nk), (lp, gp, npl) = runs["kernel"], runs["plain"]

    def scale(n):
        # The prob conv's bias gets no gradient in exact arithmetic (the
        # softmax over depth ignores a constant shift), so its leaf is held
        # against the scale of the same conv's weight gradient.
        return gp[n.replace("prob.bias", "prob.weight")].norm()

    worst = max(((gk[n] - gp[n]).norm() / scale(n)).item() for n in gp)
    print(f"train step f32 sampling={sampling} kernel vs plain: loss {lk!r} "
          f"vs {lp!r}, worst gradient leaf relative L2 {worst!r} (bound "
          f"{GRAD_REL_TOL}), launches kernel step {nk}, plain step {npl}")
    expect_counts(nk, want, f"sampling={sampling} kernel step")
    expect_counts(npl, {n: c for n, c in want.items() if n in PROB},
                  f"sampling={sampling} plain step")
    if not abs(lk - lp) <= 1e-5 * abs(lp):
        raise AssertionError(f"loss {lk} vs {lp}")
    if not worst <= GRAD_REL_TOL:
        raise AssertionError(f"gradient leaf relative error {worst}")


def train_main_path(train_entry, card, steps: int, want_per_step: dict,
                    **kw):
    """bf16 Adam at full width on one batch through ``train_entry(**kw)``;
    every loss finite, the last below the first, and the launches exactly
    ``want_per_step`` a step. Returns (trainer, state, batch, launches)."""
    trainer, state, batch = train_entry(DEVICE, img_wh=IMG_WH, **kw)
    reset_launches()
    losses = []
    for _ in range(steps):
        state, logs = trainer.train_step(state, batch)
        losses.append(float(logs["train/loss"]))
    torch.cuda.synchronize()
    counts = launch_counts()
    W, H = IMG_WH
    label = "".join(f" {k}={v}" for k, v in kw.items())
    print(f"train bf16{label} {W}x{H}x3 B=2 adam lr 1e-3, {steps} steps on "
          f"one batch: losses {losses!r}; launches {counts} [{card}]")
    expect_counts(counts, scaled(want_per_step, steps), f"train{label}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite training loss")
    if not losses[-1] < losses[0]:
        raise AssertionError("training loss did not fall")
    return trainer, state, batch, counts


def time_train(trainer, state, batch, card, label: str = "") -> float:
    """bf16 train step: stage times, whole step, peak memory; returns the
    step's ms."""
    from casmvsnet_pl_tpu_torch.engine import model_batch_args
    from casmvsnet_pl_tpu_torch.losses import sl1_loss

    model, opt = state.model, state.optimizer
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    stages = []
    for _ in range(5):
        ev[0].record()
        with trainer._autocast():
            outs = model(*model_batch_args(batch))
        loss = sl1_loss(outs, batch["depths"], batch["masks"])
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        stages.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd, bwd, upd = (sum(x) / len(stages) for x in zip(*stages))
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: trainer.train_step(state, batch), 10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"timing train step{label} bf16 B=2 {IMG_WH[0]}x{IMG_WH[1]}x3 adam: "
          f"{ms!r} ms/step, {2 * 1000.0 / ms!r} samples/s, peak memory "
          f"{peak!r} GiB; stages (mean of 5): forward+loss {fwd!r} ms, "
          f"backward {bwd!r} ms, optimizer {upd!r} ms [{card}]")
    return ms


# --- the quad configuration: TPU kernels #3-#6 ------------------------------

def epilogues():
    """{groups: (kernel, plain, kernel bwd, plain bwd)} for variance (#3/#4)
    and groupwise G=8 (#5/#6); every function takes (..., groups)."""
    from casmvsnet_pl_tpu_torch import kernels as k
    from casmvsnet_pl_tpu_torch.ops import cost_epilogue as ce
    return {
        1: (k.variance_epilogue_cuda,
            lambda r, rows, ws, G: ce.plain_variance_epilogue(r, rows, ws),
            k.variance_epilogue_bwd_cuda,
            lambda r, rows, ws, g, G: ce.plain_variance_epilogue_bwd(
                r, rows, ws, g)),
        8: (k.groupwise_epilogue_cuda, ce.plain_groupwise_epilogue,
            k.groupwise_epilogue_bwd_cuda, ce.plain_groupwise_epilogue_bwd)}


def quad_level_rows(inputs, batch: int, seed: int):
    """Per level: (ref, rows, ws) that ``quad_rows`` builds from random
    features (B, 3, h, w, C) in [0, 1) on the plane scene's rig."""
    from casmvsnet_pl_tpu_torch.ops import quad_rows
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    for l, C, D, h, w in levels():
        proj, dv = inputs[l]
        feats = torch.rand((batch, 3, h, w, C), generator=g, device=DEVICE)
        yield (l, C, D, h, w), quad_rows(feats, proj, dv)[:3]


def check_epilogues(inputs) -> dict:
    """#3 and #5 against their plain versions at every level shape, B=1;
    returns the max f32 abs error by kernel name."""
    worst = {}
    for (l, C, D, h, w), (ref, rows, ws) in quad_level_rows(inputs, 1, 4):
        rb, rowsb = ref.to(torch.bfloat16), rows.to(torch.bfloat16)
        for groups, (kernel, plain, _, _) in epilogues().items():
            k32 = kernel(ref, rows, ws, groups)
            err = (k32 - plain(ref, rows, ws, groups)).abs().max().item()
            worst[kernel.name] = max(worst.get(kernel.name, 0.0), err)
            kb = kernel(rb, rowsb, ws, groups)
            pf = plain(rb.float(), rowsb.float(), ws, groups)
            ulps = ((kb.float() - pf).abs() / bf16_ulp(pf)).max().item()
            print(f"epilogue-check L{l} {kernel.name} rows="
                  f"{tuple(rows.shape)} out={tuple(k32.shape)} f32 "
                  f"max_abs_err={err!r} (bound {EPI_TOL}) bf16 max_ulps="
                  f"{ulps!r} (bound 1)")
            if not err <= EPI_TOL:
                raise AssertionError(f"L{l} {kernel.name} f32 error {err}")
            if not ulps <= 1.0:
                raise AssertionError(f"L{l} {kernel.name} bf16 {ulps} ulp")
        del ref, rows, ws, rb, rowsb
    return worst


def check_epilogues_bwd(inputs2) -> dict:
    """#4 and #6 against their plain versions at every level shape, B=2, on
    d ref, d rows and d ws; returns the max f32 abs error by kernel name."""
    g = torch.Generator(device=DEVICE).manual_seed(5)
    worst = {}
    for (l, C, D, h, w), (ref, rows, ws) in quad_level_rows(inputs2, 2, 6):
        rb, rowsb = ref.to(torch.bfloat16), rows.to(torch.bfloat16)
        for groups, (_, _, kernel, plain) in epilogues().items():
            go = torch.randn((2, D, h * w, C if groups == 1 else groups),
                             generator=g, device=DEVICE)
            got = kernel(ref, rows, ws, go, groups)
            want = plain(ref, rows, ws, go, groups)
            errs, over = [], []
            for a, b in zip(got, want):
                e = (a - b).abs()
                errs.append(e.max().item())
                if not bool((e <= EPI_TOL + EPI_TOL * b.abs()).all()):
                    raise AssertionError(f"L{l} {kernel.name} f32 error")
            del got, want
            gb = go.to(torch.bfloat16)
            got = kernel(rb, rowsb, ws, gb, groups)
            want = plain(rb.float(), rowsb.float(), ws, gb.float(), groups)
            for a, b in zip(got, want):
                b = b.to(a.dtype).float()
                e = (a.float() - b).abs()
                over.append((e > 2 * bf16_ulp(b) + EPI_TOL).sum().item())
            del got, want
            worst[kernel.name] = max([worst.get(kernel.name, 0.0)] + errs)
            print(f"epilogue-bwd-check L{l} {kernel.name} rows="
                  f"{tuple(rows.shape)} f32 max_abs_err d ref/d rows/d ws="
                  f"{errs!r} (bound {EPI_TOL} + {EPI_TOL} rel) bf16 elements "
                  f"over 2 ulps + {EPI_TOL}: {over}")
            if any(over):
                raise AssertionError(f"L{l} {kernel.name} bf16 error")
        del ref, rows, ws, rb, rowsb
    return worst


# --- kernel timing ----------------------------------------------------------

def time_level(sums: dict, name: str, label: str, run_k, run_p, iters,
               work, card, note: str = "", least=None) -> None:
    """Time a kernel against its plain version on one level's inputs, in
    turns plain/kernel/kernel/plain (``iters`` = calls per turn, kernel and
    plain), print both beside the bound of ``work`` = (bytes, float32
    operations), or ``least`` = (bound ms, what sets it) where given, and
    add the times and the work into ``sums[name]``."""
    k_iters, p_iters = iters
    p1 = cuda_ms(run_p, p_iters)
    k1 = cuda_ms(run_k, k_iters)
    k2 = cuda_ms(run_k, k_iters)
    p2 = cuda_ms(run_p, p_iters)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    nbytes, flops = work
    b_ms, by = least or bound(nbytes, flops)
    print(f"timing {name} {label}: kernel {k_ms!r} ms ({k1!r}, {k2!r}), "
          f"plain {p_ms!r} ms ({p1!r}, {p2!r}); {note}bound {b_ms!r} ms by "
          f"{by} ({nbytes / 1e6!r} MB, {flops / 1e9!r} GFLOP) -> "
          f"{nbytes / 1e9 / k_ms!r} TB/s, {100 * b_ms / k_ms!r} % of bound "
          f"[{card}]")
    acc = sums.get(name, (0.0, 0.0, 0.0, 0.0))
    sums[name] = tuple(a + b for a, b in zip(acc, (k_ms, p_ms, nbytes,
                                                    flops)))


def time_kernels(inputs, inputs2, card) -> dict:
    """Every kernel against its plain version per level, bf16: K1 and #3/#5
    at B=1, K2 and #4/#6 at B=2 (K1/K2 variance, the epilogues variance and
    G=8). Returns by wrapper name the sums over the levels of the kernel
    and plain times, and the bound of the summed work with what sets it."""
    from casmvsnet_pl_tpu_torch import kernels as k
    from casmvsnet_pl_tpu_torch.ops import (plain_cost_volume,
                                            plain_cost_volume_bwd)
    g = torch.Generator(device=DEVICE).manual_seed(1)
    sums = {}
    for l, C, D, h, w in levels():
        proj, dv = inputs[l]
        fb = torch.rand((1, 3, h, w, C), generator=g,
                        device=DEVICE).to(torch.bfloat16)
        out_mb = D * h * w * C * 2 / 1e6
        time_level(sums, "cost_volume_cuda", f"L{l} bf16 (1,{D},{h},{w},{C})",
                   lambda: k.cost_volume_cuda(fb, proj, dv),
                   lambda: plain_cost_volume(fb, proj, dv), (50, 5),
                   cv_work(1, 3, D, h, w, C, 1, 2), card,
                   f"output write {out_mb!r} MB; ")
        proj, dv = inputs2[l]
        fb = torch.rand((2, 3, h, w, C), generator=g,
                        device=DEVICE).to(torch.bfloat16)
        gb = torch.randn((2, D, h, w, C), generator=g,
                         device=DEVICE).to(torch.bfloat16)
        adds = 2 * D * h * w * 2 * 4 * C
        time_level(sums, "cost_volume_bwd_cuda",
                   f"L{l} bf16 feats (2,3,{h},{w},{C}) D={D}",
                   lambda: k.cost_volume_bwd_cuda(fb, proj, dv, gb),
                   lambda: plain_cost_volume_bwd(fb, proj, dv, gb), (20, 3),
                   cv_work(2, 3, D, h, w, C, 1, 2, backward=True), card,
                   f"{adds / 1e9!r} G f32 tap shares (before runs); ")
    for batch, data in ((1, inputs), (2, inputs2)):
        backward = batch == 2
        for (l, C, D, h, w), (ref, rows, ws) in quad_level_rows(data, batch,
                                                                8 + batch):
            rb, rowsb = ref.to(torch.bfloat16), rows.to(torch.bfloat16)
            del ref, rows
            S = rowsb.shape[1]
            for groups, (kf, pf, kb, pb) in epilogues().items():
                if backward:
                    go = torch.randn((batch, D, h * w,
                                      C if groups == 1 else groups),
                                     generator=g, device=DEVICE).to(
                                         torch.bfloat16)
                    kernel, plain, args = kb, pb, (rb, rowsb, ws, go, groups)
                else:
                    kernel, plain, args = kf, pf, (rb, rowsb, ws, groups)
                time_level(sums, kernel.name,
                           f"L{l} bf16 rows {tuple(rowsb.shape)}",
                           lambda: kernel(*args), lambda: plain(*args),
                           (20, 3), epilogue_work(batch, S, D, h * w, C,
                                                  groups, 2, backward), card)
            del rb, rowsb, ws
    return {name: (k_ms, p_ms, *bound(nbytes, flops))
            for name, (k_ms, p_ms, nbytes, flops) in sums.items()}


def time_k1_shapes(kernel, card, k1) -> dict:
    """Phase 18: K1 alone at B=2 variance (the train step's forward), B=1
    G=8 and the eval configuration, per level beside its bound (the module
    ``k1``, ``probes/k1.py::time_cases``); returns {case: (ms, bound
    ms)}."""
    table = k1.time_cases({kernel.name: kernel}, ("step", "g8", "eval"),
                          DEVICE, card)
    return {case: (row[kernel.name]["ms"], row[kernel.name]["bound_ms"])
            for case, row in table.items()}


# --- the prob conv: CostRegNet's 8 -> 1 last layer (phase 54) ---------------

# The kernel and cuDNN sum the 216 products in float32 in different orders:
# f32 within 1e-5 of sum |w x| + |bias|; a bf16 output is one rounding of
# that sum, within one bf16 ulp of the float32 conv (or within the f32
# bound, where cancellation leaves a value whose ulp is below it)
PROB_TOL = 1e-5


def prob_conv_cases():
    """(case, level, B, D, h, w, the parameters' dtype) of the main path's
    prob convs: eval's three levels (B=1, bf16 parameters) and the train
    step's (B=2, float32 parameters, as under autocast)."""
    for case, img_wh, B, pdtype in (("eval", EVAL_WH, 1, torch.bfloat16),
                                    ("step", IMG_WH, 2, torch.float32)):
        for l, _, D, h, w in levels(img_wh):
            yield case, l, B, D, h, w, pdtype


def prob_conv_work(B, D, h, w, itemsize):
    """(bytes, float32 operations): 8 channels in and 1 out, each once; 216
    multiply-adds a voxel."""
    n = B * D * h * w
    return n * 9 * itemsize, 2.0 * 216 * n


def prob_conv_phase(card) -> tuple[float, dict]:
    """Phase 54: the prob conv's kernel against ``F.conv3d`` (TF32 off) at
    every shape of ``prob_conv_cases`` (f32 input and parameters; bf16
    input with the case's parameters), then against cuDNN's bf16 conv (the
    plain version and the library call it replaced, given bf16 parameters
    as autocast hands them) in turns, beside its bound. Returns the largest
    f32 error and, by case, the sums over the three levels: (kernel ms,
    cuDNN ms, bound ms, bound by, byte bound ms)."""
    import torch.nn.functional as F
    from casmvsnet_pl_tpu_torch.kernels import prob_conv_cuda

    def conv(x, w, b):
        return F.conv3d(x, w, b, 1, 1)[:, 0]

    g = torch.Generator(device=DEVICE).manual_seed(5)
    worst, sums = 0.0, {}
    for case, l, B, D, h, w, pdtype in prob_conv_cases():
        x = torch.randn((B, D, h, w, 8), generator=g,
                        device=DEVICE).permute(0, 4, 1, 2, 3)
        wt = torch.randn((1, 8, 3, 3, 3), generator=g,
                         device=DEVICE) * 216 ** -0.5
        b = torch.randn((1,), generator=g, device=DEVICE)
        err = (prob_conv_cuda(x, wt, b) - conv(x, wt, b)).abs()
        over32 = (err > PROB_TOL * conv(x.abs(), wt.abs(), b.abs())).sum()
        err32 = err.max().item()
        worst = max(worst, err32)
        xb, wp, bp = x.to(torch.bfloat16), wt.to(pdtype), b.to(pdtype)
        del x, err
        ref = conv(xb.float(), wp.float(), bp.float())
        tol = torch.maximum(PROB_TOL * conv(xb.float().abs(), wp.float().abs(),
                                            bp.float().abs()), bf16_ulp(ref))
        eb = (prob_conv_cuda(xb, wp, bp).float() - ref).abs()
        ulps = (eb / bf16_ulp(ref)).max().item()
        over16 = (eb > tol).sum()
        print(f"prob-conv-check {case} L{l} (B, D, h, w) {(B, D, h, w)}: f32 "
              f"max_abs_err={err32!r}, voxels beyond {PROB_TOL} x "
              f"(sum|w x| + |b|) {over32.item()}; bf16 x, {str(pdtype)[6:]} "
              f"parameters: max ulps of the f32 conv {ulps!r}, voxels beyond "
              f"one ulp and the f32 bound {over16.item()}/{eb.numel()}")
        if over32.item() or over16.item():
            raise AssertionError(f"prob conv {case} L{l} differs from "
                                 "F.conv3d")
        del ref, tol, eb
        wb, bb = wp.to(torch.bfloat16), bp.to(torch.bfloat16)
        time_level(sums, f"prob_conv {case}", f"L{l} bf16 "
                   f"{(B, 8, D, h, w)} parameters {str(pdtype)[6:]}",
                   lambda: prob_conv_cuda(xb, wp, bp),
                   lambda: F.conv3d(xb, wb, bb, 1, 1), (50, 5),
                   prob_conv_work(B, D, h, w, 2), card, "plain = cuDNN; ")
        del xb
    out = {}
    for name, (k_ms, p_ms, nbytes, flops) in sums.items():
        b_ms, by = bound(nbytes, flops)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        case = name.split()[1]
        print(f"{name}, sum over the 3 level shapes: kernel "
              f"{k_ms!r} ms, cuDNN {p_ms!r} ms; bound {b_ms!r} ms by {by} -> "
              f"{100 * b_ms / k_ms!r} %; byte bound {byte_ms!r} ms -> "
              f"{100 * byte_ms / k_ms!r} % [{card}]")
        out[case] = (k_ms, p_ms, b_ms, by, byte_ms)
    torch.cuda.empty_cache()
    return worst, out


# --- the ARF's deformable conv: TransMVSNet's DCNv2 3x3 (phase 55) --------

# The kernel and the plain version sum in float32 in different orders: f32
# within 1e-5 of the sum of |terms| (the plain version on |x| and |w|, whose
# samples bound the samples' magnitudes); a bf16 output is one rounding of
# that sum, within one bf16 ulp of the float32 result (or that f32 bound
# where cancellation leaves a value whose ulp is below it)
DCN_TOL = 1e-5


def deform_conv_cases(img_wh=None):
    """(level, N, C, h, w) of TransMVSNet's ARF at eval's 1152x864x5."""
    W, H = img_wh or EVAL_WH
    return [(l, EVAL_VIEWS, C, H >> l, W >> l)
            for l, C in enumerate((8, 16, 32))]


def deform_conv_inputs(N, C, h, w, g):
    """x (N, C, h, w) and the raw offset-and-mask conv output (N, 27, h,
    w), both channels_last, offsets of about a pixel; weight (C, C, 3, 3)
    Kaiming-normal."""
    x = torch.randn((N, h, w, C), generator=g, device=DEVICE)
    om = torch.randn((N, h, w, 27), generator=g, device=DEVICE)
    wt = torch.randn((C, C, 3, 3), generator=g, device=DEVICE) * (
        2.0 / (9 * C)) ** 0.5
    return x.permute(0, 3, 1, 2), om.permute(0, 3, 1, 2), wt


def deform_conv_phase(card) -> tuple[float, dict]:
    """Phase 55: the deformable conv's kernel against its plain version at
    the three levels' shapes of 1152x864x5 (f32 x, offsets and weight; then
    bf16 x, offsets and weight against the f32 plain version of the same
    bf16 values), then timed against the plain version in turns, beside
    its bound (``perfbench/counts/deform_conv.py``). Returns the largest
    f32 error and the sums over the three levels: (kernel ms, plain ms,
    the levels' bounds in ms, what sets each)."""
    from casmvsnet_pl_tpu_torch.kernels import deform_conv_cuda
    from casmvsnet_pl_tpu_torch.ops.deform_conv import plain_deform_conv
    from perfbench.counts.deform_conv import dcn_bound_s, dcn_work

    g = torch.Generator(device=DEVICE).manual_seed(7)
    worst, sums, least_ms, bound_by = 0.0, {}, 0.0, []
    for l, N, C, h, w in deform_conv_cases():
        x, om, wt = deform_conv_inputs(N, C, h, w, g)
        with torch.no_grad():
            terms = plain_deform_conv(x.abs(), om, wt.abs()).float()
            err = (deform_conv_cuda(x, om, wt).float()
                   - plain_deform_conv(x, om, wt).float()).abs()
            over32 = (err > DCN_TOL * terms).sum().item()
            err32 = err.max().item()
            worst = max(worst, err32)
            del err, terms
            xb, ob, wb = (t.to(torch.bfloat16) for t in (x, om, wt))
            del x, om, wt
            ref = plain_deform_conv(xb.float(), ob.float(), wb.float())
            tol = torch.maximum(DCN_TOL * plain_deform_conv(
                xb.float().abs(), ob.float(), wb.float().abs()),
                bf16_ulp(ref))
            eb = (deform_conv_cuda(xb, ob, wb).float() - ref).abs()
            ulps = (eb / bf16_ulp(ref)).max().item()
            over16 = (eb > tol).sum().item()
        print(f"deform-conv-check L{l} (N, C, h, w) {(N, C, h, w)}: f32 "
              f"max_abs_err={err32!r}, values beyond {DCN_TOL} x sum|terms| "
              f"{over32}; bf16: max ulps of the f32 result {ulps!r}, values "
              f"beyond one ulp and the f32 bound {over16}/{eb.numel()}")
        if over32 or over16:
            raise AssertionError(f"deform conv L{l} differs from its plain "
                                 "version")
        del ref, tol, eb
        nbytes, ops, tensor_ops = dcn_work(N, h, w, C, 2)
        b_s, by = dcn_bound_s(N, h, w, C, 2)
        least_ms += 1e3 * b_s
        bound_by.append(f"L{l} {by}")
        time_level(sums, "deform_conv", f"L{l} bf16 {(N, C, h, w)}",
                   lambda: deform_conv_cuda(xb, ob, wb),
                   lambda: plain_deform_conv(xb, ob, wb), (20, 2),
                   (nbytes, ops + tensor_ops), card,
                   f"tensor cores {tensor_ops / 1e9!r} GFLOP; ",
                   (1e3 * b_s, by))
        del xb, ob, wb
        torch.cuda.empty_cache()
    k_ms, p_ms = sums["deform_conv"][:2]
    by = ", ".join(bound_by)
    print(f"deform_conv, sum over the 3 level shapes (one conv each): kernel "
          f"{k_ms!r} ms, plain {p_ms!r} ms; bound {least_ms!r} ms ({by}) -> "
          f"{100 * least_ms / k_ms!r} % [{card}]")
    return worst, (k_ms, p_ms, least_ms, by)


# --- the deformable conv's backward: TransMVSNet's training (phase 58) -----

# float32: the kernel and the plain autograd sum in different orders (the
# weight's gradient over millions of pixels, the input's by atomics): each
# gradient within 1e-4 of its largest magnitude; bf16: one rounding of the
# float32 sums, within two bf16 ulps of the plain float32 gradients of the
# same bf16 values and that bound
DCN_BWD_TOL = 1e-4
TRAIN_VIEWS = 5


def deform_conv_bwd_cases(img_wh=None):
    """(level, N, C, h, w) of TransMVSNet's ARF in the training cell: B=2
    scenes of 5 views at 640x512."""
    W, H = img_wh or IMG_WH
    return [(l, 2 * TRAIN_VIEWS, C, H >> l, W >> l)
            for l, C in enumerate((8, 16, 32))]


def plain_deform_grads(x, om, wt, gy):
    """The plain version's gradients of (x, offsets and masks, weight) for
    the output gradient gy, in float32."""
    from casmvsnet_pl_tpu_torch.ops.deform_conv import plain_deform_conv
    leaves = [t.detach().float().requires_grad_() for t in (x, om, wt)]
    with torch.enable_grad():
        y = plain_deform_conv(*leaves)
        return torch.autograd.grad(y, leaves, gy.float())


def deform_conv_bwd_phase(card) -> tuple[float, tuple]:
    """Phase 58: the deformable conv's backward kernel against the plain
    version's autograd at the training cell's three level shapes (f32, then
    bf16 against the f32 plain gradients of the same bf16 values), then
    timed in bf16 against the plain forward and backward in turns, beside
    its bound (``perfbench/counts/deform_conv_bwd.py``). Returns the largest
    f32 error over the largest gradient, and the sums over the three
    levels: (kernel ms, plain ms, the levels' bounds in ms, what sets
    each)."""
    from casmvsnet_pl_tpu_torch.kernels import deform_conv_bwd_cuda
    from perfbench.counts.deform_conv_bwd import dcn_bwd_bound_s, dcn_bwd_work

    g = torch.Generator(device=DEVICE).manual_seed(58)
    worst, sums, least_ms, bound_by = 0.0, {}, 0.0, []
    names = ("x", "offset_mask", "weight")
    for l, N, C, h, w in deform_conv_bwd_cases():
        x, om, wt = deform_conv_inputs(N, C, h, w, g)
        gy = torch.randn((N, h, w, C), generator=g,
                         device=DEVICE).permute(0, 3, 1, 2)
        with torch.no_grad():
            got = deform_conv_bwd_cuda(x, om, wt, gy)
        want = plain_deform_grads(x, om, wt, gy)
        report = []
        for name, a, b in zip(names, got, want):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item() / max(scale, 1e-30)
            worst = max(worst, err)
            report.append(f"{name} {err!r}")
            if not err <= DCN_BWD_TOL:
                raise AssertionError(f"deform conv backward L{l} f32 {name}:"
                                     f" {err!r} of its largest gradient")
        del got, want
        xb, ob, wb, gb = (t.to(torch.bfloat16) for t in (x, om, wt, gy))
        del x, om, wt, gy
        with torch.no_grad():
            got = deform_conv_bwd_cuda(xb, ob, wb, gb)
        want = plain_deform_grads(xb, ob, wb, gb)
        ulps = []
        for name, a, b in zip(names, got, want):
            if a.dtype != torch.bfloat16:
                raise AssertionError(f"{name}'s gradient is {a.dtype}")
            e = (a.float() - b).abs()
            ulps.append(f"{name} {(e / bf16_ulp(b)).max().item()!r}")
            if not bool((e <= 2 * bf16_ulp(b) + DCN_BWD_TOL
                         * b.abs().max()).all()):
                raise AssertionError(f"deform conv backward L{l} bf16 {name}"
                                     " beyond two ulps and the f32 bound")
        print(f"deform-conv-bwd-check L{l} (N, C, h, w) {(N, C, h, w)}: f32 "
              f"max error over the largest gradient: {', '.join(report)}; "
              f"bf16 max ulps of the f32 plain gradients: {', '.join(ulps)}")
        del got, want
        deform_conv_bwd_cuda.reset_spill_counts()
        with torch.no_grad():
            deform_conv_bwd_cuda(xb, ob, wb, gb)
        scatter = deform_conv_bwd_cuda.spill_counts()
        nbytes, ops, tensor_ops = dcn_bwd_work(N, h, w, C, 2)
        b_s, by = dcn_bwd_bound_s(N, h, w, C, 2)
        least_ms += 1e3 * b_s
        bound_by.append(f"L{l} {by}")
        before_ms = sums.get("deform_conv_bwd", (0.0,))[0]
        time_level(sums, "deform_conv_bwd", f"L{l} bf16 {(N, C, h, w)}",
                   lambda: deform_conv_bwd_cuda(xb, ob, wb, gb),
                   lambda: plain_deform_grads(xb, ob, wb, gb), (10, 2),
                   (nbytes, ops + tensor_ops), card,
                   "plain: the plain forward and its autograd backward; "
                   f"tensor cores {tensor_ops / 1e9!r} GFLOP; ",
                   (1e3 * b_s, by))
        print_scatter(f"L{l} bf16 {(N, C, h, w)}", scatter, C, N * h * w,
                      f"kernel {sums['deform_conv_bwd'][0] - before_ms!r} ms, "
                      f"bound {1e3 * b_s!r} ms; ", card)
        del xb, ob, wb, gb
        torch.cuda.empty_cache()
    k_ms, p_ms = sums["deform_conv_bwd"][:2]
    by = ", ".join(bound_by)
    print(f"deform_conv_bwd, sum over the 3 level shapes (one conv each): "
          f"kernel {k_ms!r} ms, plain {p_ms!r} ms; bound {least_ms!r} ms "
          f"({by}) -> {100 * least_ms / k_ms!r} % [{card}]")
    return worst, (k_ms, p_ms, least_ms, by)


def print_scatter(label: str, scatter, C: int, pixels: int, note: str,
                  card) -> None:
    """A ``deform-conv-bwd-scatter`` line: the binned scatter's spill share
    and its global float atomics on d_x a pixel (a spilled share's C, and
    the windows' sums), against the C of each share that the unbinned
    scatter added."""
    spilled, shares, window_floats = scatter
    print(f"deform-conv-bwd-scatter {label}: {note}spill share "
          f"{100 * spilled / max(shares, 1)!r} % ({spilled} of {shares} "
          f"shares), global float atomics on d_x a pixel "
          f"{(spilled * C + window_floats) / pixels!r} (windows' "
          f"{window_floats / pixels!r}), every share's "
          f"{shares * C / pixels!r} [{card}]")


def arf_cell_scatter(card) -> None:
    """The binned scatter at the ARF's own offsets: the training cell's
    model (``perfbench``'s weights of a seed, its traffic's batches, B=2 x 5
    views at 640x512) after its warm-up steps, then one step read a conv at
    a time (``deform-conv-bwd-scatter cell`` lines: each level's three convs
    and the step)."""
    from casmvsnet_pl_tpu_torch.ops import deform_conv as dc_ops
    from perfbench import program, scenes
    from perfbench.harness import load_json
    cfg = load_json("configs", "transmvsnet_train.json")
    mix = load_json("traffic", "train_640x512x5_b2.json")
    B, first, seed = mix["batch"], mix["compared_steps"], 2 ** 31 + 58
    tr, state = program.trainer(cfg, program.draw_weights(cfg, seed, DEVICE),
                                DEVICE)
    batches = [scenes.make_batch(seed, range(j * B, (j + 1) * B),
                                 tuple(mix["img_wh"]), mix["n_views"],
                                 mix["focal"], cfg, DEVICE)
               for j in range(first + 1)]
    for j in range(first):
        state, _ = tr.train_step(state, batches[j])
    kernel, by_shape = dc_ops.deform_conv_bwd_cuda, {}

    def counted(x, om, w, g):
        kernel.reset_spill_counts()
        out = kernel(x, om, w, g)
        sums = by_shape.setdefault(tuple(x.shape), [0, 0, 0])
        for i, v in enumerate(kernel.spill_counts()):
            sums[i] += v
        return out
    dc_ops.deform_conv_bwd_cuda = counted
    try:
        state, _ = tr.train_step(state, batches[first])
    finally:
        dc_ops.deform_conv_bwd_cuda = kernel
    spilled = shares = 0
    for (N, C, h, w), sums in sorted(by_shape.items()):
        print_scatter(f"cell, after {first} steps, the 3 convs at "
                      f"{(N, C, h, w)}", sums, C, 3 * N * h * w, "", card)
        spilled, shares = spilled + sums[0], shares + sums[1]
    print(f"deform-conv-bwd-scatter cell step: spill share "
          f"{100 * spilled / max(shares, 1)!r} % ({spilled} of {shares} "
          f"shares) [{card}]")
    del tr, state, batches
    torch.cuda.empty_cache()


def transmvsnet_train_path(train_entry, card) -> dict:
    """TransMVSNet's bf16 Adam steps at 640x512x3 B=2 through
    ``train_entry(arch="transmvsnet")``; launches exactly ``TRANS_STEP`` a
    step, the loss falling."""
    trainer, state, batch, counts = train_main_path(
        train_entry, card, TRANS_TRAIN_STEPS, TRANS_STEP, arch="transmvsnet")
    del trainer, state, batch
    torch.cuda.empty_cache()
    return counts


# --- the FMT's LoFTR layer: TransMVSNet's Feature Matching Transformer (56) --

# float32: each product runs as three bf16 products (hi hi, lo hi, hi lo),
# within ~2^-16 of its terms, and the LayerNorms bring the outputs to unit
# scale: 2e-4 a layer, 8e-4 over the eight layers one after the other (as
# tests/test_torch_port_fmt_layer.py); bf16: the kernel rounds once a
# layer, the plain bf16 layer after every operator, so the kernel is no
# farther from the float32 layers
FMT_F32_TOL = 8e-4
FMT_BF16_FACTOR = 1.0


def fmt_layer_inputs(g):
    """The eval shape's FMT input (1, 5, 62208, 32), unit normal, and its
    eight layers' weights: Linear N(0, 1 / fan_in), LayerNorm weights
    1 + N(0, 0.3), biases N(0, 0.3), in ``ops/fmt_layer.py``'s order."""
    from casmvsnet_pl_tpu_torch.kernels.fmt_layer import WEIGHT_SHAPES
    W, H = EVAL_WH
    x = torch.randn((1, EVAL_VIEWS, (H >> 2) * (W >> 2), 32), generator=g,
                    device=DEVICE)
    layers = []
    for _ in range(8):
        ws = []
        for i, shape in enumerate(WEIGHT_SHAPES):
            r = torch.randn(shape, generator=g, device=DEVICE)
            ws.append(r / shape[1] ** 0.5 if i < 6 else
                      (1.0 if i in (6, 8) else 0.0) + 0.3 * r)
        layers.append(ws)
    return x, layers


def plain_fmt(x, layers):
    """The eight layers' plain versions over views x (B, V, L, C), self
    and cross in turn, in x's dtype, on x's device."""
    from casmvsnet_pl_tpu_torch.ops.fmt_layer import plain_fmt_views
    for i, ws in enumerate(layers):
        x = plain_fmt_views(x, ws, 8, bool(i % 2))
    return x


def fmt_layer_phase(card) -> tuple[float, tuple]:
    """Phase 56: the FMT's eight layers at the eval shape through the
    kernel against their plain versions (f32; bf16 against the plain bf16
    layers' own gap to f32), then timed in bf16 against the plain layers
    in turns, beside their bound. Returns the largest f32 error and
    (kernel ms, plain ms, bound ms, what sets it)."""
    from casmvsnet_pl_tpu_torch.kernels import fmt_layer_cuda
    from perfbench.counts.fmt_layer import fmt_bound_s, fmt_layers, \
        layer_work
    from perfbench.harness import load_json

    def kernel_fmt(x, layers):
        for i, ws in enumerate(layers):
            fmt_layer_cuda(x, ws, 8, bool(i % 2))
        return x

    g = torch.Generator(device=DEVICE).manual_seed(56)
    x, layers = fmt_layer_inputs(g)
    with torch.no_grad():
        err32 = (kernel_fmt(x.clone(), layers)
                 - plain_fmt(x, layers)).abs().max().item()
        xb = x.to(torch.bfloat16)
        lb = [[w.to(torch.bfloat16) for w in ws] for ws in layers]
        exact = plain_fmt(xb.float(), [[w.float() for w in ws] for ws in lb])
        gap = (kernel_fmt(xb.clone(), lb).float() - exact).abs()
        module = (plain_fmt(xb, lb).float() - exact).abs()
        print(f"fmt-layer-check 8 layers (1, 5, 62208, 32): f32 "
              f"max_abs_err={err32!r} (tolerance {FMT_F32_TOL}); bf16 gap "
              f"to f32 max {gap.max().item()!r} mean {gap.mean().item()!r}, "
              f"the plain bf16 layers' max {module.max().item()!r} mean "
              f"{module.mean().item()!r}")
        if err32 > FMT_F32_TOL or gap.max() > FMT_BF16_FACTOR * module.max():
            raise AssertionError("the FMT layer differs from its plain "
                                 "version")
        del x, exact, gap, module
        cfg = load_json("configs", "transmvsnet.json")
        nbytes = ops = tensor_ops = 0
        for n, s, cross in fmt_layers(cfg, EVAL_WH, EVAL_VIEWS, 1):
            b, c, t = layer_work(n, s, 32, 8, cross)
            nbytes, ops, tensor_ops = nbytes + b, ops + c, tensor_ops + t
        b_ms = 1e3 * fmt_bound_s(cfg, EVAL_WH, EVAL_VIEWS, 1)
        sums = {}
        buf = xb.clone()
        time_level(sums, "fmt_layer", "bf16 8 layers (1, 5, 62208, 32)",
                   lambda: kernel_fmt(buf, lb), lambda: plain_fmt(xb, lb),
                   (20, 3), (nbytes, ops + tensor_ops), card,
                   f"tensor cores {tensor_ops / 1e9!r} GFLOP; ",
                   (b_ms, "bytes"))
    k_ms, p_ms = sums["fmt_layer"][:2]
    torch.cuda.empty_cache()
    return err32, (k_ms, p_ms, b_ms, "bytes")


# --- CostRegNet's one-channel input block: conv 1 -> 8, BN, leaky (57) -----

# float32: x and the weights go into the tensor cores as bf16 hi + lo, each
# product within 3 x 2^-16 of its size, the sums float32: within 2^-14 of
# the terms' sizes (tests/test_torch_port_in_conv.py); bf16: exact products,
# one rounding of the float32 sum
IN_CONV_TOL = 2.0 ** -14


def in_conv_block(g, dtype):
    """``ConvBnAct(1, 8)`` in eval mode on the card: weight N(0, 1/27),
    BatchNorm's gamma +-U(0.5, 2), beta and mean N(0, 0.5), var U(0.25, 4)."""
    from casmvsnet_pl_tpu_torch.models.blocks import ConvBnAct
    m = ConvBnAct(1, 8, dims=3).eval().to(DEVICE)
    sign = torch.tensor([1.0, -1.0] * 4, device=DEVICE)
    with torch.no_grad():
        m.conv.weight.copy_(torch.randn((8, 1, 3, 3, 3), generator=g,
                                        device=DEVICE) * 27 ** -0.5)
        m.bn.weight.copy_((0.5 + 1.5 * torch.rand(8, generator=g,
                                                  device=DEVICE)) * sign)
        m.bn.bias.copy_(0.5 * torch.randn(8, generator=g, device=DEVICE))
        m.bn.running_mean.copy_(0.5 * torch.randn(8, generator=g,
                                                  device=DEVICE))
        m.bn.running_var.copy_(0.25 + 3.75 * torch.rand(8, generator=g,
                                                        device=DEVICE))
    return m.to(dtype)


def in_conv_phase(card) -> tuple[float, tuple]:
    """Phase 57: the input block's kernel against ``plain_in_conv`` at
    eval's three level shapes (f32; bf16 x and parameters against the f32
    block of the same bf16 values), then timed in bf16 against cuDNN's
    conv + BatchNorm + leaky ReLU in turns, beside its bound. Returns the
    largest f32 error and the sums over the three levels: (kernel ms, plain
    ms, bound ms, what sets it)."""
    import torch.nn.functional as F
    from casmvsnet_pl_tpu_torch.kernels import in_conv_cuda
    from casmvsnet_pl_tpu_torch.ops.in_conv import in_conv, plain_in_conv
    from perfbench.counts.in_conv import in_conv_bound_s, in_conv_work

    def terms(x, m):
        scale = (m.bn.weight.float()
                 / torch.sqrt(m.bn.running_var.float() + m.bn.eps))
        conv = F.conv3d(x.float().abs(), m.conv.weight.float().abs(), None,
                        1, 1)
        return (conv * scale.abs().view(1, 8, 1, 1, 1)
                + (m.bn.running_mean.float() * scale).abs().view(1, 8, 1, 1, 1)
                + m.bn.bias.float().abs().view(1, 8, 1, 1, 1))

    g = torch.Generator(device=DEVICE).manual_seed(57)
    worst, sums, least_ms, bound_by = 0.0, {}, 0.0, []
    for l, _, D, h, w in levels(EVAL_WH):
        x = torch.randn((1, D, h, w, 1), generator=g,
                        device=DEVICE).permute(0, 4, 1, 2, 3)
        m = in_conv_block(g, torch.float32)
        with torch.no_grad():
            err = (in_conv(x, m.conv, m.bn)
                   - plain_in_conv(x, m.conv, m.bn)).abs()
            over32 = (err > IN_CONV_TOL * terms(x, m)).sum().item()
            err32 = err.max().item()
            worst = max(worst, err32)
            del err
            xb, mb = x.to(torch.bfloat16), copy.deepcopy(m).to(torch.bfloat16)
            m.load_state_dict({k: v.float() for k, v in
                               mb.state_dict().items()})
            ref = plain_in_conv(xb.float(), m.conv, m.bn)
            tol = torch.maximum(IN_CONV_TOL * terms(xb, m), bf16_ulp(ref))
            got = in_conv(xb, mb.conv, mb.bn)
            layout = got.is_contiguous(memory_format=torch.channels_last_3d)
            eb = (got.float() - ref).abs()
            ulps = (eb / bf16_ulp(ref)).max().item()
            over16 = (eb > tol).sum().item()
            del got, ref, tol, eb, x
        print(f"in-conv-check L{l} (B, D, h, w) {(1, D, h, w)}: f32 "
              f"max_abs_err={err32!r}, values beyond {IN_CONV_TOL!r} x "
              f"terms {over32}; bf16: max ulps of the f32 block {ulps!r}, "
              f"values beyond one ulp and the f32 bound "
              f"{over16}/{8 * D * h * w}; channels_last_3d {layout}")
        if over32 or over16 or not layout:
            raise AssertionError(f"in conv L{l} differs from its plain "
                                 "version")
        b_s, by = in_conv_bound_s(1, D, h, w, 2)
        least_ms += 1e3 * b_s
        bound_by.append(f"L{l} {by}")
        with torch.no_grad():
            time_level(sums, "in_conv", f"L{l} bf16 {(1, 1, D, h, w)}",
                       lambda: in_conv_cuda(xb, mb.conv.weight, mb.bn.weight,
                                            mb.bn.bias, mb.bn.running_mean,
                                            mb.bn.running_var, mb.bn.eps),
                       lambda: plain_in_conv(xb, mb.conv, mb.bn), (50, 10),
                       in_conv_work(1, D, h, w, 2), card,
                       "plain = cuDNN conv + BN + leaky; ", (1e3 * b_s, by))
        del xb
        torch.cuda.empty_cache()
    k_ms, p_ms = sums["in_conv"][:2]
    by = ", ".join(bound_by)
    print(f"in_conv, sum over the 3 level shapes: kernel {k_ms!r} ms, "
          f"cuDNN conv + BN + leaky {p_ms!r} ms; bound {least_ms!r} ms ({by}) "
          f"-> {100 * least_ms / k_ms!r} % [{card}]")
    return worst, (k_ms, p_ms, least_ms, by)


def transmvsnet_path(entry) -> dict:
    """TransMVSNet's bf16 forward at B=1 (``entry(arch="transmvsnet")``):
    its outputs checked and its launches exactly ``TRANS_FWD``."""
    return forward_main_path(entry, TRANS_FWD, " arch=transmvsnet",
                             arch="transmvsnet")


def profile(fn, label: str, card, iters: int = 3) -> None:
    """Device time per call of ``fn`` by kernel name over ``iters`` calls
    (``torch.profiler``, after one warm-up call), the 12 largest and the
    rest, and the busy share: summed kernel time over the wall time of the
    calls with the profiler on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    times = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key[:100]
        ms, n = times.get(name, (0.0, 0))
        times[name] = (ms + us / 1e3 / iters, n + e.count // iters)
    total = sum(ms for ms, _ in times.values())
    print(f"profile{label}: wall {wall!r} ms per call (profiler on), kernel "
          f"time {total!r} ms, busy {100 * total / wall!r} %, "
          f"{len(times)} kernel names [{card}]")
    ranked = sorted(times.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in ranked[:12]:
        print(f"  {ms!r} ms {100 * ms / max(total, 1e-9)!r} % x{n} {name}")
    rest = sum(ms for _, (ms, _) in ranked[12:])
    print(f"  {rest!r} ms in the other {max(len(ranked) - 12, 0)} names")


def profile_paths(entry, train_entry, card) -> None:
    """Phase 19: the default and quad bf16 forward (B=1) and train step."""
    for sampling in ("auto", "quad"):
        fn, args = entry(DEVICE, img_wh=IMG_WH, sampling=sampling)
        profile(lambda: fn(*args), f" forward bf16 B=1 sampling={sampling}",
                card)
        del fn, args
        trainer, state, batch = train_entry(DEVICE, img_wh=IMG_WH,
                                            sampling=sampling)
        profile(lambda: trainer.train_step(state, batch),
                f" train step bf16 B=2 sampling={sampling}", card)
        del trainer, state, batch
        torch.cuda.empty_cache()


# --- the packed-quad warp: TPU kernels #7/#8 --------------------------------

def tap_level_rows(inputs2, seed: int):
    """Per level: one source view's rows (N, 4C) f32 and weights (N, 4) f32,
    N = 2 D h w, that ``quad_rows`` builds at B=2."""
    for (l, C, D, h, w), (_, rows, ws) in quad_level_rows(inputs2, 2, seed):
        yield ((l, C, D, h, w), rows[:, 0].reshape(-1, 4 * C),
               ws[:, 0].reshape(-1, 4))
        del rows, ws


def check_tap_reduce(inputs2) -> dict:
    """#7 and #8 against their plain versions at every level shape and on a
    prefix of TAP_ODD_N rows; returns the max f32 abs error by name."""
    from casmvsnet_pl_tpu_torch import kernels as k
    from casmvsnet_pl_tpu_torch.ops import tap_reduce as tr
    g = torch.Generator(device=DEVICE).manual_seed(14)
    worst = {}
    for (l, C, D, h, w), rows, ws in tap_level_rows(inputs2, 15):
        for n in (rows.shape[0], TAP_ODD_N):
            go = torch.randn((n, C), generator=g, device=DEVICE)
            for dtype in (torch.float32, torch.bfloat16):
                r, w4 = rows[:n].to(dtype), ws[:n]
                e_out = (k.tap_reduce_cuda(r, w4)
                         - tr.plain_tap_reduce(r, w4)).abs().max().item()
                (d_rows, d_w), (p_rows, p_w) = (
                    k.tap_reduce_bwd_cuda(r, w4, go),
                    tr.plain_tap_reduce_bwd(r, w4, go))
                e_rows = (d_rows.float() - p_rows.float()).abs()
                ulps = (e_rows / bf16_ulp(p_rows)).max().item()
                e_rows = e_rows.max().item()
                e_w = (d_w - p_w).abs()
                w_ok = bool((e_w <= TAP_TOL + TAP_TOL * p_w.abs()).all())
                e_w = e_w.max().item()
                bf16 = dtype == torch.bfloat16
                print(f"tap-reduce-check L{l} {'bf16' if bf16 else 'f32'} "
                      f"rows ({n}, {4 * C}): out max_abs_err={e_out!r} "
                      f"(bound {TAP_TOL}); d rows max_abs_err={e_rows!r} "
                      f"max_ulps={ulps!r} (bound {'1 ulp' if bf16 else 0}); "
                      f"d w max_abs_err={e_w!r} (bound {TAP_TOL} + "
                      f"{TAP_TOL} rel)")
                if not e_out <= TAP_TOL:
                    raise AssertionError(f"L{l} #7 error {e_out}")
                if not (ulps <= 1.0 if bf16 else e_rows == 0.0):
                    raise AssertionError(f"L{l} #8 d rows error {e_rows}")
                if not w_ok:
                    raise AssertionError(f"L{l} #8 d w error {e_w}")
                if not bf16:
                    for name, e in (("tap_reduce_cuda", e_out),
                                    ("tap_reduce_bwd_cuda", max(e_rows,
                                                                e_w))):
                        worst[name] = max(worst.get(name, 0.0), e)
                del d_rows, d_w, p_rows, p_w, r
        del rows, ws
    return worst


def warp_views(inputs2, dtype, seed: int):
    """For each level and source view v: (level, leaves, G), with leaves
    the source features (2, h, w, C) of view v, its projections (2, 3, 4)
    and the depth windows (2, D, h, w), all requiring grad, and G a seeded
    gradient of the warp's output."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    for lvl in levels():
        l, C, D, h, w = lvl
        proj, dv = inputs2[l]
        feats = torch.rand((2, 3, h, w, C), generator=g, device=DEVICE)
        for v in (1, 2):
            leaves = [feats[:, v].to(dtype).requires_grad_(True),
                      proj[:, v - 1].clone().requires_grad_(True),
                      dv.clone().requires_grad_(True)]
            G = torch.randn((2, D, h, w, C), generator=g,
                            device=DEVICE).to(dtype)
            yield lvl, leaves, G


def check_warp(inputs2) -> None:
    """Phase 21, f32: the warp through #7/#8 against the plain sampler
    forward and against autograd through its plain route backward."""
    from casmvsnet_pl_tpu_torch.ops import (grid_sample_batched, pack_quad,
                                            plain_grid_sample_quad,
                                            project_to_src,
                                            warp_src_quad_batched)
    reset_launches()
    for (l, C, D, h, w), leaves, G in warp_views(inputs2, torch.float32, 16):
        src, P, d = leaves
        out = warp_src_quad_batched(pack_quad(src), P, d, h, w)
        got = torch.autograd.grad(out, leaves, G)
        xy = project_to_src(P, d, h, w)
        with torch.no_grad():
            e_fwd = (out - grid_sample_batched(src, xy)).abs().max().item()
        plain = plain_grid_sample_quad(pack_quad(src), xy, h, w)
        want = torch.autograd.grad(plain, leaves, G)
        rel = [((a - b).norm() / b.norm()).item() for a, b in zip(got, want)]
        print(f"warp-check L{l} f32 out {tuple(out.shape)}: forward vs "
              f"grid_sample_batched max_abs_err={e_fwd!r} (bound {TAP_TOL}); "
              f"gradient relative L2 vs plain autograd: features {rel[0]!r}, "
              f"proj {rel[1]!r}, depth {rel[2]!r} (bound {WARP_REL_TOL})")
        if not e_fwd <= TAP_TOL:
            raise AssertionError(f"L{l} warp forward error {e_fwd}")
        if not all(r <= WARP_REL_TOL for r in rel):
            raise AssertionError(f"L{l} warp gradient error {rel}")
        del out, got, xy, plain, want
    torch.cuda.synchronize()
    expect_counts(launch_counts(), WARP_PATH, "f32 warp check")


def warp_pass(views) -> torch.Tensor:
    """Forward and backward of the warp for each of ``views`` (as
    :func:`warp_views` yields them); returns whether every output and
    gradient is finite, as a tensor on the card."""
    from casmvsnet_pl_tpu_torch.ops import pack_quad, warp_src_quad_batched
    flags = []
    for (l, C, D, h, w), leaves, G in views:
        src, P, d = leaves
        out = warp_src_quad_batched(pack_quad(src), P, d, h, w)
        grads = torch.autograd.grad(out, leaves, G)
        flags += [torch.isfinite(t).all() for t in (out, *grads)]
    return torch.stack(flags).all()


def warp_main_path(views, card) -> dict:
    """Phase 21, the warp's main path: bf16 forward and backward of both
    source views at each level, every output and gradient finite, the
    launches exactly WARP_PATH; returns the launches."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    finite = bool(warp_pass(views))
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"warp bf16 main path, B=2, both source views at 3 levels, forward "
          f"+ backward: {(time.perf_counter() - t0) * 1e3!r} ms wall, all "
          f"finite {finite}; launches {counts} [{card}]")
    expect_counts(counts, WARP_PATH, "bf16 warp")
    if not finite:
        raise AssertionError("non-finite warp output or gradient")
    return counts


def tap_reduce_work(N, C, itemsize, backward=False):
    """(bytes, float32 operations) of #7, or of #8 with ``backward``, for N
    samples: #7 reads the rows (4C values) and the f32 weights (16 B) once
    and writes the f32 output (4C B) once, 8C operations; #8 reads the
    rows, the weights and the f32 gradient and writes d rows and d w once,
    12C operations (d rows 4C, d w 8C)."""
    if not backward:
        return N * (4 * C * itemsize + 16 + 4 * C), N * 8 * C
    return N * (8 * C * itemsize + 4 * C + 32), N * 12 * C


def time_tap_reduce(inputs2, card) -> tuple[dict, float]:
    """Phase 22: #7 and #8 against their plain versions per level on one
    source view's bf16 rows (B=2), and #7's library call, a batched
    ``torch.matmul`` on the rows upcast to f32 outside the timed region.
    Returns the sums as :func:`time_kernels` does, and the library call's
    time summed over the levels."""
    from casmvsnet_pl_tpu_torch import kernels as k
    from casmvsnet_pl_tpu_torch.ops import tap_reduce as tr
    g = torch.Generator(device=DEVICE).manual_seed(18)
    sums, library_ms = {}, 0.0
    for (l, C, D, h, w), rows, ws in tap_level_rows(inputs2, 19):
        rb = rows.to(torch.bfloat16)
        del rows
        N = rb.shape[0]
        go = torch.randn((N, C), generator=g, device=DEVICE)
        label = f"L{l} bf16 rows {tuple(rb.shape)}"
        time_level(sums, "tap_reduce_cuda", label,
                   lambda: k.tap_reduce_cuda(rb, ws),
                   lambda: tr.plain_tap_reduce(rb, ws), (50, 5),
                   tap_reduce_work(N, C, 2), card)
        time_level(sums, "tap_reduce_bwd_cuda", label,
                   lambda: k.tap_reduce_bwd_cuda(rb, ws, go),
                   lambda: tr.plain_tap_reduce_bwd(rb, ws, go), (50, 5),
                   tap_reduce_work(N, C, 2, backward=True), card)
        rf, wv = rb.float().view(N, 4, C), ws.view(N, 1, 4)
        ms = cuda_ms(lambda: torch.matmul(wv, rf), 20)
        err = (torch.matmul(wv, rf).view(N, C)
               - k.tap_reduce_cuda(rb, ws)).abs().max().item()
        print(f"timing library torch.matmul (N,1,4) x (N,4,C) f32 {label}: "
              f"{ms!r} ms, max_abs_err vs #7 {err!r} [{card}]")
        library_ms += ms
        del rb, ws, go, rf, wv
    return ({name: (k_ms, p_ms, *bound(nbytes, flops))
             for name, (k_ms, p_ms, nbytes, flops) in sums.items()},
            library_ms)


# --- the probes: TPU kernels #9-#13 -----------------------------------------

def probe_kernels() -> list[str]:
    """The probes' kernels (TPU kernels #9-#13) by name: those of
    ``kernels/probes.py``, each launched on the probes path."""
    from casmvsnet_pl_tpu_torch.kernels import probes
    return [n for n in launch_counts() if hasattr(probes, n)]


def probes_path(card) -> tuple[list, dict]:
    """Phases 23-26: each probe's main path on the card; returns the timed
    results and the launches counted over the four phases, in which every
    probe kernel launches."""
    from casmvsnet_pl_tpu_torch.probes import epi2, epi3, epi5, gather
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = gather.main(DEVICE, card, IMG_WH)               # 23: #13
    data = epi3.inputs(DEVICE)
    results += epi3.run_copy(data, card)                      #     #11
    results += epi2.main(DEVICE, card)                        # 24: #9
    results += epi3.run_var(data, card)                       # 25: #10
    del data
    results += epi5.main(DEVICE, card)                        # 26: #12
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"probes path (phases 23-26): {time.perf_counter() - t0!r} s wall; "
          f"launches {counts} [{card}]")
    never = [n for n in probe_kernels() if counts[n] < 1]
    if never:
        raise AssertionError(f"probe kernels never launched: {never}")
    return results, counts


def probe_summary(results) -> dict:
    """By wrapper name: the fastest configuration of each probe kernel, its
    results summed over the shapes it covers (k ms, plain ms, bound ms,
    bound by, max f32 error over every configuration, library ms, what the
    times cover)."""
    out = {}
    for name in probe_kernels():
        mine = [r for r in results if r.kernel == name]
        groups = {}
        for r in mine:
            groups.setdefault(r.group, []).append(r)
        group, rs = min(groups.items(),
                        key=lambda kv: sum(r.ms for r in kv[1]))
        libs = [r.library_ms for r in rs]
        out[name] = (sum(r.ms for r in rs), sum(r.plain_ms for r in rs),
                     *bound(sum(r.nbytes for r in rs),
                            sum(r.flops for r in rs)),
                     max(r.max_abs_err for r in mine),
                     None if None in libs else sum(libs),
                     f"{group}, the fastest of {sorted(groups)}; "
                     + " + ".join(r.label for r in rs))
    return out


HOST_CALLS = ("lane_gather_cuda", "index_select (lane gather's shape)",
              "row_gather_ldg_cuda", "index_select (row gather's shape)",
              "cost_volume_cuda", "t.new_empty (8, 128)",
              "cost_volume_bwd_cuda", "t.new_zeros (1, 3, 16, 16, 8)")


def host_costs(card) -> None:
    """Phase 27: host_us of HOST_CALLS, in turns; printed on one line."""
    from casmvsnet_pl_tpu_torch.probes import host
    calls = host.wrapper_calls(DEVICE)
    times = host.measure({n: calls[n] for n in HOST_CALLS})
    print("host_us, to enqueue one call: " + ", ".join(
        f"{n} {us!r} us" for n, us in times.items()) + f" [{card}]")


# --- the eval path: eval_torch.py's inference to PFM maps and fusion --------

EVAL_WH = (1152, 864)          # eval.py's resolution, behind published clouds
EVAL_VIEWS = 5
EVAL_NATIVE_WH = (1600, 1200)  # DTU's test images
EVAL_MEMORY_WH = (1600, 1184)  # the reference's published memory figure
# the synthetic tree's focal length at 1600 px: the 64x64 tree's field of
# view (100 px there), so the plane keeps its depth range
EVAL_FOCAL = 2500.0
EVAL_SCAN = "scan1"
# the fused ground-truth cloud is scored in a box of this half-width (mm)
# at the rig's centre: the Python scorer's thinning loop would take minutes
# on the whole cloud (~4.8 M points)
GT_BOX_MM = 20.0
GT_TOL_MM = 0.1
EVAL_FWD = scaled(DEFAULT_FWD, EVAL_VIEWS)


def image_libraries() -> None:
    """Phase 28: which image libraries import on this machine (the port
    needs none of them; the JAX package reads with PIL and cv2)."""
    code = ("import importlib\n"
            "for name in ('PIL', 'cv2', 'imageio', 'tqdm', 'tensorboardX'):\n"
            "    try:\n"
            "        m = importlib.import_module(name)\n"
            "        print(name, getattr(m, '__version__', '?'), end='; ')\n"
            "    except Exception as e:\n"
            "        print(name, 'not importable', type(e).__name__,"
            " end='; ')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, check=True)
    print("image libraries:", proc.stdout.strip())


def eval_tree(work: str):
    """Phase 29: a synthetic DTU tree at DTU's test size (1 scan, 5
    cameras, rectified PNGs at 1600x1200, light 3 only) written with the
    port's PNG encoder; the decode and decode + PIL-bilinear resize times
    of its images. Returns (tree root, the reader's class)."""
    from casmvsnet_pl_tpu_torch.data import write_dtu_tree
    from casmvsnet_pl_tpu_torch.data.base import load_image
    from casmvsnet_pl_tpu_torch.data.png import read_png

    tree, lists = os.path.join(work, "tree"), os.path.join(work, "lists")
    t0 = time.perf_counter()
    write_dtu_tree(tree, scans=(EVAL_SCAN,), n_cams=EVAL_VIEWS,
                   img_wh=EVAL_NATIVE_WH, native_wh=EVAL_NATIVE_WH,
                   focal=EVAL_FOCAL, lights=(3,))
    written = time.perf_counter() - t0
    os.makedirs(lists)
    with open(os.path.join(lists, "test.txt"), "w") as f:
        f.write(EVAL_SCAN + "\n")
    pngs = [os.path.join(tree, f"Rectified/{EVAL_SCAN}/"
                               f"rect_{v + 1:03d}_3_r5000.png")
            for v in range(EVAL_VIEWS)]
    read_png(pngs[0])                     # builds the C helper
    decode, resize = [], []
    for path in pngs:
        t0 = time.perf_counter()
        read_png(path)
        t1 = time.perf_counter()
        load_image(path, EVAL_WH)
        decode.append((t1 - t0) * 1e3)
        resize.append((time.perf_counter() - t1) * 1e3)
    print(f"eval tree: 1 scan, {EVAL_VIEWS} cameras, PNGs at "
          f"{EVAL_NATIVE_WH[0]}x{EVAL_NATIVE_WH[1]}, written in {written!r} "
          f"s; host ms per image, median of {EVAL_VIEWS}: decode "
          f"{statistics.median(decode)!r}, decode + PIL-bilinear resize to "
          f"{EVAL_WH[0]}x{EVAL_WH[1]} {statistics.median(resize)!r}")
    return tree, eval_reader(lists)


def eval_reader(lists: str):
    """The DTU reader of phase 29's tree, whose split lists are in
    ``lists``."""
    from casmvsnet_pl_tpu_torch.data import DTUDataset

    class ChipDTU(DTUDataset):
        NATIVE_WH = EVAL_NATIVE_WH
        N_CAMS = EVAL_VIEWS
        LISTS_DIR = lists
    return ChipDTU


def eval_args(tree: str, *flags):
    import eval_torch
    return eval_torch.get_opts(["--root_dir", tree, "--n_views",
                                str(EVAL_VIEWS), "--img_wh",
                                str(EVAL_WH[0]), str(EVAL_WH[1]), *flags])


def sweep_range(args, depth_min: float, depth_interval: float):
    """The lowest and highest depth any level's hypotheses can reach."""
    nd, ratios = args.n_depths, args.interval_ratios
    lo = depth_min - sum(nd[l] / 2 * depth_interval * ratios[l]
                         for l in (0, 1))
    hi = depth_min + (nd[2] - 1) * depth_interval * ratios[2] + sum(
        (nd[l] / 2 - 1) * depth_interval * ratios[l] for l in (0, 1))
    return lo, hi


def eval_inference(tree: str, dataset_cls, card):
    """Phase 30, the eval path: ``eval_torch.run_inference`` in bf16 for
    every reference view at 1152x864x5, exactly 3 K1 launches a view; the
    PFMs' shapes, finite depths inside the swept range. Returns (launches,
    predictor, dataset, args)."""
    import eval_torch
    from casmvsnet_pl_tpu_torch.data import read_pfm

    args = eval_args(tree)
    ds = dataset_cls(tree, "test", n_views=EVAL_VIEWS, img_wh=EVAL_WH)
    predict = eval_torch.build_predictor(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    records = eval_torch.run_inference(args, ds, ds.scans, predict)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect_counts(counts, EVAL_FWD, "eval inference")
    lo, hi = sweep_range(args, float(ds[0]["init_depth_min"]),
                         args.depth_interval)
    W, H = EVAL_WH
    for vid in range(EVAL_VIEWS):
        depth = read_pfm(f"results/dtu/depth/{EVAL_SCAN}/"
                         f"depth_{vid:04d}.pfm")[0]
        proba = read_pfm(f"results/dtu/depth/{EVAL_SCAN}/"
                         f"proba_{vid:04d}.pfm")[0]
        if depth.shape != (H, W) or proba.shape != (H // 4, W // 4):
            raise AssertionError(f"view {vid}: PFM shapes {depth.shape}, "
                                 f"{proba.shape}")
        if not (np.isfinite(depth).all() and lo <= depth.min()
                and depth.max() <= hi):
            raise AssertionError(f"view {vid}: depth outside [{lo}, {hi}]")
    fwd = [r["forward_ms"] for r in records]
    view = [r["view_ms"] for r in records]
    print(f"eval inference bf16 {W}x{H}x{EVAL_VIEWS}, {len(records)} views "
          f"through eval_torch.run_inference: forward "
          f"{statistics.median(fwd[1:])!r} ms per view (CUDA events, median of views 2-{len(records)}; "
          f"first {fwd[0]!r}), with reading, transfer and PFM writing "
          f"{statistics.median(view[1:])!r} ms (first {view[0]!r}); peak "
          f"memory {peak!r} GiB; {wall!r} s wall; depths in [{lo}, {hi}]; "
          f"launches {counts} [{card}]")
    return counts, predict, ds, args


def eval_checks(tree: str, dataset_cls, ds, predict, card) -> dict:
    """Phase 31: one view in f32, the model with K1 against the plain cost
    volume (< 0.05 mm on depth_0, softmax sharpened as in phase 5); a
    profile of the bf16 forward of one view; one bf16 view with
    --num_groups 8 (3 K1 launches); one bf16 forward at 1600x1184x5 for
    its peak memory. Returns the G=8 view's launches."""
    import eval_torch
    from casmvsnet_pl_tpu_torch.ops import plain_cost_volume

    def inputs(sample):
        return (torch.from_numpy(sample["imgs"][None]).to(DEVICE),
                torch.from_numpy(sample["proj_mats"][None]).to(DEVICE),
                float(sample["init_depth_min"]),
                float(sample["depth_interval"]))

    args = inputs(ds[0])
    p32 = eval_torch.build_predictor(eval_args(tree, "--precision", "f32"))
    with torch.no_grad():
        for l in range(3):
            getattr(p32.model, f"cost_reg_{l}").prob.weight *= 30.0
    d_k, _ = counted(lambda: p32(*args), DEFAULT_FWD, "eval f32 view")
    d_p, _ = counted(plain_prob(lambda: p32(
        *args, cost_volume=plain_cost_volume)), {}, "eval f32 plain view")
    dd = (d_k - d_p).abs().max().item()
    print(f"eval f32 view {EVAL_WH[0]}x{EVAL_WH[1]}x{EVAL_VIEWS}, kernel vs "
          f"plain cost volume: max|d depth_0|={dd!r} mm (bound "
          f"{DEPTH_TOL_MM}), depth_0 range [{d_k.min().item()!r}, "
          f"{d_k.max().item()!r}]")
    if not dd < DEPTH_TOL_MM:
        raise AssertionError(f"eval f32 depth_0 kernel vs plain {dd} mm")
    del p32, d_k, d_p
    torch.cuda.empty_cache()
    profile(lambda: predict(*args), f" eval forward bf16 {EVAL_WH[0]}x"
            f"{EVAL_WH[1]}x{EVAL_VIEWS}", card)

    g8 = eval_torch.build_predictor(eval_args(tree, "--num_groups", "8"))
    reset_launches()
    depth, conf = g8(*args)
    torch.cuda.synchronize()
    counts = launch_counts()
    expect_counts(counts, DEFAULT_FWD, "eval bf16 view --num_groups 8")
    if not (torch.isfinite(depth).all() and torch.isfinite(conf).all()):
        raise AssertionError("eval --num_groups 8: non-finite outputs")
    print(f"eval bf16 view --num_groups 8: launches {counts}, depth_0 "
          f"{tuple(depth.shape)}")
    del g8, depth, conf
    torch.cuda.empty_cache()

    big = inputs(dataset_cls(tree, "test", n_views=EVAL_VIEWS,
                             img_wh=EVAL_MEMORY_WH)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    depth, _ = predict(*big)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"eval bf16 forward {EVAL_MEMORY_WH[0]}x{EVAL_MEMORY_WH[1]}x"
          f"{EVAL_VIEWS}: peak memory {peak!r} GiB ({base / 2 ** 30!r} GiB "
          f"of it weights and inputs held before the call); depth_0 "
          f"{tuple(depth.shape)} [{card}]")
    return counts


def eval_fusion(tree: str, ds, work: str, card) -> None:
    """Phase 32: ``eval_torch.run_fusion`` on the card of the tree's own
    ground-truth depths (nearest-resized to 1152x864, as the reader does)
    with proba 1, scored by the port's ``evaluate_scan`` against the plane's
    exact surface points in a 40 mm box at the rig's centre (mean accuracy
    and overall < 0.1 mm); then of phase 30's PFMs (random weights: the
    point count only, at --conf 0.05). ms per reference view, with and
    without the PNG and PFM reading."""
    import eval_torch
    from casmvsnet_pl_tpu_torch.data import PlaneScene, save_pfm
    from casmvsnet_pl_tpu_torch.evaluation import evaluate_scan
    from casmvsnet_pl_tpu_torch.fusion import fuse_scan, read_ply

    args = eval_args(tree, "--conf", "0.5", "--min_geo_consistent", "2")
    W, H = EVAL_WH
    gt_dir = os.path.join(work, "gt")
    depth_dir = os.path.join(gt_dir, f"results/dtu/depth/{EVAL_SCAN}")
    os.makedirs(depth_dir)
    depths = {vid: ds.read_depth(EVAL_SCAN, vid)["level_0"]
              for vid in range(EVAL_VIEWS)}
    for vid, depth in depths.items():
        save_pfm(os.path.join(depth_dir, f"depth_{vid:04d}.pfm"), depth)
        save_pfm(os.path.join(depth_dir, f"proba_{vid:04d}.pfm"),
                 np.ones((H // 4, W // 4), np.float32))
    os.chdir(gt_dir)
    t0 = time.perf_counter()
    eval_torch.run_fusion(args, ds, [EVAL_SCAN])
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    xyz, _ = read_ply(f"results/dtu/points/{EVAL_SCAN}.ply")
    scene = PlaneScene(img_wh=EVAL_NATIVE_WH, n_views=EVAL_VIEWS, z0=460.0,
                       slope_x=0.3, focal=EVAL_FOCAL)
    stl = scene.surface_points()
    centre = scene.baseline * (EVAL_VIEWS - 1) / 2

    def box(p):
        return p[(np.abs(p[:, 0] - centre) < GT_BOX_MM)
                 & (np.abs(p[:, 1]) < GT_BOX_MM)]

    t0 = time.perf_counter()
    res = evaluate_scan(box(xyz), box(stl), max_dist=20.0)
    score_s = time.perf_counter() - t0
    print(f"eval fusion of ground-truth depths: {len(xyz)} points; in the "
          f"{2 * GT_BOX_MM} mm box: mean acc {res.mean_acc!r}, mean comp "
          f"{res.mean_comp!r}, median acc {res.median_acc!r}, median comp "
          f"{res.median_comp!r}, overall {res.overall!r} mm (bound "
          f"{GT_TOL_MM} on mean acc and overall; {res.n_data} data, "
          f"{res.n_stl} surface points; scored in {score_s!r} s)")
    if not (res.mean_acc < GT_TOL_MM and res.overall < GT_TOL_MM):
        raise AssertionError(f"fused ground-truth cloud scores {res}")

    images = {vid: eval_torch.read_image(os.path.join(
        tree, f"Rectified/{EVAL_SCAN}/rect_{vid + 1:03d}_3_r5000.png"),
        EVAL_WH) for vid in range(EVAL_VIEWS)}
    metas = [(m[2], m[3]) for m in ds.metas]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mem_xyz, _ = fuse_scan(metas, images.__getitem__, depths.__getitem__,
                           lambda vid: np.ones((H // 4, W // 4), np.float32),
                           lambda vid: ds.proj_mats[vid][0][0], EVAL_WH,
                           conf=0.5, min_geo_consistent=2, device=DEVICE)
    torch.cuda.synchronize()
    mem_s = time.perf_counter() - t0
    if len(mem_xyz) != len(xyz):
        raise AssertionError("fusion from memory and from files differ")

    # random weights spread the confidence over the sweep (~4/48 in the
    # 4 bins): a threshold below it lets the predictions reach the cloud
    os.chdir(work)
    args = eval_args(tree, "--conf", "0.05", "--min_geo_consistent", "2")
    t0 = time.perf_counter()
    eval_torch.run_fusion(args, ds, [EVAL_SCAN])
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    n_pred = len(read_ply(f"results/dtu/points/{EVAL_SCAN}.ply")[0])
    n = len(metas)
    print(f"eval fusion on the card, {W}x{H}, {n} reference views x "
          f"{n - 1} sources: run_fusion {1e3 * gt_s / n!r} ms per reference "
          f"view (ground truth; PNG and PFM reading included), fuse_scan "
          f"from memory {1e3 * mem_s / n!r} ms; of the random-weight "
          f"predictions (--conf 0.05 --min_geo_consistent 2): {n_pred} "
          f"points, "
          f"{1e3 * pred_s / n!r} ms per reference view [{card}]")


def eval_path(card, keep: str | None = None) -> dict:
    """Phases 28-32 in a temporary directory, or in ``keep``, which then
    holds the tree (``tree``, ``lists``) for phase 43; returns the
    launches of the eval path (phase 30) and of its --num_groups 8 view
    (phase 31)."""
    image_libraries()
    cwd = os.getcwd()
    t0 = time.perf_counter()
    with (contextlib.nullcontext(keep) if keep else
          tempfile.TemporaryDirectory(prefix="chip_smoke_eval_")) as work:
        try:
            tree, dataset_cls = eval_tree(work)
            os.chdir(work)
            counts, predict, ds, _ = eval_inference(tree, dataset_cls, card)
            g8 = eval_checks(tree, dataset_cls, ds, predict, card)
            del predict
            torch.cuda.empty_cache()
            eval_fusion(tree, ds, work, card)
        finally:
            os.chdir(cwd)
    print(f"eval path (phases 28-32): {time.perf_counter() - t0!r} s wall")
    return {"eval": counts, "eval_g8": g8}


# --- the training CLI: train_torch.py at DTU's train size -------------------

TRAIN_NATIVE_WH = (1600, 1200)  # DTU's depth maps and masks
TRAIN_CROP = ((44, 556), (80, 720))  # DTUDataset.DEPTH_CROP: IMG_WH
# the 64x64 tree's field of view (100 px at 64 px wide) at 640 px
TRAIN_FOCAL = 1000.0
TRAIN_SCANS = {"train": "scan1", "val": "scan2"}
CLI_BATCH = 2
CLI_STEPS = 17          # 35 samples, batch 2, the ragged last dropped
CLI_VAL_BATCHES = 18    # 35 samples, the last batch padded
# an epoch's steps, then a forward a val batch and one for the train panel
CLI_EPOCH = summed(scaled(DEFAULT_STEP, CLI_STEPS),
                   scaled(DEFAULT_FWD, CLI_VAL_BATCHES + 1))
DP_BATCH = 4
DP_N_DEPTHS = (8, 32, 48)
DP_ORDERS = ((2, 3, 0, 1), (1, 0, 3, 2))   # the global batch's rows permuted
DP_NOISE = 3            # gradients: times the step's own reordering noise
DP_STAT_TOL = 1e-5      # BatchNorm running statistics, relative


def train_tree(work: str):
    """Phase 33: the synthetic DTU training tree; returns (root, the
    reader's class)."""
    from casmvsnet_pl_tpu_torch.data import (DTUDataset, PlaneScene,
                                             write_dtu_tree)

    tree, lists = os.path.join(work, "train_tree"), os.path.join(
        work, "train_lists")
    t0 = time.perf_counter()
    write_dtu_tree(tree, scans=tuple(TRAIN_SCANS.values()), n_cams=5,
                   img_wh=IMG_WH, native_wh=TRAIN_NATIVE_WH,
                   focal=TRAIN_FOCAL, depth_crop=TRAIN_CROP)
    written = time.perf_counter() - t0
    os.makedirs(lists)
    for split, scan in TRAIN_SCANS.items():
        with open(os.path.join(lists, f"{split}.txt"), "w") as f:
            f.write(scan + "\n")

    class ChipTrainDTU(DTUDataset):
        NATIVE_WH = TRAIN_NATIVE_WH
        DEPTH_CROP = TRAIN_CROP
        N_CAMS = 5
        LISTS_DIR = lists

    ds = ChipTrainDTU(tree, "train")
    t0 = time.perf_counter()
    sample = ds[8]
    read_ms = (time.perf_counter() - t0) * 1e3
    scene = PlaneScene(img_wh=IMG_WH, n_views=5, z0=460.0, slope_x=0.3,
                       focal=TRAIN_FOCAL)
    vid = sample["scan_vid"][1]
    err = np.abs(sample["depths"]["level_0"] - scene.depth_map(vid)).max()
    print(f"train tree: scans {TRAIN_SCANS}, 5 cameras, 7 lights, "
          f"{len(ds)} train samples, PNGs at {IMG_WH[0]}x{IMG_WH[1]}, depths "
          f"and masks at {TRAIN_NATIVE_WH[0]}x{TRAIN_NATIVE_WH[1]}, written "
          f"in {written!r} s; one train sample read in {read_ms!r} ms on the "
          f"host; its depth_0 against the plane's at view {vid}: max abs "
          f"{err!r} mm")
    if len(ds) != 35 or err != 0.0:
        raise AssertionError(f"train tree: {len(ds)} samples, depth "
                             f"misaligned by {err} mm")
    return tree, ChipTrainDTU


def cli_args(tree: str, *flags):
    from casmvsnet_pl_tpu_torch.opt import get_opts
    return get_opts(["--root_dir", tree, "--batch_size", str(CLI_BATCH),
                     "--optimizer", "adam", "--lr", "1e-3", "--exp_name",
                     "chip", *flags])


def cli_epoch(tree: str, dataset_cls, card, train_entry_ms: float) -> dict:
    """Phase 34: one epoch through ``train_torch.main``; returns its
    launches."""
    import train_torch
    from casmvsnet_pl_tpu_torch.utils.tensorboard import (images,
                                                          read_events,
                                                          scalars)

    args = cli_args(tree, "--num_epochs", "1")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer, state = train_torch.main(args, dataset_cls, time_steps=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect_counts(counts, CLI_EPOCH, "train_torch.py epoch")
    times = trainer.step_times
    losses = [t["loss"] for t in times]
    if state.step != CLI_STEPS or len(times) != CLI_STEPS:
        raise AssertionError(f"train_torch.py: {state.step} steps")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite CLI loss {losses}")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f"CLI loss did not fall: {losses}")
    files = os.listdir("ckpts/chip")
    if "last.ckpt" not in files or not any(f.startswith("epoch=")
                                           for f in files):
        raise AssertionError(f"checkpoints: {files}")
    (name,) = os.listdir("logs/chip")
    events = read_events(os.path.join("logs/chip", name))
    tags = scalars(events)
    panels = images(events)
    want_tags = {"train/loss", "train/abs_err", "train/acc_1mm",
                 "train/acc_2mm", "train/acc_4mm", "lr", "val/loss",
                 "val/abs_err", "val/acc_1mm", "val/acc_2mm", "val/acc_4mm"}
    W, H = IMG_WH
    shapes = {k: v[0][1].shape for k, v in panels.items()}
    if set(tags) != want_tags or shapes != {
            "train/image_GT_pred_prob": (H, 4 * W, 3),
            "val/image_GT_pred_prob": (H, 4 * W, 3)}:
        raise AssertionError(f"events: {sorted(tags)}, panels {shapes}")
    steady = times[2:]
    ms = statistics.median(t["step_s"] for t in steady) * 1e3
    wait = sum(t["wait_s"] for t in steady) / sum(t["step_s"]
                                                  for t in steady)
    print(f"train_torch.py bf16 {W}x{H}x3 batch {CLI_BATCH} adam lr 1e-3, "
          f"one epoch ({CLI_STEPS} steps, {CLI_VAL_BATCHES} val batches) in "
          f"{wall!r} s: losses {losses!r}; val {tags['val/acc_2mm']!r} "
          f"acc_2mm; launches {counts}; files {sorted(files)}; events "
          f"{len(events)} ({sorted(shapes)})")
    print(f"timing train_torch.py step (wall, CUDA sync a step, loader "
          f"included, median of steps 3-{CLI_STEPS}): {ms!r} ms/step, "
          f"{CLI_BATCH * 1000.0 / ms!r} samples/s, loader wait "
          f"{100 * wait!r} % of the step; peak memory {peak!r} GiB; "
          f"train_entry's step (phase 11, one batch on the card) "
          f"{train_entry_ms!r} ms [{card}]")
    return counts


def cli_resume(tree: str, dataset_cls) -> None:
    """Phase 35: full resume, then warm start with an ignored prefix."""
    import contextlib
    import io

    import train_torch
    from casmvsnet_pl_tpu_torch.utils import load_checkpoint

    reset_launches()
    trainer, state = train_torch.main(cli_args(
        tree, "--num_epochs", "1", "--resume_path", "ckpts/chip/last.ckpt"),
        dataset_cls)
    torch.cuda.synchronize()
    counts = launch_counts()
    expect_counts(counts, CLI_EPOCH, "train_torch.py resumed epoch")
    adam_steps = {int(st["step"]) for st in
                  state.optimizer.state_dict()["state"].values()}
    print(f"train_torch.py --resume_path last.ckpt --num_epochs 1: step "
          f"{state.step}, Adam's step counts {sorted(adam_steps)}, "
          f"checkpoints {sorted(os.listdir('ckpts/chip'))}")
    if state.step != 2 * CLI_STEPS or adam_steps != {2 * CLI_STEPS}:
        raise AssertionError("resume did not continue the step count")
    del trainer, state

    ckpt = load_checkpoint("ckpts/chip/last.ckpt")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, state = train_torch.main(cli_args(
            tree, "--num_epochs", "0", "--exp_name", "warm", "--ckpt_path",
            "ckpts/chip/last.ckpt", "--prefixes_to_ignore", "cost_reg_0"),
            dataset_cls)
    ignored = sorted(line[len("ignore "):] for line in
                     out.getvalue().splitlines() if line.startswith("ignore "))
    want = sorted(k for k in ckpt["params"] if k.startswith("cost_reg_0"))
    params = {k: v.detach().cpu() for k, v in
              state.model.named_parameters()}
    loaded = [k for k, v in ckpt["params"].items() if torch.equal(params[k],
                                                                  v)]
    print(f"train_torch.py --ckpt_path last.ckpt --prefixes_to_ignore "
          f"cost_reg_0: {len(ignored)} names ignored ({ignored[:2]} ...), "
          f"{len(loaded)} of {len(params)} parameters equal to the "
          f"checkpoint's")
    if ignored != want or sorted(set(params) - set(loaded)) != want:
        raise AssertionError("warm start loaded the wrong parameters")


def leaf_differences(got: dict, want: dict) -> tuple[dict, dict]:
    """Per leaf, of two saved steps (``entry.data_parallel_step``): each
    gradient's relative L2 difference (the prob convs' biases, whose exact
    gradient is 0, against their weights' gradient, as phase 9) and each
    BatchNorm running statistic's max difference relative to its buffer's
    largest value."""
    g = want["grads"]

    def scale(n):
        return g[n.replace("prob.bias", "prob.weight")].double().norm()

    grads = {n: ((got["grads"][n].double() - g[n].double()).norm()
                 / scale(n)).item() for n in g}
    stats = {n: ((got["buffers"][n].double() - b.double()).abs().max()
                 / b.double().abs().max()).item()
             for n, b in want["buffers"].items()
             if n.endswith(("running_mean", "running_var"))}
    return grads, stats


def step_differences(got: dict, want: dict) -> tuple[float, float]:
    """(worst gradient leaf, worst BatchNorm statistic) of
    :func:`leaf_differences`."""
    grads, stats = leaf_differences(got, want)
    return max(grads.values()), max(stats.values())


def dp_reference(spec: dict, device) -> tuple[dict, list, float]:
    """One process's f32 step of ``spec`` (``entry.data_parallel_step``) on
    ``device``, and the same step with the global batch's rows permuted
    (DP_ORDERS). Returns (the step, (gradients, statistics, loss) of each
    permutation against it, the gradient bound). The gradients are held to
    the larger of GRAD_REL_TOL and DP_NOISE times the step's own float32
    noise: the worse of the two permutations (the same sums in another
    order), measured in this run. The step amplifies rounding: on an
    NVIDIA H100 80GB HBM3 that difference read 3.9e-3 relative L2, above
    GRAD_REL_TOL (and the two ranks' difference 3.5e-3; PERF.md).
    BatchNorm statistics and the loss keep their fixed bounds."""
    from casmvsnet_pl_tpu_torch.data import collate
    from casmvsnet_pl_tpu_torch.entry import data_parallel_step, plane_sample

    data_parallel_step(0, 1, device, dict(spec, out=spec["out"] + ".one"))
    one = torch.load(spec["out"] + ".one.0")
    noise = []
    for i, order in enumerate(DP_ORDERS):
        data_parallel_step(0, 1, device, dict(
            spec, batch=collate([plane_sample(j, spec["img_wh"])
                                 for j in order]),
            out=spec["out"] + f".perm{i}"))
        perm = torch.load(spec["out"] + f".perm{i}.0")
        noise.append(step_differences(perm, one) + (perm["loss"],))
    torch.backends.cudnn.deterministic = False
    return one, noise, max(GRAD_REL_TOL, DP_NOISE * max(n[0] for n in noise))


def dp_compare(ranks: list, spec: dict, how: str, spawned: float,
               reference: tuple, card) -> None:
    """The ranks' saved steps of ``spec`` against one process's
    (:func:`dp_reference`): the loss to rtol 1e-5, every gradient leaf and
    BatchNorm statistic within their bounds, the ranks' gradients equal to
    the bit and each rank's launches DEFAULT_STEP; ``how`` says where the
    ranks ran."""
    one, noise, grad_tol = reference
    world = len(ranks)
    worst, stats = step_differences(ranks[0], one)
    same = all(torch.equal(ranks[0]["grads"][n], r["grads"][n])
               for r in ranks[1:] for n in one["grads"])
    W, H = spec["img_wh"]
    print(f"data-parallel f32 SGD step, {world} ranks {how}, global batch "
          f"{spec['batch']} at {W}x{H}x3 ({spawned!r} s with the "
          f"ranks' start): loss {ranks[0]['loss']!r} against one process's "
          f"{one['loss']!r}; worst gradient leaf relative L2 {worst!r} "
          f"(bound {grad_tol!r}); BatchNorm statistics max relative "
          f"{stats!r} (bound {DP_STAT_TOL}); one process with the rows "
          f"permuted {list(DP_ORDERS)} against it (gradients, statistics, "
          f"loss): {noise!r}; ranks' gradients equal {same}; launches "
          + ", ".join(f"rank {r} {x['launches']}" for r, x in
                      enumerate(ranks))
          + f", one process {one['launches']} [{card}]")
    for r in ranks + [one]:
        expect_counts(r["launches"], DEFAULT_STEP, "data-parallel step")
    if not abs(ranks[0]["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"]):
        raise AssertionError("data-parallel loss differs")
    if not (worst <= grad_tol and stats <= DP_STAT_TOL and same):
        raise AssertionError("data-parallel step differs from one process")


def dp_step(work: str, card) -> None:
    """Phase 36: two ranks on the one card (gloo) against one process
    (:func:`dp_reference`, :func:`dp_compare`)."""
    from casmvsnet_pl_tpu_torch.entry import data_parallel_step
    from casmvsnet_pl_tpu_torch.parallel import spawn

    spec = dict(batch=DP_BATCH, img_wh=IMG_WH, n_depths=DP_N_DEPTHS,
                lr=1e-2, deterministic=True, out=os.path.join(work, "dp"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn(data_parallel_step, 2, (spec,), cpu=DEVICE == "cpu",
          backend="gloo", timeout_s=600, pg_timeout_s=600)
    spawned = time.perf_counter() - t0
    reference = dp_reference(spec, torch.device(DEVICE, 0))
    ranks = [torch.load(f"{spec['out']}.{r}") for r in range(2)]
    dp_compare(ranks, spec, "on one card over gloo", spawned, reference,
               card)


def cli_path(card, train_entry_ms: float, keep: str | None = None) -> dict:
    """Phases 33-36 in a temporary directory; returns the launches of the
    CLI's epoch (phase 34), whose ``last.ckpt`` is copied into ``keep``
    (for phase 38's warm start)."""
    import shutil

    cwd = os.getcwd()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        try:
            tree, dataset_cls = train_tree(work)
            os.chdir(work)
            counts = cli_epoch(tree, dataset_cls, card, train_entry_ms)
            if keep:
                shutil.copy("ckpts/chip/last.ckpt",
                            os.path.join(keep, "dtu_last.ckpt"))
            cli_resume(tree, dataset_cls)
            torch.cuda.empty_cache()
            dp_step(work, card)
        finally:
            os.chdir(cwd)
    print(f"train CLI path (phases 33-36): {time.perf_counter() - t0!r} s "
          f"wall")
    return {"train_cli": counts}


# --- the JPEG datasets: BlendedMVS training, Tanks and BlendedMVS inference -

JPEG_SIZES = ((1920, 1080), (768, 576))     # Tanks' and BlendedMVS' images
JPEG_MODES = {"baseline 4:2:0": {}, "4:4:4": {"subsampling": "4:4:4"},
              "progressive": {"progressive": True},
              "restart interval 16": {"restart_interval": 16}}
# the quality-95 round trip of the plane's smooth texture: 43-49 dB on the
# host (4:2:0 at 768x576 the lowest); a broken codec lands far below
JPEG_PSNR_DB = 40.0
BMVS_NATIVE_WH = (768, 576)     # dataset_low_res's images
BMVS_WH = (768, 576)            # BlendedMVSDataset's default img_wh
BMVS_CAMS = 12                  # a scene: 12 reference views, 10 sources each
BMVS_DEPTHS = 192               # --depth_interval: hypotheses in all
BMVS_STEPS = BMVS_CAMS // CLI_BATCH
BMVS_VAL_BATCHES = BMVS_CAMS // CLI_BATCH
BMVS_EPOCH = summed(scaled(DEFAULT_STEP, BMVS_STEPS),
                    scaled(DEFAULT_FWD, BMVS_VAL_BATCHES + 1))
BMVS_EVAL_VIEWS = 5             # eval_torch.py's --n_views default
TANKS_SCAN = "Family"
TANKS_CAMS = 5
TANKS_IMAGE_SCALE = 1.0         # Family's JPEGs at its native 1920x1080
TANKS_WH = (1152, 864)          # eval.py's resolution
TANKS_MEMORY_WH = (1920, 1056)  # Family's native width, height to 32
TANKS_Z0 = 1.0                  # the plane's depth, scene units
TANKS_SLOPE = 0.1               # z = z0 + slope * X (write_tanks_tree's)
# DEPTH_TOL_MM is 0.05 mm at DTU's 2.65 mm interval: the same share of
# Family's interval (2.5e-3 units)
TANKS_DEPTH_TOL = DEPTH_TOL_MM / 2.65 * 2.5e-3
# the fused ground-truth cloud's distance to the plane, scene units: a
# hundredth of Family's interval
TANKS_PLANE_TOL = 2.5e-5
# BlendedMVS' plane, rescaled by the reader's 100 / depth_min (depth_min
# 0.8 z0): z = 125 + 0.3 x. The fused ground-truth cloud's distance to it,
# units: 99.9 % of the points within 8 ppm of the depth (~130 float32
# steps at 125), every point within 1 unit (on the CPU, eval.py's fusion
# of the same 12 maps puts 0.04 % of its points, one pixel column where
# the sources' sampling meets an image edge, 0.136 units off)
BMVS_PLANE_Z0, BMVS_PLANE_SLOPE = 125.0, 0.3
BMVS_PLANE_TOL, BMVS_PLANE_MAX = 1e-3, 1.0


def jpeg_codec(card) -> None:
    """Phase 37: encode then decode the plane's texture at Tanks' and
    BlendedMVS' image sizes in each JPEG mode; the round trip within
    JPEG_PSNR_DB, and the progressive and restart files (the same
    coefficients) decoded equal to the baseline file."""
    from casmvsnet_pl_tpu_torch.data import PlaneScene
    from casmvsnet_pl_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    for wh in JPEG_SIZES:
        img = (PlaneScene(img_wh=wh, focal=1.2 * wh[0]).render(0)
               * 255).astype(np.uint8)
        decoded = {}
        for mode, kw in JPEG_MODES.items():
            enc, dec = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                data = encode_jpeg(img, **kw)
                t1 = time.perf_counter()
                out, _ = decode_jpeg(data)
                enc.append((t1 - t0) * 1e3)
                dec.append((time.perf_counter() - t1) * 1e3)
            err = out.astype(np.float64) - img
            psnr = 10 * math.log10(255 ** 2 / max((err ** 2).mean(), 1e-12))
            decoded[mode] = out
            print(f"jpeg {wh[0]}x{wh[1]} {mode}, quality 95: {len(data)} "
                  f"bytes; host ms per image, median of 3: encode "
                  f"{statistics.median(enc)!r}, decode "
                  f"{statistics.median(dec)!r}; round trip PSNR {psnr!r} "
                  f"dB (bound {JPEG_PSNR_DB}), max abs "
                  f"{np.abs(err).max()!r} [{card}]")
            if out.shape != img.shape or not psnr >= JPEG_PSNR_DB:
                raise AssertionError(f"jpeg {wh} {mode}: PSNR {psnr}")
        base = decoded["baseline 4:2:0"]
        for mode in ("progressive", "restart interval 16"):
            if not np.array_equal(decoded[mode], base):
                raise AssertionError(f"jpeg {wh} {mode} decodes unlike the "
                                     "baseline file")


def bmvs_train(work: str, dtu_ckpt: str, card) -> tuple[str, dict]:
    """Phase 38: a synthetic BlendedMVS tree; K1 and K2 against their
    plain versions at its train shapes (768x576x3, B=2); one epoch of
    ``train_torch.main --dataset_name blendedmvs``; the warm start from
    phase 34's DTU checkpoint. Returns (the reader's root, the epoch's
    launches)."""
    import train_torch
    from casmvsnet_pl_tpu_torch.data import write_blendedmvs_tree
    from casmvsnet_pl_tpu_torch.kernels import cost_volume_bwd_cuda
    from casmvsnet_pl_tpu_torch.kernels import cost_volume_cuda
    from casmvsnet_pl_tpu_torch.ops import plain_cost_volume_bwd
    from casmvsnet_pl_tpu_torch.probes import k1
    from casmvsnet_pl_tpu_torch.utils import load_checkpoint

    t0 = time.perf_counter()
    root = write_blendedmvs_tree(os.path.join(work, "bmvs"),
                                 n_cams=BMVS_CAMS, img_wh=BMVS_NATIVE_WH)
    print(f"blendedmvs tree: 1 train and 1 val scene, {BMVS_CAMS} cameras "
          f"each, JPEGs at {BMVS_NATIVE_WH[0]}x{BMVS_NATIVE_WH[1]}, written "
          f"in "
          f"{time.perf_counter() - t0!r} s")
    k1.check({cost_volume_cuda.name: cost_volume_cuda}, DEVICE,
             cases=("bmvs_step",))
    check_bwd(cost_volume_bwd_cuda, plain_cost_volume_bwd,
              level_inputs(2, BMVS_WH), BMVS_WH)

    flags = ("--dataset_name", "blendedmvs", "--depth_interval",
             str(BMVS_DEPTHS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer, state = train_torch.main(cli_args(
        root, *flags, "--num_epochs", "1", "--exp_name", "bmvs"),
        time_steps=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect_counts(counts, BMVS_EPOCH, "train_torch.py blendedmvs epoch")
    times = trainer.step_times
    losses = [t["loss"] for t in times]
    if state.step != BMVS_STEPS or len(times) != BMVS_STEPS:
        raise AssertionError(f"blendedmvs epoch: {state.step} steps")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite blendedmvs loss {losses}")
    if not statistics.mean(losses[-2:]) < statistics.mean(losses[:2]):
        raise AssertionError(f"blendedmvs loss did not fall: {losses}")
    steady = times[1:]
    ms = statistics.median(t["step_s"] for t in steady) * 1e3
    wait = sum(t["wait_s"] for t in steady) / sum(t["step_s"]
                                                  for t in steady)
    W, H = BMVS_WH
    print(f"train_torch.py --dataset_name blendedmvs --depth_interval "
          f"{BMVS_DEPTHS} bf16 {W}x{H}x3 batch {CLI_BATCH}, one epoch "
          f"({BMVS_STEPS} steps, {BMVS_VAL_BATCHES} val batches) in {wall!r} "
          f"s: losses {losses!r}; launches {counts}")
    print(f"timing blendedmvs train step (wall, CUDA sync a step, loader "
          f"included, median of steps 2-{BMVS_STEPS}): {ms!r} ms/step, "
          f"{CLI_BATCH * 1000.0 / ms!r} samples/s, loader wait "
          f"{100 * wait!r} % of the step; peak memory {peak!r} GiB [{card}]")
    del trainer, state

    ckpt = load_checkpoint(dtu_ckpt)
    _, state = train_torch.main(cli_args(
        root, *flags, "--num_epochs", "0", "--exp_name", "bmvs_warm",
        "--ckpt_path", dtu_ckpt))
    params = {k: v.detach().cpu() for k, v in
              state.model.named_parameters()}
    loaded = [k for k, v in ckpt["params"].items()
              if k in params and torch.equal(params[k], v)]
    print(f"train_torch.py --dataset_name blendedmvs --ckpt_path "
          f"<phase 34's DTU last.ckpt>: {len(loaded)} of {len(params)} "
          f"parameters equal to the checkpoint's")
    if sorted(loaded) != sorted(params):
        raise AssertionError("blendedmvs warm start missed parameters")
    return root, counts


def tanks_eval(work: str, card) -> tuple[dict, float]:
    """Phase 39: ``eval_torch`` on a synthetic Tanks and Temples tree
    (intermediate split; Family's JPEGs at 1920x1080) at 1152x864x5 in
    bf16: 3 K1 launches a view, depths finite and inside the swept range;
    ms per view; one f32 view with K1 against the plain cost volume; one
    bf16 forward at 1920x1056x5; fusion of the ground-truth depths onto
    the plane. Returns (launches, the 1920x1056 forward's peak GiB)."""
    import eval_torch
    from casmvsnet_pl_tpu_torch.data import (TanksDataset, read_pfm,
                                             save_pfm, write_tanks_tree)
    from casmvsnet_pl_tpu_torch.data.cams import read_cam_file
    from casmvsnet_pl_tpu_torch.data.tanks import INTERMEDIATE_SIZES
    from casmvsnet_pl_tpu_torch.fusion import read_ply
    from casmvsnet_pl_tpu_torch.ops import plain_cost_volume

    tree = os.path.join(work, "tanks")
    t0 = time.perf_counter()
    write_tanks_tree(tree, n_cams=TANKS_CAMS, z0=TANKS_Z0,
                     slope_x=TANKS_SLOPE, image_scale=TANKS_IMAGE_SCALE)
    print(f"tanks tree: intermediate split, {TANKS_CAMS} cameras a scan, "
          f"{TANKS_SCAN}'s JPEGs at {TANKS_IMAGE_SCALE} x 1920x1080, "
          f"written in "
          f"{time.perf_counter() - t0!r} s")

    def args_of(*flags):
        return eval_torch.get_opts([
            "--dataset_name", "tanks", "--root_dir", tree, "--split",
            "intermediate", "--scan", TANKS_SCAN, "--n_views",
            str(TANKS_CAMS), "--img_wh", str(TANKS_WH[0]),
            str(TANKS_WH[1]), *flags])

    args = args_of()
    ds = TanksDataset(tree, "intermediate", n_views=TANKS_CAMS,
                      img_wh=TANKS_WH)
    predict = eval_torch.build_predictor(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    records = eval_torch.run_inference(args, ds, [TANKS_SCAN], predict)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect_counts(counts, scaled(DEFAULT_FWD, TANKS_CAMS), "tanks inference")
    sample = ds[0]
    lo, hi = sweep_range(args, float(sample["init_depth_min"]),
                         float(sample["depth_interval"]))
    W, H = TANKS_WH
    for vid in range(TANKS_CAMS):
        depth = read_pfm(f"results/tanks/depth/{TANKS_SCAN}/"
                         f"depth_{vid:04d}.pfm")[0]
        if depth.shape != (H, W) or not (
                np.isfinite(depth).all() and lo <= depth.min()
                and depth.max() <= hi):
            raise AssertionError(f"tanks view {vid}: depth {depth.shape} "
                                 f"outside [{lo}, {hi}]")
    fwd = [r["forward_ms"] for r in records]
    view = [r["view_ms"] for r in records]
    print(f"tanks inference bf16 {W}x{H}x{TANKS_CAMS}, {len(records)} views "
          f"through eval_torch.run_inference: forward "
          f"{statistics.median(fwd[1:])!r} ms per view (CUDA events, median "
          f"of views 2-{len(records)}; first {fwd[0]!r}), with the JPEG "
          f"reading, transfer and PFM writing {statistics.median(view[1:])!r}"
          f" ms; peak memory {peak!r} GiB; depths in [{lo}, {hi}]; launches "
          f"{counts} [{card}]")

    inputs = (torch.from_numpy(sample["imgs"][None]).to(DEVICE),
              torch.from_numpy(sample["proj_mats"][None]).to(DEVICE),
              float(sample["init_depth_min"]),
              float(sample["depth_interval"]))
    p32 = eval_torch.build_predictor(args_of("--precision", "f32"))
    with torch.no_grad():
        for l in range(3):
            getattr(p32.model, f"cost_reg_{l}").prob.weight *= 30.0
    d_k, _ = counted(lambda: p32(*inputs), DEFAULT_FWD, "tanks f32 view")
    d_p, _ = counted(plain_prob(lambda: p32(
        *inputs, cost_volume=plain_cost_volume)), {}, "tanks f32 plain view")
    dd = (d_k - d_p).abs().max().item()
    print(f"tanks f32 view {W}x{H}x{TANKS_CAMS}, kernel vs plain cost "
          f"volume: max|d depth_0|={dd!r} units (bound {TANKS_DEPTH_TOL!r})"
          f", depth_0 range [{d_k.min().item()!r}, {d_k.max().item()!r}]")
    if not dd < TANKS_DEPTH_TOL:
        raise AssertionError(f"tanks f32 depth_0 kernel vs plain {dd}")
    del p32, d_k, d_p
    torch.cuda.empty_cache()

    big = TanksDataset(tree, "intermediate", n_views=TANKS_CAMS,
                       img_wh=TANKS_MEMORY_WH)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    depth, _ = predict(torch.from_numpy(big["imgs"][None]).to(DEVICE),
                       torch.from_numpy(big["proj_mats"][None]).to(DEVICE),
                       float(big["init_depth_min"]),
                       float(big["depth_interval"]))
    torch.cuda.synchronize()
    big_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"tanks bf16 forward {TANKS_MEMORY_WH[0]}x{TANKS_MEMORY_WH[1]}x"
          f"{TANKS_CAMS}: peak memory {big_peak!r} GiB; depth_0 "
          f"{tuple(depth.shape)} [{card}]")
    del predict, depth
    torch.cuda.empty_cache()

    # the ground-truth depths at 1152x864: the plane z = z0 + slope * X
    # along each column's ray, from the cameras' files (identity rotation,
    # the reader's intrinsics: the native ones scaled by img_wh / native)
    sx = W / INTERMEDIATE_SIZES[TANKS_SCAN][0]
    gt_dir = os.path.join(work, "tanks_gt")
    depth_dir = os.path.join(gt_dir, f"results/tanks/depth/{TANKS_SCAN}")
    os.makedirs(depth_dir)
    for vid in range(TANKS_CAMS):
        K, E, _ = read_cam_file(os.path.join(
            tree, "intermediate", TANKS_SCAN, f"cams/{vid:08d}_cam.txt"))
        dir_x = (np.arange(W) - K[0, 2] * sx) / (K[0, 0] * sx)
        z = (TANKS_Z0 - TANKS_SLOPE * E[0, 3]) / (1 - TANKS_SLOPE * dir_x)
        save_pfm(os.path.join(depth_dir, f"depth_{vid:04d}.pfm"),
                 np.repeat(z.astype(np.float32)[None], H, 0))
        save_pfm(os.path.join(depth_dir, f"proba_{vid:04d}.pfm"),
                 np.ones((H // 4, W // 4), np.float32))
    cwd = os.getcwd()
    os.chdir(gt_dir)
    try:
        t0 = time.perf_counter()
        eval_torch.run_fusion(args_of("--conf", "0.5",
                                      "--min_geo_consistent", "2"),
                              ds, [TANKS_SCAN])
        torch.cuda.synchronize()
        fuse_s = time.perf_counter() - t0
        xyz, rgb = read_ply(f"results/tanks/points/{TANKS_SCAN}.ply")
    finally:
        os.chdir(cwd)
    off = np.abs(xyz[:, 2] - (TANKS_Z0 + TANKS_SLOPE * xyz[:, 0]))
    print(f"tanks fusion of ground-truth depths: {len(xyz)} points, "
          f"distance to the plane mean {off.mean()!r} max {off.max()!r} "
          f"units (bound {TANKS_PLANE_TOL} on the max); run_fusion "
          f"{1e3 * fuse_s / TANKS_CAMS!r} ms per reference view (JPEG and "
          f"PFM reading included) [{card}]")
    if len(xyz) == 0 or not off.max() < TANKS_PLANE_TOL:
        raise AssertionError("tanks fused ground-truth cloud off the plane")
    return counts, big_peak


def bmvs_eval(root: str, work: str, card) -> dict:
    """Phase 40: ``eval_torch.main --dataset_name blendedmvs --split val
    --save_visual`` at 768x576 on phase 38's tree: 3 K1 launches a view,
    the PFMs, the PLY and the two visual JPEGs a view; then the fusion of
    the scene's ground-truth depths onto its plane. Returns the
    launches."""
    import eval_torch
    from casmvsnet_pl_tpu_torch.data import (BlendedMVSDataset, read_pfm,
                                             save_pfm)
    from casmvsnet_pl_tpu_torch.data.base import load_image
    from casmvsnet_pl_tpu_torch.fusion import read_ply

    W, H = BMVS_WH
    scan = "synth_val"
    reset_launches()
    t0 = time.perf_counter()
    eval_torch.main(["--dataset_name", "blendedmvs", "--root_dir", root,
                     "--split", "val", "--img_wh", str(W), str(H),
                     "--save_visual", "--conf", "0.05",
                     "--min_geo_consistent", "2"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    expect_counts(counts, scaled(DEFAULT_FWD, BMVS_CAMS),
                  "blendedmvs inference")
    out = f"results/blendedmvs/depth/{scan}"
    for vid in range(BMVS_CAMS):
        depth = read_pfm(f"{out}/depth_{vid:04d}.pfm")[0]
        proba = read_pfm(f"{out}/proba_{vid:04d}.pfm")[0]
        vis = load_image(f"{out}/depth_visual_{vid:04d}.jpg")
        pvis = load_image(f"{out}/proba_visual_{vid:04d}.jpg")
        if (depth.shape, proba.shape, vis.shape, pvis.shape) != (
                (H, W), (H // 4, W // 4), (H, W, 3), (H // 4, W // 4, 3)):
            raise AssertionError(f"blendedmvs view {vid}: outputs "
                                 f"{depth.shape} {proba.shape} {vis.shape} "
                                 f"{pvis.shape}")
        if not (np.isfinite(depth).all() and np.isfinite(proba).all()):
            raise AssertionError(f"blendedmvs view {vid}: non-finite maps")
    xyz, rgb = read_ply(f"results/blendedmvs/points/{scan}.ply")
    if not np.isfinite(xyz).all():
        raise AssertionError("blendedmvs PLY holds non-finite points")
    print(f"eval_torch.py --dataset_name blendedmvs --split val --save_visual"
          f" {W}x{H}x{BMVS_EVAL_VIEWS}: {BMVS_CAMS} views and their fusion "
          f"({len(xyz)} points at --conf 0.05 from random weights) in "
          f"{wall!r} s; PFMs and visual JPEGs decoded; launches {counts} "
          f"[{card}]")

    # the reader's ground-truth depths and confidence 1 through the same
    # fusion path (its images and projections), at the native size, where
    # the depths are exact
    GW, GH = BMVS_NATIVE_WH
    ds = BlendedMVSDataset(root, "val", n_views=BMVS_EVAL_VIEWS,
                           depth_interval=BMVS_DEPTHS, img_wh=(GW, GH))
    gt_dir = os.path.join(work, "bmvs_gt")
    depth_dir = os.path.join(gt_dir, f"results/blendedmvs/depth/{scan}")
    os.makedirs(depth_dir)
    for vid in range(BMVS_CAMS):
        save_pfm(os.path.join(depth_dir, f"depth_{vid:04d}.pfm"),
                 ds.read_depth_and_mask(scan, vid, 0.0)[0]["level_0"])
        save_pfm(os.path.join(depth_dir, f"proba_{vid:04d}.pfm"),
                 np.ones((GH // 4, GW // 4), np.float32))
    cwd = os.getcwd()
    os.chdir(gt_dir)
    try:
        t0 = time.perf_counter()
        eval_torch.run_fusion(eval_torch.get_opts([
            "--dataset_name", "blendedmvs", "--root_dir", root, "--split",
            "val", "--img_wh", str(GW), str(GH), "--conf", "0.5",
            "--min_geo_consistent", "2"]), ds, [scan])
        torch.cuda.synchronize()
        fuse_s = time.perf_counter() - t0
        xyz, rgb = read_ply(f"results/blendedmvs/points/{scan}.ply")
    finally:
        os.chdir(cwd)
    off = np.abs(xyz[:, 2] - (BMVS_PLANE_Z0 + BMVS_PLANE_SLOPE * xyz[:, 0]))
    if len(xyz) == 0:
        raise AssertionError("blendedmvs fused ground-truth cloud is empty")
    q = float(np.quantile(off, 0.999))
    print(f"blendedmvs fusion of ground-truth depths: {len(xyz)} points, "
          f"distance to the plane mean {off.mean()!r}, 99.9th percentile "
          f"{q!r} (bound {BMVS_PLANE_TOL}), max {off.max()!r} units (bound "
          f"{BMVS_PLANE_MAX}); run_fusion "
          f"{1e3 * fuse_s / BMVS_CAMS!r} ms per reference view (JPEG and "
          f"PFM reading included) [{card}]")
    if not (q < BMVS_PLANE_TOL and off.max() < BMVS_PLANE_MAX):
        raise AssertionError("blendedmvs fused ground-truth cloud off the "
                             "plane")
    return counts


def jpeg_path(card, work: str) -> dict:
    """Phases 37-40 in ``work``, which holds phase 34's DTU checkpoint;
    returns the launches of the three paths."""
    cwd = os.getcwd()
    t0 = time.perf_counter()
    jpeg_codec(card)
    os.chdir(work)
    try:
        root, train = bmvs_train(work, os.path.join(work, "dtu_last.ckpt"),
                                 card)
        torch.cuda.empty_cache()
        tanks, _ = tanks_eval(work, card)
        torch.cuda.empty_cache()
        evals = bmvs_eval(root, work, card)
    finally:
        os.chdir(cwd)
    print(f"JPEG datasets path (phases 37-40): {time.perf_counter() - t0!r} "
          f"s wall")
    return {"bmvs_train": train, "tanks_eval": tanks, "bmvs_eval": evals}


# --- checkpoints from outside the port and the demo: phases 41-43 ---------

REPO = os.path.dirname(os.path.abspath(__file__))
DEMO_TIME_ITERS = 10
DEMO_CONF_TOL = 1e-2    # tests/test_torch_parity.py's confidence bound


def outside_model():
    """The default model with the port's seeded weights (``entry``'s seed
    0) and perturbed BatchNorm statistics and scales, on the host, f32."""
    from casmvsnet_pl_tpu_torch.entry import init_weights
    from casmvsnet_pl_tpu_torch.models import CascadeMVSNet

    model = CascadeMVSNet()
    init_weights(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.running_mean.shape
                m.running_mean += torch.from_numpy(
                    rng.randn(*n).astype(np.float32) * 0.05)
                m.running_var *= torch.from_numpy(
                    1 + 0.1 * rng.rand(*n).astype(np.float32))
                m.weight += torch.from_numpy(
                    rng.randn(*n).astype(np.float32) * 0.1)
    return model.eval()


def save_reference_ckpt(model, path: str) -> None:
    """``model`` as the reference's Lightning trainer (PL 0.7.5, PyTorch
    1.4) saves it: weights under ``model.`` without
    ``num_batches_tracked``, the loss's buffer, ``hparams`` a Namespace,
    optimizer state and a scheduler object, in the legacy format."""
    sd = {"model." + k: v for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    sd["loss.weights"] = torch.ones(3)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, 16)
    torch.save({"epoch": 15, "global_step": 12345, "state_dict": sd,
                "hparams": argparse.Namespace(lr=1e-3, num_epochs=16),
                "optimizer_states": [opt.state_dict()],
                "lr_schedulers": [{"after_scheduler": sched}]}, path,
               _use_new_zipfile_serialization=False)


def save_jax_layout_ckpt(model, path: str) -> None:
    """``model`` as the JAX package's ``save_checkpoint`` writes a
    checkpoint of its trainer (flax msgpack): ``params`` and
    ``batch_stats`` in its names and layouts, an Adam ``opt_state`` and a
    ``step``."""
    from casmvsnet_pl_tpu_torch.utils import jax_from_state_dict, msgpack

    params, stats = jax_from_state_dict(model.state_dict())

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                for k, v in tree.items()}
    opt_state = {"0": {"count": np.asarray(7, np.int32), "mu": zeros(params),
                       "nu": zeros(params)}, "1": {}}
    with open(path, "wb") as f:
        f.write(msgpack.serialize({"params": params, "batch_stats": stats,
                                   "opt_state": opt_state,
                                   "step": np.asarray(7)}))


def check_converted(path: str, model, what: str, card) -> None:
    """The converted file's weights equal ``model``'s, on the card."""
    from casmvsnet_pl_tpu_torch.utils import load_checkpoint

    ckpt = load_checkpoint(path, map_location=DEVICE)
    got = {**ckpt["params"], **ckpt["batch_stats"]}
    want = model.state_dict()
    if sorted(got) != sorted(want) or sorted(ckpt["params"]) != sorted(
            k for k, _ in model.named_parameters()):
        raise AssertionError(f"{what}: names differ from the model's")
    diff = max((got[k].double() - want[k].to(DEVICE).double()).abs().max()
               .item() for k in want)
    unequal = [k for k in want if not torch.equal(got[k],
                                                  want[k].to(DEVICE))]
    print(f"{what}: {len(ckpt['params'])} parameters and "
          f"{len(ckpt['batch_stats'])} buffers, {len(unequal)} unequal to "
          f"the original on the card, max |diff| {diff!r} [{card}]")
    if unequal:
        raise AssertionError(f"{what}: {unequal[:4]} differ")


def demo_main(ckpt: str, png: str, iters: int, what: str, card) -> tuple:
    """``demo_torch.main`` from ``ckpt`` at IMG_WH in bf16; returns (its
    result, its launches)."""
    import demo_torch

    reset_launches()
    out = demo_torch.main(["--ckpt_path", ckpt, "--img_wh", str(IMG_WH[0]),
                           str(IMG_WH[1]), "--precision", "bf16",
                           "--time_iters", str(iters), "--out_png", png])
    torch.cuda.synchronize()
    counts = launch_counts()
    expect_counts(counts, scaled(DEFAULT_FWD, 1 + iters), what)
    if out["ms_per_view"] is not None:
        print(f"{what}: {out['ms_per_view']!r} ms per view, "
              f"{1e3 / out['ms_per_view']!r} views/s (bf16 "
              f"{IMG_WH[0]}x{IMG_WH[1]}x3, CUDA events over {iters} "
              f"forwards); launches {counts} [{card}]")
    return out, counts


def compare_maps(out: dict, depth, conf, what: str, card) -> None:
    dd = float(np.abs(out["depth"] - depth).max())
    dc = float(np.abs(out["confidence"] - conf).max())
    print(f"{what}: max|d depth_0| {dd!r} mm (bound {DEPTH_TOL_MM}), "
          f"max|d confidence_0| {dc!r} (bound {DEMO_CONF_TOL}), depth_0 "
          f"range [{float(out['depth'].min())!r}, "
          f"{float(out['depth'].max())!r}] [{card}]")
    if not (dd < DEPTH_TOL_MM and dc < DEMO_CONF_TOL):
        raise AssertionError(f"{what}: maps differ by {dd} mm, {dc}")


def demo_reference(model, card):
    """The original model's bf16 forward on the demo's sample in this
    process: (depth_0, confidence_0) as numpy, and the f32 check of K1
    against the plain cost volume through the same model (< 0.05 mm)."""
    import demo_torch
    from casmvsnet_pl_tpu_torch.ops import plain_cost_volume

    args = demo_torch.get_opts(["--img_wh", str(IMG_WH[0]), str(IMG_WH[1])])
    inputs = demo_torch.model_inputs(demo_torch.load_sample(args), DEVICE)
    net = copy.deepcopy(model).to(DEVICE, torch.bfloat16)
    depth, conf = counted(lambda: demo_torch.predict(net, inputs),
                          DEFAULT_FWD, "demo forward of the original model")
    ref = (depth[0].float().cpu().numpy(), conf[0].float().cpu().numpy())
    net = copy.deepcopy(model).to(DEVICE)
    outs = []
    for cv, want in ((None, DEFAULT_FWD), (plain_cost_volume, {})):
        def run(cv=cv):
            with torch.inference_mode():
                return net(*inputs, cost_volume=cv)["depth_0"]
        outs.append(counted(run if cv is None else plain_prob(run), want,
                            f"demo f32 forward, cost volume "
                            f"{'K1' if cv is None else 'plain'}"))
    dd = (outs[0] - outs[1]).abs().max().item()
    print(f"demo f32 forward of the converted weights, K1 vs plain cost "
          f"volume at {IMG_WH[0]}x{IMG_WH[1]}x3: max|d depth_0| {dd!r} mm "
          f"(bound {DEPTH_TOL_MM}) [{card}]")
    if not dd < DEPTH_TOL_MM:
        raise AssertionError(f"demo f32 K1 vs plain {dd} mm")
    return ref


def eval_converted(eval_work: str, ckpt: str, model, card) -> dict:
    """Phase 43: ``eval_torch`` with ``--ckpt_path`` the converted file for
    the first view of phase 29's tree; returns its launches."""
    import eval_torch
    from casmvsnet_pl_tpu_torch.data import read_pfm

    tree = os.path.join(eval_work, "tree")
    args = eval_args(tree, "--ckpt_path", ckpt)
    predict = eval_torch.build_predictor(args)      # load_state_dict strict
    ds = eval_reader(os.path.join(eval_work, "lists"))(
        tree, "test", n_views=EVAL_VIEWS, img_wh=EVAL_WH)
    ds.metas = ds.metas[:1]
    work = os.path.join(eval_work, "converted")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_launches()
        records = eval_torch.run_inference(args, ds, ds.scans, predict)
        torch.cuda.synchronize()
        counts = launch_counts()
        scan, vid = ds[0]["scan_vid"]
        depth = read_pfm(f"results/dtu/depth/{scan}/depth_{vid:04d}.pfm")[0]
        proba = read_pfm(f"results/dtu/depth/{scan}/proba_{vid:04d}.pfm")[0]
    finally:
        os.chdir(cwd)
    expect_counts(counts, DEFAULT_FWD, "eval_torch --ckpt_path converted")
    W, H = EVAL_WH
    if depth.shape != (H, W) or proba.shape != (H // 4, W // 4):
        raise AssertionError(f"converted eval: PFM shapes {depth.shape}, "
                             f"{proba.shape}")
    sample = ds[0]
    ref = eval_torch.Predictor(copy.deepcopy(model).to(DEVICE,
                                                       torch.bfloat16),
                               torch.device(DEVICE))
    want, _ = ref(torch.from_numpy(sample["imgs"][None]).to(DEVICE),
                  torch.from_numpy(sample["proj_mats"][None]).to(DEVICE),
                  float(sample["init_depth_min"]),
                  float(sample["depth_interval"]))
    want = np.nan_to_num(want[0].float().cpu().numpy())
    dd = float(np.abs(depth - want).max())
    print(f"eval_torch --ckpt_path <converted reference .ckpt> "
          f"(load_state_dict strict=True), {W}x{H}x{EVAL_VIEWS}, view "
          f"{vid}: forward {records[0]['forward_ms']!r} ms, with reading "
          f"and writing {records[0]['view_ms']!r} ms; depth_0 against the "
          f"original model's forward: max|d| {dd!r} mm (bound "
          f"{DEPTH_TOL_MM}); launches {counts} [{card}]")
    if not (np.isfinite(depth).all() and dd < DEPTH_TOL_MM):
        raise AssertionError(f"converted eval: depth off by {dd} mm")
    return counts


def checkpoint_path(card, eval_work: str) -> dict:
    """Phases 41-43 (``eval_work`` holds phase 29's tree); returns the
    launches of the demo's runs and of the converted eval view."""
    t0 = time.perf_counter()
    model = outside_model()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as work:
        raw, conv = (os.path.join(work, n) for n in ("epoch.15.ckpt",
                                                     "converted.ckpt"))
        save_reference_ckpt(model, raw)
        proc = subprocess.run([sys.executable, os.path.join(
            REPO, "convert_ckpt_torch.py"), raw, conv], capture_output=True,
            text=True, timeout=300)
        print(proc.stdout.strip())
        if proc.returncode:
            print(proc.stderr, file=sys.stderr)
            raise AssertionError("convert_ckpt_torch.py failed")
        check_converted(conv, model, "reference .ckpt (legacy format) "
                        "converted", card)
        ref = demo_reference(model, card)
        demo, demo_counts = demo_main(conv, os.path.join(work, "demo.png"),
                                      DEMO_TIME_ITERS, "demo_torch.main "
                                      "--ckpt_path <converted reference "
                                      ".ckpt>", card)
        compare_maps(demo, *ref, "demo from the converted reference .ckpt "
                     "vs the original model", card)
        t41 = time.perf_counter()

        import convert_ckpt_torch
        msg, conv_jax = (os.path.join(work, n) for n in ("jax.msgpack",
                                                         "from_jax.ckpt"))
        save_jax_layout_ckpt(model, msg)
        convert_ckpt_torch.main([msg, conv_jax])
        check_converted(conv_jax, model, "JAX-layout msgpack converted",
                        card)
        demo_jax, jax_counts = demo_main(
            conv_jax, os.path.join(work, "demo_jax.png"), 0,
            "demo_torch.main --ckpt_path <converted JAX checkpoint>", card)
        compare_maps(demo_jax, demo["depth"], demo["confidence"],
                     "demo from the converted JAX checkpoint vs phase 41's",
                     card)
        t42 = time.perf_counter()
        eval_counts = eval_converted(eval_work, conv, model, card)
    t43 = time.perf_counter()
    print(f"checkpoint path (phases 41-43): {t43 - t0!r} s wall (41: "
          f"{t41 - t0!r}, 42: {t42 - t41!r}, 43: {t43 - t42!r}) [{card}]")
    return {"demo": demo_counts, "demo_jax": jax_counts,
            "eval_converted": eval_counts}


# --- the window mode (sampling="window"), and utils/profiling.py ------------

WINDOW_TOL = 2e-6       # f32, tests/test_window_sampling.py's own bound
WINDOW_ULPS = 2.0       # bf16
# the window applies at level 0 (C=8, D=8); levels 2 and 1 take K1/K2
WINDOW_FWD = {"cost_volume_cuda": 2, **PROB}
WINDOW_STEP = {"cost_volume_cuda": 2, "cost_volume_bwd_cuda": 2, **PROB}
WINDOW_TRAIN_STEPS = 10
K1_SYMBOL = "cost_volume_kernel"


def window_recorder(overflow: list):
    """A ``cost_volume`` for the model: the window mode, which appends each
    windowed level's (B, H, W) mask of pixels in an overflowing group of
    any source view to ``overflow``."""
    from casmvsnet_pl_tpu_torch.ops import build_cost_volume, project_to_src
    from casmvsnet_pl_tpu_torch.ops.plane_sweep import (window_config,
                                                        window_overflow)

    def cost_volume(feats, proj, dv, groups):
        cfg = window_config(feats.shape[-1], dv.shape[1])
        if cfg is not None:
            B, _, H, W, _ = feats.shape
            masks = [window_overflow(project_to_src(proj[:, v], dv, H, W),
                                     H, W, **cfg)
                     for v in range(proj.shape[1])]
            overflow.append(torch.stack(masks).any(0).any(1)
                            .reshape(B, H, W))
        return build_cost_volume(feats, proj, dv, groups, sampling="window")
    return cost_volume


def plain_window_cost_volume(feats, proj, dv, groups):
    """The window route with the plain exact path in place of K1/K2."""
    from casmvsnet_pl_tpu_torch.ops import build_cost_volume, plain_cost_volume
    from casmvsnet_pl_tpu_torch.ops.plane_sweep import window_config
    if window_config(feats.shape[-1], dv.shape[1]) is None:
        return plain_cost_volume(feats, proj, dv, groups)
    return build_cost_volume(feats, proj, dv, groups, sampling="window")


def check_window_sampler(inputs, inputs2, card) -> None:
    """Phase 44: at the plane scene's level-0 shape (C=8, D=8, V=3, B=1
    and 2), the window sampler of each source view and the window cost
    volume (variance and G=8) on the card against the same functions on
    the CPU, moved to the card: f32 within WINDOW_TOL, bf16 within
    WINDOW_ULPS; the share of groups whose span leaves the window; the
    level's forward and forward + backward beside K1 (K1 + K2) at the same
    shape."""
    from casmvsnet_pl_tpu_torch.ops import build_cost_volume, project_to_src
    from casmvsnet_pl_tpu_torch.ops.plane_sweep import (window_config,
                                                        window_overflow,
                                                        window_sample)
    g = torch.Generator(device=DEVICE).manual_seed(44)
    l, C, D, h, w = levels()[-1]
    cfg = window_config(C, D)
    for batch, inp in ((1, inputs), (2, inputs2)):
        proj, dv = inp[l]
        feats = torch.rand((batch, 3, h, w, C), generator=g, device=DEVICE)
        worst, overflow = 0.0, []
        for v in range(2):
            xy = project_to_src(proj[:, v], dv, h, w)
            overflow.append(window_overflow(xy, h, w, **cfg))
            got = window_sample(feats[:, v + 1], xy, cfg)
            want = window_sample(feats[:, v + 1].cpu(), xy.cpu(), cfg)
            worst = max(worst, (got - want.to(DEVICE)).abs().max().item())
        errs = {}
        for groups in (1, 8):
            got = build_cost_volume(feats, proj, dv, groups,
                                    sampling="window")
            want = build_cost_volume(feats.cpu(), proj.cpu(), dv.cpu(),
                                     groups, sampling="window").to(DEVICE)
            fb = feats.to(torch.bfloat16)
            gb = build_cost_volume(fb, proj, dv, groups, sampling="window")
            wb = build_cost_volume(fb.cpu(), proj.cpu(), dv.cpu(), groups,
                                   sampling="window").to(DEVICE)
            errs[groups] = ((got - want).abs().max().item(),
                            ((gb.float() - wb.float()).abs()
                             / bf16_ulp(wb)).max().item())
        share = torch.stack(overflow).float().mean().item()
        print(f"window-check L{l} B={batch} {w}x{h} C={C} D={D} card vs "
              f"CPU: sampler f32 max_abs_err={worst!r}; cost volume "
              f"variance f32 max_abs_err={errs[1][0]!r} bf16 max_ulps="
              f"{errs[1][1]!r}, groupwise8 f32 max_abs_err={errs[8][0]!r} "
              f"bf16 max_ulps={errs[8][1]!r} (bounds {WINDOW_TOL}, "
              f"{WINDOW_ULPS} ulps); groups overflowing the window "
              f"{share!r}")
        if not worst <= WINDOW_TOL or not all(
                e <= WINDOW_TOL and u <= WINDOW_ULPS for e, u in
                errs.values()):
            raise AssertionError(f"window sampler card vs CPU B={batch}")
    # the level's cost volume, bf16: the window route against K1 (forward,
    # B=1) and K1 + K2 (forward + backward, B=2)
    for batch, inp, backward in ((1, inputs, False), (2, inputs2, True)):
        proj, dv = inp[l]
        feats = torch.rand((batch, 3, h, w, C), generator=g, device=DEVICE,
                           dtype=torch.bfloat16, requires_grad=backward)
        go = torch.randn((batch, D, h, w, C), generator=g, device=DEVICE,
                         dtype=torch.bfloat16)

        def run(sampling):
            out = build_cost_volume(feats, proj, dv, sampling=sampling)
            if backward:
                out.backward(go)
            return out
        ms = {s: cuda_ms(lambda: run(s), 10) for s in ("auto", "window",
                                                       "window", "auto")}
        print(f"timing cost volume L{l} bf16 B={batch} "
              f"{'forward + backward' if backward else 'forward'}: window "
              f"{ms['window']!r} ms, K1{' + K2' if backward else ''} "
              f"{ms['auto']!r} ms (each the second of two turns) [{card}]")


def check_window_forward(entry, card) -> dict:
    """Phase 45: the f32 forward through ``entry(sampling="window")``
    against the default path (< 0.05 mm on depth_0 at the pixels outside
    an overflowing level-0 group), then the bf16 window main path (2 K1
    launches, no other kernel) and its times at B=1 and 4."""
    outs, overflow = {}, []
    for sampling, want, cv in (("auto", DEFAULT_FWD, None),
                               ("window", WINDOW_FWD,
                                window_recorder(overflow))):
        fn, args = sharpened_f32_forward(entry, sampling)
        outs[sampling] = counted(lambda: fn(*args, cost_volume=cv), want,
                                 f"f32 forward sampling={sampling}")
        del fn, args
    mask, = overflow
    keep = ~mask
    d = (outs["window"][0] - outs["auto"][0]).abs()
    dd = d[keep].max().item() if keep.any() else 0.0
    dc = (outs["window"][1] - outs["auto"][1]).abs().max().item()
    print(f"forward f32 sampling=window vs default: max|d depth_0|={dd!r} mm "
          f"at the {keep.sum().item()} of {keep.numel()} pixels in no "
          f"overflowing group (bound {DEPTH_TOL_MM}; all pixels "
          f"{d.max().item()!r} mm), max|d confidence_2|={dc!r}; pixels in "
          f"an overflowing group {mask.float().mean().item()!r}")
    if not dd < DEPTH_TOL_MM:
        raise AssertionError(f"f32 window depth_0 vs default {dd} mm")
    counts = forward_main_path(entry, WINDOW_FWD, " sampling=window",
                               sampling="window")
    time_forward(entry, card, label=" sampling=window", sampling="window")
    return counts


def check_window_train(train_entry, card) -> dict:
    """Phase 46: one f32 SGD step, the window route with K1/K2 against it
    with the plain exact path (as phase 9), then WINDOW_TRAIN_STEPS bf16
    Adam steps at full width (2 K1 + 2 K2 a step) and the step's time and
    peak memory."""
    check_train_step(train_entry, plain_window_cost_volume, WINDOW_STEP,
                     sampling="window")
    trainer, state, batch, counts = train_main_path(
        train_entry, card, WINDOW_TRAIN_STEPS, WINDOW_STEP,
        sampling="window")
    time_train(trainer, state, batch, card, label=" sampling=window")
    del trainer, state, batch
    torch.cuda.empty_cache()
    return counts


def eval_window(eval_work: str, card) -> dict:
    """Phase 47: ``eval_torch.run_inference --sampling window`` in bf16 over
    phase 29's tree at 1152x864x5: 2 K1 launches a view and no other
    kernel, depths finite and inside the swept range, ms per view and peak
    memory; then the first view's depth_0 against the default path's and
    the share of its level-0 groups that overflow the window."""
    import eval_torch
    from casmvsnet_pl_tpu_torch.data import read_pfm

    tree = os.path.join(eval_work, "tree")
    # the CLIs list sampling="window" only with this variable set
    with mock.patch.dict(os.environ, {"CASMVS_ENABLE_WINDOW_SAMPLING": "1"}):
        args = eval_args(tree, "--sampling", "window")
    ds = eval_reader(os.path.join(eval_work, "lists"))(
        tree, "test", n_views=EVAL_VIEWS, img_wh=EVAL_WH)
    predict = eval_torch.build_predictor(args)
    work = os.path.join(eval_work, "window")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        records = eval_torch.run_inference(args, ds, ds.scans, predict)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        depths = [read_pfm(f"results/dtu/depth/{EVAL_SCAN}/"
                           f"depth_{vid:04d}.pfm")[0]
                  for vid in range(EVAL_VIEWS)]
    finally:
        os.chdir(cwd)
    expect_counts(counts, scaled(WINDOW_FWD, EVAL_VIEWS),
                  "eval_torch --sampling window")
    lo, hi = sweep_range(args, float(ds[0]["init_depth_min"]),
                         args.depth_interval)
    W, H = EVAL_WH
    for vid, depth in enumerate(depths):
        if depth.shape != (H, W) or not (np.isfinite(depth).all()
                                         and lo <= depth.min()
                                         and depth.max() <= hi):
            raise AssertionError(f"window eval view {vid}: depth "
                                 f"{depth.shape} outside [{lo}, {hi}]")
    sample = ds[0]
    inputs = (torch.from_numpy(sample["imgs"][None]).to(DEVICE),
              torch.from_numpy(sample["proj_mats"][None]).to(DEVICE),
              float(sample["init_depth_min"]),
              float(sample["depth_interval"]))
    overflow = []
    d_win, _ = predict(*inputs, cost_volume=window_recorder(overflow))
    default = eval_torch.build_predictor(eval_args(tree))
    d_def, _ = default(*inputs)
    dev = (d_win.float() - d_def.float()).abs()
    fwd = [r["forward_ms"] for r in records]
    view = [r["view_ms"] for r in records]
    print(f"eval inference bf16 --sampling window {W}x{H}x{EVAL_VIEWS}, "
          f"{len(records)} views through eval_torch.run_inference: forward "
          f"{statistics.median(fwd[1:])!r} ms per view (CUDA events, median "
          f"of views 2-{len(records)}; first {fwd[0]!r}), with reading and "
          f"writing {statistics.median(view[1:])!r} ms; peak memory "
          f"{peak!r} GiB; depths in [{lo}, {hi}]; launches {counts}; view "
          f"0 against the default path: max|d depth_0| "
          f"{dev.max().item()!r} mm, mean {dev.mean().item()!r} mm, pixels "
          f"over 1 mm {(dev > 1.0).float().mean().item()!r}; its pixels "
          f"in an overflowing level-0 group "
          f"{overflow[0].float().mean().item()!r} [{card}]")
    del predict, default
    torch.cuda.empty_cache()
    return counts


def trace_window(entry, train_entry, card) -> None:
    """Phase 48: ``utils/profiling.trace`` around one bf16 window forward
    (B=1) writes a Chrome trace naming K1 twice; ``device_memory_stats``
    reports the card with a peak above 0; then the window forward's and
    train step's device time by kernel name."""
    from casmvsnet_pl_tpu_torch.utils import (StepTimer, device_memory_stats,
                                              live_array_bytes, trace)
    fn, args = entry(DEVICE, torch.bfloat16, img_wh=IMG_WH,
                     sampling="window")
    fn(*args)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as log_dir:
        timer = StepTimer()
        timer.tick(True)
        with trace(log_dir):
            fn(*args)
        s = timer.tick(True)
        files = os.listdir(log_dir)
        if len(files) != 1:
            raise AssertionError(f"trace wrote {files}")
        path = os.path.join(log_dir, files[0])
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k1 = [n for n in kernels if K1_SYMBOL in n]
    stats = device_memory_stats()
    print(f"profiling.trace of one bf16 window forward: {files[0]} "
          f"{size} bytes, {len(events)} events, {len(kernels)} kernel "
          f"launches, {len(k1)} of them {K1_SYMBOL}; the traced forward "
          f"{s!r} s by StepTimer; device_memory_stats {stats}; "
          f"live_array_bytes {live_array_bytes()} [{card}]")
    if len(k1) != WINDOW_FWD.get("cost_volume_cuda", 0):
        raise AssertionError(f"the trace names {K1_SYMBOL} {len(k1)} times")
    if not (len(stats) == torch.cuda.device_count()
            and stats[0]["peak_bytes_in_use"] > 0):
        raise AssertionError(f"device_memory_stats {stats}")
    profile(lambda: fn(*args), " forward bf16 B=1 sampling=window", card)
    del fn, args
    trainer, state, batch = train_entry(DEVICE, img_wh=IMG_WH,
                                        sampling="window")
    profile(lambda: trainer.train_step(state, batch),
            " train step bf16 B=2 sampling=window", card)
    del trainer, state, batch
    torch.cuda.empty_cache()


def window_path(entry, train_entry, inputs, inputs2, eval_work: str,
                card) -> dict:
    """Phases 44-48 (``eval_work`` holds phase 29's tree); returns the
    launches of the window forward, train and eval paths."""
    t0 = time.perf_counter()
    check_window_sampler(inputs, inputs2, card)
    paths = {"window_inference": check_window_forward(entry, card)}
    paths["window_train"] = check_window_train(train_entry, card)
    paths["window_eval"] = eval_window(eval_work, card)
    trace_window(entry, train_entry, card)
    print(f"window path (phases 44-48): {time.perf_counter() - t0!r} s wall "
          f"[{card}]")
    return paths


# --- training quality: the JAX suite's 4-epoch fit and its fused cloud ------

QUALITY_EPOCHS = 4
QUALITY_DTYPE = torch.bfloat16
QUALITY_SEEDS = (1, 2, 3)      # the spread over init_weights' seeds: printed
# phase 50: tests/test_eval_pipeline.py::test_fused_cloud_quality's eval
# flags and bounds (acc, comp and overall in mm; points in the cloud)
CLOUD_FLAGS = ("--conf", "0.5", "--min_geo_consistent", "2")
CLOUD_MM = 12.0
CLOUD_MIN_POINTS = 500
CLOUD_MIN_STL = 1000
CLOUD_SCAN = 1                 # eval_dtu_torch.py reads scan{N}.ply


def fit_summary(fit: dict) -> str:
    from casmvsnet_pl_tpu_torch.engine import convergence
    after = fit["after"]
    return (f"val abs_err {convergence.trajectory(fit)!r} mm (before, "
            f"epochs 1-{len(fit['epochs'])}), after: abs_err "
            f"{after['val/abs_err']!r} acc_2mm {after['val/acc_2mm']!r} "
            f"loss {fit['before']['val/loss']!r} -> {after['val/loss']!r}; "
            f"{fit['step_ms']!r} ms a step (wall, a sync a step, loader "
            f"included, median from step 3); {fit['wall_s']!r} s")


def fit_launches(epochs: int, panels: bool) -> dict:
    """The launches of a ``convergence.quality_fit`` on the card: a step a
    train batch, a forward a val batch (before the fit, each epoch, after
    it) and, with ``panels``, one for each epoch's train panel (the val
    panel reuses its batch's outputs)."""
    from casmvsnet_pl_tpu_torch.engine import convergence as fit
    steps, val = fit.N_TRAIN // fit.BATCH, -(-fit.N_VAL // fit.BATCH)
    return summed(scaled(DEFAULT_STEP, steps * epochs), scaled(
        DEFAULT_FWD, val * (epochs + 2) + (epochs if panels else 0)))


def quality_fit_path(work: str, card) -> tuple[dict, str, type]:
    """Phase 49; returns the card fit's launches, its ``last.ckpt`` and the
    tree's reader."""
    from casmvsnet_pl_tpu_torch.engine import convergence

    root = os.path.join(work, "tiny_dtu")
    dataset_cls = convergence.write_tiny_dtu(root)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # one summation order on the CPU
    try:
        ref = convergence.quality_fit(root, "cpu", torch.float32, seed=0,
                                      epochs=QUALITY_EPOCHS)
    finally:
        torch.set_num_threads(threads)
    print(f"quality fit f32 CPU (one thread, plain cost volume, "
          f"init_weights seed 0): {fit_summary(ref)}")
    ckpt_dir, log_dir = (os.path.join(work, d) for d in ("ckpts", "logs"))
    reset_launches()
    fit = convergence.quality_fit(root, DEVICE, QUALITY_DTYPE, seed=0,
                                  epochs=QUALITY_EPOCHS, ckpt_dir=ckpt_dir,
                                  log_dir=log_dir)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = fit_launches(QUALITY_EPOCHS, panels=True)
    print(f"quality fit {str(QUALITY_DTYPE)[6:]} on the card (K1/K2, the "
          f"same weights): {fit_summary(fit)}; launches {counts} [{card}]")
    expect_counts(counts, want, "quality fit")
    trajectory, ref_trajectory = (convergence.trajectory(f)
                                  for f in (fit, ref))
    failures = convergence.threshold_failures(fit) + \
        convergence.track_failures(trajectory, ref_trajectory)
    files = os.listdir(ckpt_dir)
    if "last.ckpt" not in files or not any(f.startswith("epoch=")
                                           for f in files):
        failures.append(f"checkpoints: {sorted(files)}")
    if not any(f.startswith("events") for f in os.listdir(log_dir)):
        failures.append(f"no events in {os.listdir(log_dir)}")
    band = convergence.TRACK_BAND
    diffs = [g - r for g, r in zip(trajectory, ref_trajectory)]
    print(f"quality fit card - CPU abs_err per epoch {diffs!r} mm (band "
          f"max({band['mm']} mm, {band['rel']} x CPU)); thresholds "
          f"{convergence.THRESHOLDS}")
    if failures:
        raise AssertionError(f"quality fit: {failures}")
    for seed in QUALITY_SEEDS:
        other = convergence.quality_fit(root, DEVICE, QUALITY_DTYPE,
                                        seed=seed, epochs=QUALITY_EPOCHS)
        after = other["after"]
        print(f"quality fit seed {seed} on the card: abs_err "
              f"{after['val/abs_err']!r} mm acc_2mm "
              f"{after['val/acc_2mm']!r}, thresholds "
              f"{convergence.threshold_failures(other) or 'met'}; "
              f"trajectory {convergence.trajectory(other)!r} [{card}]")
    return counts, os.path.join(ckpt_dir, "last.ckpt"), dataset_cls


def cloud_score(work: str, dataset_cls, ckpt: str, tag: str, card
                ) -> tuple[dict, int, dict]:
    """``eval_torch``'s inference and fusion of ``ckpt`` over the recipe's
    test scan, the cloud scored by ``eval_dtu_torch.py`` in a subprocess;
    returns the inference's launches, the cloud's points and the scan's
    JSON record (with ``overall``)."""
    import eval_torch
    from casmvsnet_pl_tpu_torch.data import PlaneScene
    from casmvsnet_pl_tpu_torch.engine import convergence
    from casmvsnet_pl_tpu_torch.fusion import read_ply, write_ply

    root = os.path.join(work, "tiny_dtu")
    args = eval_torch.get_opts([
        "--root_dir", root, "--split", "test", "--n_views",
        str(convergence.N_VIEWS), "--img_wh", "64", "64", "--n_depths",
        *map(str, convergence.N_DEPTHS), "--interval_ratios",
        *map(str, convergence.INTERVAL_RATIOS), "--precision",
        "bf16" if QUALITY_DTYPE == torch.bfloat16 else "f32",
        "--ckpt_path", ckpt, *CLOUD_FLAGS])
    ds = dataset_cls(root, "test", n_views=convergence.N_VIEWS,
                     img_wh=(64, 64))
    scan = convergence.SCANS["test"]
    reset_launches()
    records = eval_torch.run_inference(args, ds, [scan])
    torch.cuda.synchronize()
    counts = launch_counts()
    expect_counts(counts, scaled(DEFAULT_FWD, len(ds)), "cloud inference")
    t0 = time.perf_counter()
    eval_torch.run_fusion(args, ds, [scan])
    fusion_s = time.perf_counter() - t0
    scored = os.path.join(work, f"scored_{tag}")
    os.makedirs(scored)
    xyz, rgb = read_ply(f"results/dtu/points/{scan}.ply")
    write_ply(os.path.join(scored, f"scan{CLOUD_SCAN}.ply"), xyz, rgb)
    stl = PlaneScene(img_wh=(64, 64), n_views=5, z0=460.0,
                     slope_x=0.3).surface_points()
    write_ply(os.path.join(scored, f"stl{CLOUD_SCAN:03d}_total.ply"), stl,
              np.zeros(stl.shape, np.uint8))
    out_json = os.path.join(scored, "dtu_eval.json")
    subprocess.run([sys.executable, os.path.join(
        REPO, "evaluations", "dtu", "eval_dtu_torch.py"), "--ply_dir",
        scored, "--gt_dir", scored, "--scans", str(CLOUD_SCAN), "--out_json",
        out_json], check=True, timeout=300)
    with open(out_json) as f:
        (res,) = json.load(f)["per_scan"]
    res["overall"] = 0.5 * (res["mean_acc"] + res["mean_comp"])
    fwd = [r["forward_ms"] for r in records]
    print(f"trained cloud ({tag}): {len(xyz)} points fused from "
          f"{len(records)} views ({args.precision} inference at "
          f"64x64x{convergence.N_VIEWS}, {CLOUD_FLAGS}); eval_dtu_torch.py: "
          f"acc {res['mean_acc']!r} comp {res['mean_comp']!r} overall "
          f"{res['overall']!r} mm (bound {CLOUD_MM}), n_data "
          f"{res['n_data']} n_stl {res['n_stl']}; forward "
          f"{statistics.median(fwd[1:])!r} ms per view (CUDA events, median "
          f"of views 2-{len(fwd)}; first {fwd[0]!r}); fusion "
          f"{1e3 * fusion_s / len(records)!r} ms per view; launches "
          f"{counts} [{card}]")
    return counts, len(xyz), res


def cloud_path(work: str, seed_ckpt: str, dataset_cls, card) -> dict:
    """Phase 50 (in ``work``, phase 49's directory); returns the launches of
    the fit from JAX's start and of its cloud's inference."""
    from casmvsnet_pl_tpu_torch.engine import convergence
    from casmvsnet_pl_tpu_torch.utils import jax_initial_weights

    ckpt_dir = os.path.join(work, "ckpts_jax")
    reset_launches()
    fit = convergence.quality_fit(
        os.path.join(work, "tiny_dtu"), DEVICE, QUALITY_DTYPE,
        weights=jax_initial_weights(convergence.model(), 0),
        epochs=QUALITY_EPOCHS, ckpt_dir=ckpt_dir)
    torch.cuda.synchronize()
    fit_counts = launch_counts()
    print(f"quality fit {str(QUALITY_DTYPE)[6:]} on the card from JAX's "
          f"initial weights (PRNGKey 0, utils/jax_init.py): "
          f"{fit_summary(fit)}; thresholds "
          f"{convergence.threshold_failures(fit) or 'met'}; launches "
          f"{fit_counts} [{card}]")
    expect_counts(fit_counts, fit_launches(QUALITY_EPOCHS, panels=False),
                  "quality fit from JAX's start")
    counts, points, res = cloud_score(
        work, dataset_cls, os.path.join(ckpt_dir, "last.ckpt"), "jax_start",
        card)
    if not (points > CLOUD_MIN_POINTS and res["n_data"] > CLOUD_MIN_POINTS
            and res["n_stl"] > CLOUD_MIN_STL):
        raise AssertionError(f"trained cloud: {points} points, {res}")
    if not (res["mean_acc"] < CLOUD_MM and res["mean_comp"] < CLOUD_MM
            and res["overall"] < CLOUD_MM):
        raise AssertionError(f"trained cloud scores {res}")
    # phase 49's fit, from init_weights seed 0: reported, not held
    cloud_score(work, dataset_cls, seed_ckpt, "init_weights_seed_0", card)
    return {"quality_fit_jax": fit_counts, "quality_cloud": counts}


def quality_path(card) -> dict:
    """Phases 49-50 in a temporary directory; returns the launches of the
    card's fit from seed 0 (phase 49), of its fit from JAX's start and of
    that fit's cloud inference (phase 50)."""
    cwd = os.getcwd()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quality_") as work:
        try:
            os.chdir(work)
            fit_counts, ckpt, dataset_cls = quality_fit_path(work, card)
            t49 = time.perf_counter()
            paths = cloud_path(work, ckpt, dataset_cls, card)
        finally:
            os.chdir(cwd)
    t50 = time.perf_counter()
    print(f"quality path (phases 49-50): {t50 - t0!r} s wall (49: "
          f"{t49 - t0!r}, 50: {t50 - t49!r}) [{card}]")
    return {"quality_fit": fit_counts, **paths}


def kernel_line(name, source, replaces, launches_by_path, main_path,
                max_err, times, timed, library_ms=None) -> dict:
    """One entry of the kernels' JSON line; ``launches`` is the count of
    the ``main_path`` run."""
    k_ms, p_ms, b_ms, by = times
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_by_path[main_path],
            "launches_by_path": launches_by_path, "max_abs_err": max_err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms, "timed": timed}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path",
              file=sys.stderr)
        return 1
    from casmvsnet_pl_tpu_torch.entry import entry, train_entry
    from casmvsnet_pl_tpu_torch.kernels import cost_volume_bwd_cuda as kbwd
    from casmvsnet_pl_tpu_torch.kernels import cost_volume_cuda as kernel
    from casmvsnet_pl_tpu_torch.ops import plain_cost_volume as plain
    from casmvsnet_pl_tpu_torch.ops import plain_cost_volume_bwd as pbwd
    from casmvsnet_pl_tpu_torch.ops import plain_quad_cost_volume
    from casmvsnet_pl_tpu_torch.probes import k1

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = toolchain()
    build_kernel(kernel)
    inputs = level_inputs()
    inputs2 = level_inputs(batch=2)
    errs = {"cost_volume_cuda": check_kernel(kernel, plain, inputs)}
    k1.check({kernel.name: kernel}, DEVICE, cases=("eval",))
    paths = {"inference": check_forward(entry, plain)}
    time_forward(entry, card)
    errs["cost_volume_bwd_cuda"] = check_bwd(kbwd, pbwd, inputs2)
    check_train_step(train_entry, plain, DEFAULT_STEP)
    trainer, state, batch, paths["train"] = train_main_path(
        train_entry, card, TRAIN_STEPS, DEFAULT_STEP)
    train_entry_ms = time_train(trainer, state, batch, card)
    del trainer, state, batch
    torch.cuda.empty_cache()

    errs.update(check_epilogues(inputs))
    errs.update(check_epilogues_bwd(inputs2))
    paths["quad_inference"] = check_quad_forward(entry)
    check_train_step(train_entry, plain_quad_cost_volume, QUAD_STEP,
                     sampling="quad")
    trainer, state, batch, paths["quad_train"] = train_main_path(
        train_entry, card, QUAD_TRAIN_STEPS, QUAD_STEP, sampling="quad")
    time_train(trainer, state, batch, card, label=" sampling=quad")
    del trainer, state, batch
    torch.cuda.empty_cache()
    g8 = {"sampling": "quad", "num_groups": 8}
    paths["quad_g8_inference"] = forward_main_path(
        entry, G8_FWD, " sampling=quad num_groups=8", **g8)
    *_, paths["quad_g8_train"] = train_main_path(
        train_entry, card, G8_TRAIN_STEPS, G8_STEP, **g8)
    torch.cuda.empty_cache()
    time_forward(entry, card, label=" sampling=quad", sampling="quad")
    kernel_times = time_kernels(inputs, inputs2, card)
    k1_shapes = time_k1_shapes(kernel, card, k1)
    errs["prob_conv_cuda"], prob_times = prob_conv_phase(card)
    errs["deform_conv_cuda"], dcn_times = deform_conv_phase(card)
    errs["fmt_layer_cuda"], fmt_times = fmt_layer_phase(card)
    errs["in_conv_cuda"], in_conv_times = in_conv_phase(card)
    errs["deform_conv_bwd_cuda"], dcn_bwd_times = deform_conv_bwd_phase(card)
    paths["transmvsnet"] = transmvsnet_path(entry)
    paths["transmvsnet_train"] = transmvsnet_train_path(train_entry, card)
    arf_cell_scatter(card)
    profile_paths(entry, train_entry, card)

    errs.update(check_tap_reduce(inputs2))
    check_warp(inputs2)
    views = list(warp_views(inputs2, torch.bfloat16, 17))
    paths["warp"] = warp_main_path(views, card)
    tap_times, tap_library_ms = time_tap_reduce(inputs2, card)
    kernel_times.update(tap_times)
    profile(lambda: warp_pass(views), " warp bf16 B=2 forward + backward, "
            "2 source views x 3 levels", card)
    del views
    torch.cuda.empty_cache()
    probe_results, paths["probes"] = probes_path(card)
    host_costs(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as eval_work:
        paths.update(eval_path(card, keep=eval_work))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_jpeg_") as work:
            paths.update(cli_path(card, train_entry_ms, keep=work))
            paths.update(jpeg_path(card, work))
        torch.cuda.empty_cache()
        paths.update(checkpoint_path(card, eval_work))
        paths.update(window_path(entry, train_entry, inputs, inputs2,
                                 eval_work, card))
    paths.update(quality_path(card))

    # "launches" is the count of the kernel's main path (the default path's
    # training run for K1 and K2, the quad configuration's for #3-#6, the
    # warp's for #7/#8, the probes' for #9-#13, eval's for the prob conv);
    # "launches_by_path" gives every path's own run, and "timed" says what
    # ms, plain_ms and bound_ms cover. No single PyTorch call computes K1,
    # K2, #3-#6, #9, #10 or #12, so their library_ms is null; #7's is a
    # batched torch.matmul, #11's rows[..., :C].contiguous(), #13's
    # index_select, the prob conv's F.conv3d; #8 has none.
    def by_path(name, keys):
        return {p: paths[p].get(name, 0) for p in keys}

    default_paths = ("inference", "train", "quad_inference", "quad_train",
                     "eval", "eval_g8", "train_cli", "bmvs_train",
                     "tanks_eval", "bmvs_eval", "demo", "demo_jax",
                     "eval_converted", "window_inference", "window_train",
                     "window_eval", "quality_fit", "quality_fit_jax",
                     "quality_cloud")
    g8_paths = ("quad_g8_inference", "quad_g8_train")
    csrc = "casmvsnet_pl_tpu_torch/csrc/"
    pe = "casmvsnet_pl_tpu/kernels/patch_epilogue.py:"
    kce = "scripts/kernel_cost_epilogue.py:"
    lines = []
    for name, source, replaces, keys, timed in (
            ("cost_volume", "cost_volume.cu", pe + "134", default_paths,
             "bf16 variance B=1"),
            ("cost_volume_bwd", "cost_volume_bwd.cu", pe + "172",
             default_paths, "bf16 variance B=2"),
            ("variance_epilogue", "cost_epilogue.cu", kce + "197",
             default_paths, "bf16 variance B=1"),
            ("variance_epilogue_bwd", "cost_epilogue_bwd.cu", kce + "224",
             default_paths, "bf16 variance B=2"),
            ("groupwise_epilogue", "cost_epilogue.cu", kce + "377", g8_paths,
             "bf16 G=8 B=1"),
            ("groupwise_epilogue_bwd", "cost_epilogue_bwd.cu", kce + "404",
             g8_paths, "bf16 G=8 B=2")):
        cname = name + "_cuda"
        main_path = ("quad_g8_train" if "groupwise" in name else "quad_train"
                     if "epilogue" in name else "train")
        lines.append(kernel_line(
            name, csrc + source, replaces, by_path(cname, keys), main_path,
            errs[cname], kernel_times[cname],
            timed + ", sum over the 3 level shapes"))
    ktr = "scripts/kernel_tap_reduce.py:"
    for name, line, library_ms in (("tap_reduce", "86", tap_library_ms),
                                   ("tap_reduce_bwd", "121", None)):
        cname = name + "_cuda"
        lines.append(kernel_line(
            name, csrc + "tap_reduce.cu", ktr + line,
            by_path(cname, default_paths + g8_paths + ("warp",)), "warp",
            errs[cname], kernel_times[cname],
            "bf16 rows of one source view B=2, sum over the 3 level shapes",
            library_ms))
    # the prob conv: no TPU kernel; cuDNN's conv is its plain version and
    # the library call it replaced
    k_ms, p_ms, b_ms, by, byte_ms = prob_times["eval"]
    prob_line = kernel_line(
        "prob_conv", csrc + "prob_conv.cu", None,
        by_path("prob_conv_cuda", default_paths + g8_paths), "eval",
        errs["prob_conv_cuda"], (k_ms, p_ms, b_ms, by),
        "bf16 x and parameters B=1 (eval), sum over the 3 level shapes",
        p_ms)
    prob_line.update(
        pct_of_bound=100 * b_ms / k_ms, byte_bound_ms=byte_ms,
        shapes={case: {"ms": t[0], "library_ms": t[1], "bound_ms": t[2],
                       "byte_bound_ms": t[4]} for case, t in
                prob_times.items()})
    lines.append(prob_line)
    # the ARF's deformable conv: no TPU kernel, no library call
    lines.append(kernel_line(
        "deform_conv", csrc + "deform_conv.cu", None,
        by_path("deform_conv_cuda", default_paths + ("transmvsnet",)),
        "transmvsnet", errs["deform_conv_cuda"], dcn_times,
        "bf16 x, offsets and weight, 5 views at 1152x864, one conv a level, "
        "sum over the 3 level shapes"))
    # the deformable conv's backward: no TPU kernel, no library call
    lines.append(kernel_line(
        "deform_conv_bwd", csrc + "deform_conv_bwd.cu", None,
        by_path("deform_conv_bwd_cuda", default_paths + (
            "transmvsnet", "transmvsnet_train")), "transmvsnet_train",
        errs["deform_conv_bwd_cuda"], dcn_bwd_times,
        "bf16 x, offsets, weight and output gradient, B=2 x 5 views at "
        "640x512, one conv a level, sum over the 3 level shapes"))
    # the FMT's layer: no TPU kernel, no library call
    lines.append(kernel_line(
        "fmt_layer", csrc + "fmt_layer.cu", None,
        by_path("fmt_layer_cuda", default_paths + ("transmvsnet",)),
        "transmvsnet", errs["fmt_layer_cuda"], fmt_times,
        "bf16 views, the FMT's 8 layers (4 self, 4 cross) over 5 views of "
        "62,208 tokens at 1152x864"))
    # the one-channel input block: no TPU kernel; cuDNN's conv, BatchNorm
    # and leaky ReLU are its plain version and the library calls it replaced
    lines.append(kernel_line(
        "in_conv", csrc + "in_conv.cu", None,
        by_path("in_conv_cuda", default_paths + g8_paths + ("transmvsnet",)),
        "transmvsnet", errs["in_conv_cuda"], in_conv_times,
        "bf16 x and parameters B=1 (eval), sum over the 3 level shapes",
        in_conv_times[1]))
    all_paths = default_paths + g8_paths + ("warp", "probes")
    summary = probe_summary(probe_results)
    for name, source, line in (
            ("lane_prefix_copy", "probe_copy_gather.cu", "probe_epi3.py:88"),
            ("row_gather_ldg", "probe_copy_gather.cu", "probe_gather.py:18"),
            ("row_gather_cp_async", "probe_copy_gather.cu",
             "probe_gather.py:18"),
            ("row_gather_bulk", "probe_copy_gather.cu", "probe_gather.py:18"),
            ("lane_gather", "probe_copy_gather.cu", "probe_gather.py:18"),
            ("variance_dblk", "probe_epilogue.cu", "probe_epi2.py:69"),
            ("variance_v3", "probe_epilogue.cu", "probe_epi3.py:62"),
            ("patch_epilogue_t", "patch_epilogue_t.cu", "probe_epi5.py:101")):
        k_ms, p_ms, b_ms, by, err, lib, timed = summary[name + "_cuda"]
        lines.append(kernel_line(
            name, csrc + source, "scripts/" + line,
            by_path(name + "_cuda", all_paths), "probes", err,
            (k_ms, p_ms, b_ms, by), timed, lib))
    # K1, the kernel this slice redesigned: its share of the bound, its
    # registers at the main path's instantiations (ptxas, this build) and
    # its times at the other shapes of phase 18
    k1_line = lines[0]
    k1_line["pct_of_bound"] = 100 * k1_line["bound_ms"] / k1_line["ms"]
    k1_line["registers"] = {k: v[0] for k, v in k1.registers(
        kernel.build_log).items() if k.startswith("bf16") and k.endswith(
            "G=1")}
    k1_line["shapes"] = {case: {"ms": ms, "bound_ms": b_ms} for case, (
        ms, b_ms) in k1_shapes.items()}
    for entry_ in lines:
        if entry_["launches"] < 1:
            raise AssertionError(f"{entry_['name']} never launched on its "
                                 "main path")
    print(json.dumps({"kernels": lines}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
