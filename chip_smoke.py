"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each printing one line; any failure exits non-zero:

1. device: CUDA, triton/yaml availability, nvcc, card name and power limit;
   builds the bilinear-gather, trilinear-lift and the two 3x3-conv kernel
   sources from `rgbd_gan_tpu_torch/csrc/`, one nvcc for each source, all at
   once; prints ptxas's registers, shared memory and spills of the FMA
   conv, the vectorised lift and bilinear backward kernels and the bilinear
   kernels with a group of lanes per point (at C = 257 and C = 3), and fails
   unless the tensor-core conv's SASS holds HGMMA (Hopper's warpgroup MMA)
   and the lift's and the bilinear gather's each a vector reduction of 4
   floats (`red.global.add.v4.f32`).
2. bilinear kernel parity at the StyleGAN step's shapes (B=32, H=W=128, C=4,
   N=16384) and at the DeepVoxels step's (B=10, H=W=64, N=4096), exact True
   and False, on uniform random points and on the points the 3D loss
   gathers at (cameras from the yml's prior over a smooth depth map): K1
   (forward) and both kernels of K2 (backward: the vectorised one and the
   thread-per-point one) against the plain PyTorch version, with both times;
   K2's two kernels in turns (generic, vectorised, vectorised, generic);
   `F.grid_sample` and its backward (`aten.grid_sampler_2d_backward`) held
   to the plain version and timed beside K1 and K2; the merge factor of the
   vectorised K2's reductions on each set of points, as its lane rule
   models it (counted in Python, not on the card). Then at the feature
   3D-consistency loss's shapes (`rotate_feature`: D's 32x32 tap of ch 256
   features plus one depth channel, B=32, H=W=32, C=257, N=1024, exact),
   where K1 and K2 run their kernels with a warp per point, the same checks
   and yardsticks, with each of them and the old thread-per-point kernel in
   turns (generic, lanes, lanes, generic), and a third set of points: those
   the feature loss gathers at (its depth the pooled blue channel of the
   main paths' synthetic real batch, cameras from the yml's prior). Each
   set's in-bounds share is printed (`[kernel_bounds]`).
3. trilinear kernel parity at the DeepVoxels step's shapes (B=10, G=32,
   C=32, N=56*64*64 frustum cells under cameras from the yml's prior): K3,
   K4 and the windowed pair K5, float32 and bf16 operands, against the plain
   PyTorch version, with both times; `F.grid_sample` timed beside K3 and its
   backward (`aten.grid_sampler_3d_backward`) beside K4. On the main paths'
   pairs (f32 full, bf16 windowed) the forward's and the backward's two
   routes each in turns (generic, vectorised, vectorised, generic): the
   thread-per-(cell, channel) kernel and the vectorised one, each held
   against the other and against the plain version.
4. K6, the fused 3x3 conv + bias + leaky ReLU, on its path: the measuring
   function of `rgbd_gan_tpu_torch.tools.bench_conv` at its five shapes in
   float32 and bfloat16, holding the kernel against the plain PyTorch
   version, with its time, the plain version's, cuDNN conv + leaky ReLU's
   and the bound; every bfloat16 call must have launched the tensor-core
   kernel and every float32 call the FMA kernel. Then, outside the path's
   count, the FMA kernel and the tensor-core kernel in bfloat16 in turns at
   every shape, and the FMA kernel and cuDNN in float32 in turns.
5. one StyleGAN train step at a small width (ch 32, batch 4, 32 px, rotate
   and occlusion on) from the same weights and draws, on the CPU with the
   plain gather and on the card with the kernels; the losses must agree.
6. the same for one DeepVoxels step (ch 32, batch 2, both occlusion nets).
7. the StyleGAN main path: the port's trainer at full width (ch 256, batch
   32, 128 px, the ffhq_stylegan_occlusion values) for 5 iterations through
   the CLI's run function, with a snapshot at the end; losses finite, and
   K1 and the vectorised K2 launched once per iteration, the thread-per-
   point K2 never (phases 5 and 6 check the same of their one step).
8. the DeepVoxels main path: the deepvoxels_shapenet_car values (ch 256,
   batch 10, 64 px, accumulative, focal gamma 2) for 5 iterations the same
   way; the windowed lift launched twice forward and once backward per
   iteration, each on its vectorised kernel, the bilinear kernels once each.
9. the same configuration with `lift_mode: pallas_f32` for 2 iterations, so
   that the full-width lift kernels run on a path too (vectorised only).
10. bf16 step parity, the twin of phase 5 with `mixed16: True` and
   `r1_interval: 2`: two steps (R1, then none) from the same weights and
   draws on the CPU (plain gather) and on the card (kernels), losses held to
   `STEP_BF16_ATOL`; beside it the distance between the card's bf16 steps
   and its float32 steps on the same draws.
11. the StyleGAN main path in bf16 (`mixed16: True`, R1 every step), as
   phase 7; then with `r1_interval: 16` for 18 iterations, so that two
   steps take the penalty: their times and the median of the plain steps
   are printed apart.
12. the DeepVoxels main path in bf16, as phase 8 (the windowed lift 10
   forward, 5 backward).
   In phases 11 and 12 forward pre-hooks check that a G trunk conv, a D
   conv, a 3D conv of the voxel generator and a refiner conv see bf16
   inputs, and the toRGBD head and `lift_frustum`'s voxel input float32: a
   run that trains in float32 fails.
   After phase 8's run, `cli/evaluate.py --preview` renders its DeepVoxels
   snapshot in eval mode: the windowed lift's forward (K5) launched once
   per generator forward, one per chunk of 16 images, 4 for the 8x8 grid.
13. DCGAN step parity, the twin of phase 5 (ch 32, which the trainer's
   quirk uses as the latent width; the hidden width stays 512): one step on
   the CPU and on the card from the same weights and draws, f32 held to
   phase 5's tolerance, then bf16 (`mixed16`) held to phase 10's.
14. the DCGAN main path: `configs/dcgan_shapenet_car.yml` as published
   (ch 256, hidden 512, batch 32, 128 px at stage 10, `res_dis`, R1 every
   step) for 5 iterations in f32, then in bf16 with the dtype hooks of
   phase 11 on a DCGAN block conv (bf16) and the toRGBD head (float32); K1
   and the vectorised K2 once per iteration. After the f32 run,
   `cli/evaluate.py --preview --fid --inception --n_images 200 --batchsize
   100` on its snapshot with a random Inception-v3 (the real statistics from
   the synthetic images): FID finite and non-negative, IS at least 1; then
   the Inception forward's time per batch of 100 at 299 px.
15. `configs/structured_spheres_dcgan.yml` with its `step_window: 10`,
   `keep_smoothed_gen: True` and previews every 10 iterations, 20
   iterations at 32 px (3D loss from iteration 0): the window runs as plain
   steps (K1 and K2 once per iteration), and `preview/` and
   `preview_smoothed/` each hold a grid of the expected shape.
16. step parity of the rest of the DeepVoxels family, SN and rotate-feature,
   the twin of phases 5 and 6: one small step on the CPU and on the card
   from the same weights and draws, losses held to phase 5's tolerance (the
   DeepVoxels `dis/loss_adv`, after the generator's update, to phase 6's):
   DeepVoxels with `background_generator` (both occlusion nets; K1 and the
   vectorised K2 twice a step, the foreground and the background term),
   with `rendernet_projection` and with `sn`; StyleGAN with `sn`,
   `rotate_feature`, `use_occupancy_net_loss` and `rotate_conv_input` (the
   SN vectors after the step held too), and with `rotate_feature` and R1,
   which adds the feature-gradient penalty. The rotate-feature steps launch
   the vectorised K1 and K2 once each (the RGBD gather) and the lanes K1
   and K2 twice each (a feature gather at C = ch + 1 in each phase).
17. the full-width paths of phase 16 through the CLI's run function:
   `deepvoxels_shapenet_car.yml` with `background_generator: True` for 5
   iterations (no preview inside the run: the JAX package has no eval
   forward for it), the same yml with `rendernet_projection: True` for 3,
   and `ffhq_stylegan_occlusion.yml` (ch 256, batch 32, 128 px) with `sn`,
   `rotate_feature`, `use_occupancy_net_loss` and `rotate_conv_input` for 5,
   each with its launch counts asserted and its ms/step and peak memory
   printed; for the last, the in-bounds share of its feature gathers.
18. the RGB paths (`rgb: True`) at phase 5's small width, CPU vs card from
   the same weights and draws: one RGB step of StyleGAN with R1, two of
   DCGAN with `r1_interval: 2` (the penalty on the first only), one of
   StyleGAN in bf16 (held to `STEP_BF16_ATOL`), one legacy step with style
   mixing forced on in both phases, and the forwards of the encoder (its
   BatchNorm in training mode), BigBiGAN's discriminator and the
   disentangled discriminator (held to `HEAD_REL`). No kernel of the port
   may launch: the RGB step has no 3D loss, so it gathers nothing.
19. the full-width RGB paths through the CLI's run function, each with every
   K1-K6 launch count 0 and its ms/step, img/s and peak memory printed:
   `ffhq_stylegan_occlusion.yml` with `rgb: True` (ch 256, batch 32, 128 px,
   R1 every step) for 5 iterations in f32, then in bf16 with phase 11's
   dtype hooks, with `cli/evaluate.py --preview` on the f32 snapshot (an
   8x8 grid of RGB images, no depth rows); `dcgan_shapenet_car.yml` with
   `rgb: True` for 5; the legacy step at the StyleGAN yml's widths with
   style mixing at 0.9, 3 steps; and `structured_spheres_dcgan.yml` with
   `rgb: True` and `nvprof: True`, which must stop at 10 of its 20
   iterations and write a trace with CUDA kernels under `out/profile/`.
20. data parallelism (`use_mpi: True`) with two ranks on the one card, each
   a spawned process given its device: NCCL's answer to two ranks on one
   device is printed; a one-rank NCCL group runs the port's averaging
   functions on CUDA tensors; then, on the backend the probe leaves (gloo,
   reducing the card's tensors through the host, where NCCL refuses):
   phase 5's step on two ranks (4 images and its own draws a rank) on the
   card against the same two-rank step on the CPU, the ranks bit-identical;
   `ffhq_stylegan_occlusion.yml` (ch 256, global batch 32, 16 a rank, 128
   px, R1, 5 iterations) and `deepvoxels_shapenet_car.yml` with
   `rendernet_projection` (2 ranks x 6, 3 iterations) through the CLI's run
   function, each rank's ms/step, peak memory and K1/K2/K5 launches printed
   (K1 and K2 once a step on each rank; the windowed lift twice forward and
   once backward), only rank 0 writing `log.jsonl` and the snapshot, the
   parameters' digest the same on both ranks, and the RenderNet BatchNorm
   statistics the same on both ranks and the mean of the ranks' own. Two
   ranks on one card check correctness; they are not a figure of the speed
   of data parallelism.
21. the Inception converter chain: a synthetic `classify_image_graph_def.pb`
   (the real topology at 299 px, random constants) through
   `rgbd_gan_tpu_torch.tools.convert_inception` to the npz, loaded with
   `load_params` on the card; the GraphDef executor on the card against it
   (`pool_3` features and logits, TF's average pools swapped into the
   model) and against itself on the CPU. No kernel launches.

Each path (the benchmark of phase 4, the runs of phases 7-9, 11, 12, 14,
15, 17, 19 and 20, and the three evaluations) is driven with every kernel's launch
count set to 0 just before it and read just after; the script's wall time
is printed before the kernels line. The line before the last is a JSON object describing
each kernel (its time beside its bound, the plain version's time and, where
one exists, a single PyTorch call's; K6's two kernels, FMA and tensor
cores, one entry each; K2 and the lift's with the old kernel's time in
turns; K1 and K2 with the kernels by C, `launches_by_path` over every path
above, `launches_by_kernel`, and their figures `at_rotate_feature_shapes`,
there with the old kernel's time in turns too); the last is
`{"ok": true, "device": {...}}`. There is no CPU path: without a card the
script exits with an error.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the ffhq_stylegan_occlusion.yml values, cut to a 5-iteration run pinned at
# stage 10 (128 px) with the 3D-consistency loss on from iteration 0 and a
# report row every iteration (for the per-step times)
FFHQ_STYLEGAN_OCCLUSION = dict(
    adam_alpha_g=0.001, adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999,
    lambda_gp=1.0, sn=False, smoothing=0.999, keep_smoothed_gen=False,
    batchsize=32, stage_interval="0,0,0,0,0,0,0,0,0,0,0", max_stage=11, iteration=5,
    start_rotation=-1, start_occlusion_aware=0, auto_resume=False, ch=256,
    generator_architecture="stylegan", bigan=False, rotate_conv_input=False,
    res_dis=True, focal_loss_gamma=1.0, lambda_depth=10, depth_min=1.0,
    x_rotate=0.3054, y_rotate=1.0472, z_rotate=0, x_translate=0, y_translate=0,
    z_translate=0, test_x_rotate=0, test_y_rotate=0.7854, test_z_rotate=0, test_x_translate=0,
    test_y_translate=0, test_z_translate=0, use_mpi=False, enable_cuda_profiling=False,
    snapshot_interval=10000, evaluation_sample_interval=500, display_interval=1,
    get_model_from_interation="", style_mixing_rate=0.0, enable_blur=False,
    nvprof=False,
)
# the deepvoxels_shapenet_car.yml values, cut to 5 iterations with the
# 3D-consistency loss on from iteration 0 and a report row every iteration
DEEPVOXELS_SHAPENET_CAR = dict(
    nvprof=False, adam_alpha_g=0.001, adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999,
    lambda_gp=1.0, sn=False, smoothing=0.999, keep_smoothed_gen=False,
    batchsize=10, stage_interval="0,0,0,0,0,0,0,0", max_stage=11, iteration=5,
    start_rotation=-1, start_occlusion_aware=0, auto_resume=False, ch=256,
    generator_architecture="deepvoxels", bigan=False, rotate_conv_input=False,
    res_dis=True, focal_loss_gamma=2.0, lambda_depth=10, depth_min=0.6,
    occlusion_type="accumulative",
    x_rotate=0.3054, y_rotate=3.1415, z_rotate=0, x_translate=0, y_translate=0,
    z_translate=0, test_x_rotate=0, test_y_rotate=3.1415, test_z_rotate=0, test_x_translate=0,
    test_y_translate=0, test_z_translate=0, uniform_distribution=True, use_mpi=False,
    snapshot_interval=10000, evaluation_sample_interval=50, display_interval=1,
    get_model_from_interation="", style_mixing_rate=0.0, enable_blur=False,
)
# the dcgan_shapenet_car.yml values, cut to a 5-iteration run pinned at stage
# 10 (128 px) with the 3D-consistency loss on from iteration 0 and a report
# row every iteration
DCGAN_SHAPENET_CAR = dict(
    nvprof=False, adam_alpha_g=0.001, adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999,
    lambda_gp=1.0, sn=False, smoothing=0.999, keep_smoothed_gen=False,
    batchsize=32, stage_interval="0,0,0,0,0,0,0,0,0,0,0", max_stage=11, iteration=5,
    start_rotation=-1, start_occlusion_aware=0, auto_resume=False, ch=256,
    generator_architecture="dcgan", bigan=False, rotate_conv_input=False,
    res_dis=True, focal_loss_gamma=1.0, lambda_depth=10, depth_min=0.6, lambda_geometric=1,
    x_rotate=0.3054, y_rotate=3.1415, z_rotate=0, x_translate=0, y_translate=0, z_translate=0,
    test_x_rotate=0, test_y_rotate=3.1415, test_z_rotate=0, test_x_translate=0, test_y_translate=0,
    test_z_translate=0, use_mpi=False, enable_cuda_profiling=False,
    snapshot_interval=10000, evaluation_sample_interval=500, display_interval=1,
    get_model_from_interation="", style_mixing_rate=0.0, enable_blur=False,
)
# the structured_spheres_dcgan.yml values (step_window 10, keep_smoothed_gen,
# 32 px from stage 6), cut to 20 iterations with the 3D-consistency loss on
# from iteration 0, a preview every 10 iterations and a report row every one
STRUCTURED_SPHERES_DCGAN = dict(
    DCGAN_SHAPENET_CAR, keep_smoothed_gen=True, stage_interval="0,0,0,0,0,0,0,2000", max_stage=7,
    iteration=20, start_occlusion_aware=0, snapshot_interval=4000, evaluation_sample_interval=10,
    step_window=10,
)
# the full-width paths of the rest of the DeepVoxels family, SN and rotate-feature:
# deepvoxels_shapenet_car.yml with the background generator (5 iterations; its
# eval forward has no reference, so no preview falls inside the run) and with
# RenderNet (3 iterations); ffhq_stylegan_occlusion.yml with SN, the feature
# 3D-consistency loss, the occupancy loss and rotate_conv_input (5 iterations)
DEEPVOXELS_BACKGROUND = dict(DEEPVOXELS_SHAPENET_CAR, background_generator=True, evaluation_sample_interval=10000)
DEEPVOXELS_RENDERNET = dict(DEEPVOXELS_SHAPENET_CAR, rendernet_projection=True, iteration=3)
FFHQ_SN_ROTATE_FEATURE = dict(FFHQ_STYLEGAN_OCCLUSION, sn=True, rotate_feature=True, use_occupancy_net_loss=True,
                              rotate_conv_input=True)
# the bilinear gather's shapes on the StyleGAN path, on the DeepVoxels paths,
# and of the feature 3D-consistency loss at full width (D's 32x32 tap of ch
# 256 features plus one depth channel), with the exact modes measured there
BILINEAR_SHAPES = {
    "stylegan": dict(B=32, H=128, W=128, C=4, N=128 * 128),
    "deepvoxels": dict(B=10, H=64, W=64, C=4, N=64 * 64),
    "rotate_feature": dict(B=32, H=32, W=32, C=257, N=32 * 32),
}
BILINEAR_EXACT_MODES = {"stylegan": (True, False), "deepvoxels": (True, False), "rotate_feature": (True,)}
LIFT_SHAPE = dict(B=10, G=32, C=32, N=56 * 64 * 64)
# the bilinear kernels' launch counts after one train step on the card: the
# RGBD gather (C = 4) on the vectorised K1 and K2; the thread-per-point
# kernels (`fwd` at any C other than 4, `bwd`) never
BILINEAR_NONE = {"fwd": 0, "fwd_lanes": 0, "bwd": 0, "bwd_vec4": 0, "bwd_lanes": 0}
BILINEAR_ONE_STEP = dict(BILINEAR_NONE, fwd=1, bwd_vec4=1)
# with the background generator: the foreground and the background terms
# each gather once (C = 4)
BILINEAR_BACKGROUND_STEP = dict(BILINEAR_NONE, fwd=2, bwd_vec4=2)
# with rotate_feature: the RGBD gather (C = 4) and one feature gather (C =
# ch + 1, a group of lanes a point) in each phase; both feature gathers
# differentiate into the image (through D into G in the G phase, into D in
# the D phase)
BILINEAR_ROTATE_FEATURE_STEP = dict(BILINEAR_NONE, fwd=1, fwd_lanes=2, bwd_vec4=1, bwd_lanes=2)
# the lift's launch counts with nothing launched
LIFT_NONE = {k: 0 for k in ("fwd", "fwd_vec4", "bwd", "bwd_vec4", "fwd_win", "fwd_win_vec4", "bwd_win",
                            "bwd_win_vec4")}
# the kernel sources of `rgbd_gan_tpu_torch/csrc/`, one nvcc each, all at once
SOURCES = ("bilinear", "trilinear", "conv3x3", "conv3x3_tc")


def lanes_instance(direction: str, exact: bool, c: int) -> str:
    """The lanes kernel's instance that ``dispatch_lanes`` in
    ``csrc/bilinear.cu`` launches at C = ``c``: L = min(32, the power of two
    >= C) lanes a point, and 9 channels a lane in registers at L = 32, else 1."""
    lanes = min(32, 1 << max(0, c - 1).bit_length())
    return f"bilinear_{direction}_lanes_kernel<{str(exact).lower()}, {lanes}, {9 if lanes == 32 else 1}>"


# ptxas figures printed: the lanes kernels' instances at C = 257 (a warp a
# point) and at C = 3 (4 lanes a point)
NEW_KERNELS = ("conv3x3_kernel", "lift_bwd_vec4_kernel", "bilinear_bwd_vec4_kernel") + tuple(
    lanes_instance(d, e, c) for d in ("fwd", "bwd") for e in (True, False) for c in (257, 3))
# published peaks of one H100 SXM: HBM bytes/s and f32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
FWD_ATOL = 1e-5
DIMG_RTOL, DIMG_ATOL = 1e-5, 1e-4  # atomics reorder the sums
# du and dv are sums over the C channels: held to DUV_ATOL at C = 4, and
# to DUV_ATOL * sqrt(C / 4) at another C, the growth of float32 rounding
# in a sum of C terms taken in another order (at C = 257: 8.0e-5; read on
# an H100 80GB HBM3: 1.3e-5)
DUV_ATOL = 1e-5
STEP_RTOL, STEP_ATOL = 1e-3, 1e-4  # CPU vs card, f32 with TF32 off
LIFT_F32_RTOL, LIFT_F32_ATOL = 1e-5, 1e-5  # fused multiply-adds against separate ones
LIFT_BF16_RTOL, LIFT_BF16_ATOL = 2.0**-7, 1e-5  # at most one bf16 ulp where a sum's order differs
LIFT_DV_RTOL, LIFT_DV_ATOL = 1e-5, 1e-4  # atomics reorder the sums
GRID_SAMPLE_ATOL = 1e-4  # another formula for the same weights
GRID_SAMPLE_DV_RTOL, GRID_SAMPLE_DV_ATOL = 1e-4, 2e-4  # the same, summed over a corner's cells
# F.grid_sample's backward against K2's plain version: du and dv only at
# points this far (pixels) from a grid line, where the normalised
# coordinate's rounding cannot pick the other one-sided derivative
GRID_LINE_MARGIN = 1e-3
LIBRARY_DUV_ATOL = 2e-4  # its weights from the normalised coordinate
# K6 against its plain version: largest absolute error over max|y| in float32
# (the taps' products summed in another order); in bfloat16 one bf16 ulp of
# the larger value plus that float32 allowance, taken before the one rounding
CONV_F32_REL = 1e-4
CONV_REPS = 10
# The DeepVoxels D phase renders through the generator *after* Adam's first
# step, which moves every element by alpha times the sign of its gradient:
# float32 noise in the elements whose gradient all but cancels (biases in
# front of an instance norm, the tails of the refiner's kernels) flips signs
# between the CPU and the card. So dis/loss_adv is held loosely, and the
# share of generator elements that ended more than 1e-4 apart is bounded.
# Read on an H100 80GB HBM3: 8.154e-03 with the accumulative net, 4.053e-05
# with the softmax net.
DIS_AFTER_UPDATE_ATOL = 2e-2
MAX_SHARE_APART = 0.01
# With the background generator and the softmax occlusion net the
# background's weight, 1 - (the softmax's sum over depth), is float32
# rounding, so every gradient of the background generator is noise, and
# Adam's first step moves all of its parameters by up to alpha with signs
# that noise picks. The D phase renders through them: moving the weights by
# 1e-7 of their mean magnitude moved dis/loss_adv by 3.7e-2 on the CPU (a
# probe at phase 16's configuration; phase 16 repeats it and prints it), and
# the card read 3.2e-2 from the CPU (NVIDIA H100 80GB HBM3, 700 W).
DIS_AFTER_UPDATE_NOISY_ATOL = 1e-1
# phase 10: the bf16 trunk on the CPU (oneDNN) and on the card (cuDNN) sums in
# other orders and rounds each activation to 8 bits of mantissa, so the two
# steps' losses are held loosely. Read on an H100 80GB HBM3: 1.552e-03 (the
# card's bf16 and float32 steps: 4.233e-02 apart)
STEP_BF16_ATOL = 3e-3
# phase 16: the SN power-iteration vectors after one step, CPU vs card
SN_U_ATOL = 1e-5
# phase 14's evaluation: images scored, and the Inception-v3 batch
EVAL_IMAGES, EVAL_BATCH = 200, 100
# phase 18: the heads' forwards (the encoder's BatchNorm in training mode
# over a batch of 4) CPU vs card, the largest difference over the largest
# magnitude of the CPU output
HEAD_REL = 1e-4
# phase 19: the RGB paths (rgb: True) of the shipped ymls; the legacy step at
# the StyleGAN yml's widths with the legacy updater's style mixing; and
# structured_spheres_dcgan.yml under nvprof, whose run stops at 10 iterations
# whatever the yml's count (20 here)
FFHQ_STYLEGAN_RGB = dict(FFHQ_STYLEGAN_OCCLUSION, rgb=True)
DCGAN_SHAPENET_CAR_RGB = dict(DCGAN_SHAPENET_CAR, rgb=True)
STRUCTURED_SPHERES_DCGAN_NVPROF = dict(STRUCTURED_SPHERES_DCGAN, rgb=True, nvprof=True)
NVPROF_ITERATIONS = 10
LEGACY_STEPS, LEGACY_MIXING_RATE = 3, 0.9
# phase 20: two ranks on the one card, each a spawned process; the
# full-width paths with use_mpi: True (StyleGAN: global batch 32, 16 a rank,
# 5 iterations; DeepVoxels with RenderNet: 2 ranks x 6, 3 iterations: the
# yml's batch of 10 gives 5 a rank, and the step draws its latents in pairs,
# which an odd batch breaks, in either package); the
# seconds a group of ranks may take (the NCCL probe's); the DeepVoxels
# BatchNorm statistics against the mean of the ranks' own (float32 sums of
# two, halved: one rounding)
DP_WORLD = 2
FFHQ_STYLEGAN_DP = dict(FFHQ_STYLEGAN_OCCLUSION, use_mpi=True)
DEEPVOXELS_RENDERNET_DP = dict(DEEPVOXELS_RENDERNET, use_mpi=True, batchsize=12)
DP_TIMEOUT, DP_PROBE_TIMEOUT = 400, 90
DP_STATS_RTOL = 1e-6
# phase 21: the GraphDef executor against the converted model (TF's pools
# swapped in) and against itself on the CPU, over the largest pool_3
# feature or logit: float32 convolutions summed in other orders over 94
# layers (read on the CPU at 75 px: under 1e-5)
CONVERTER_REL = 1e-4


def _reset_launches() -> None:
    from rgbd_gan_tpu_torch.ops import bilinear, conv, trilinear

    bilinear.reset_launches()
    trilinear.reset_launches()
    conv.reset_launches()


def _read_launches() -> dict:
    from rgbd_gan_tpu_torch.ops import bilinear, conv, trilinear

    return {"bilinear": dict(bilinear.launches), "trilinear": dict(trilinear.launches), "conv": dict(conv.launches)}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def phase_device(torch):
    try:
        import triton  # noqa: F401

        has_triton = True
    except ImportError:
        has_triton = False
    try:
        import yaml  # noqa: F401

        has_yaml = True
    except ImportError:
        has_yaml = False
    from rgbd_gan_tpu_torch.ops._build import load_library, nvcc_path, ptxas_report

    nvcc_version = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True).stdout
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()

    def build(name):
        t0 = time.perf_counter()
        lib = load_library(name)
        return name, (lib._name, f"{time.perf_counter() - t0:.2f}")

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        built = dict(pool.map(build, SOURCES))
    log(
        "device", torch=torch.__version__, cuda=torch.version.cuda, triton=has_triton, yaml=has_yaml,
        nvcc=repr(nvcc_version.strip().splitlines()[-1] if nvcc_version else "missing"),
        build_s=json.dumps({name: os.path.basename(so) + " " + sec for name, (so, sec) in built.items()}),
    )
    # registers, shared memory and spills of this PR's kernels, from ptxas
    report = {}
    for name, (so, _) in built.items():
        report.update({k: v for k, v in _ptxas_figures(ptxas_report(so)).items() if k.startswith(NEW_KERNELS)})
    log("ptxas", kernels=json.dumps(report))
    # the tensor-core kernel really runs on the tensor cores: Hopper's warpgroup MMA in its SASS
    hgmma = _count_in_sass(built["conv3x3_tc"][0], "HGMMA")
    reductions = {name: _opcodes_in_sass(built[name][0], ("RED", "ATOM")) for name in ("trilinear", "bilinear")}
    log("sass", conv3x3_tc_HGMMA=hgmma, conv3x3_HGMMA=_count_in_sass(built["conv3x3"][0], "HGMMA"),
        **{f"{name}_reductions": json.dumps(ops) for name, ops in reductions.items()})
    if hgmma == 0:
        raise AssertionError("conv3x3_tc.cu has no HGMMA instruction")
    # the vectorised lift backward and K2 reduce 4 floats an instruction
    for name, ops in reductions.items():
        if not any(op.startswith("RED") and "F32x4" in op for op in ops):
            raise AssertionError(f"{name}.cu has no vector reduction of 4 floats: {ops}")
    print(smi, flush=True)
    return has_yaml


def _ptxas_figures(text: str) -> dict:
    """{kernel: {registers, smem_bytes, spill_stores, spill_loads}} from
    ``nvcc -Xptxas -v``'s report, kernel names demangled."""
    import re

    figures, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _demangle(m.group(1))
            figures[name] = {}
        elif name and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            figures[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            figures[name].update(registers=int(regs.group(1)), smem_bytes=int(smem.group(1)) if smem else 0)
    return figures


def _demangle(symbol: str) -> str:
    res = subprocess.run(["c++filt", symbol], capture_output=True, text=True)
    name = res.stdout.strip() if res.returncode == 0 and res.stdout.strip() else symbol
    return name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")


def _sass(so: str) -> str:
    from rgbd_gan_tpu_torch.ops._build import nvcc_path

    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {so}: {res.stderr}")
    return res.stdout


def _count_in_sass(so: str, opcode: str) -> int:
    return sum(opcode in line for line in _sass(so).splitlines())


def _opcodes_in_sass(so: str, prefixes) -> dict:
    """{opcode: count} of the SASS instructions of ``so`` whose opcode
    starts with one of ``prefixes`` (e.g. RED.E.ADD.F32...)."""
    import re

    counts = {}
    for m in re.finditer(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)", _sass(so)):
        op = m.group(1)
        if op.startswith(tuple(prefixes)):
            counts[op] = counts.get(op, 0) + 1
    return counts


def _time_ms(torch, fn, reps: int = 20, attempts: int = 3):
    """(device ms, wall ms) per call. Device time is the sum of the CUDA
    kernels the call launches, from the profiler; a profile whose kernel
    records are not a whole multiple of ``reps`` lost some (one summed about
    2 of 5 calls' kernels) and is taken again, up to ``attempts`` times, then None,
    as when it records no device time. Wall time is between CUDA events
    around back-to-back calls, so it includes the host's launch overhead
    where that exceeds the kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / reps
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.device_time for e in kernels)
        if kernels and len(kernels) % reps == 0 and device_us > 0:
            return device_us / 1e3 / reps, wall
    return None, wall


def _warp_points(torch, path: str, gen, depth=None):
    """The points the 3D-consistency loss gathers at (``rotate_consistency_loss``):
    B/2 camera pairs from the path's yml prior, both warp directions over
    ``depth`` (B, H, W), by default a smooth depth map, batched as the loss
    batches them; (u, v), each (B, H*W)."""
    from rgbd_gan_tpu_torch.core.config import Config
    from rgbd_gan_tpu_torch.geometry.camera import camera_matrices
    from rgbd_gan_tpu_torch.geometry.prior import CameraParamPrior
    from rgbd_gan_tpu_torch.geometry.warp import (
        CLIP_Z_MAX, CLIP_Z_MIN, intrinsics, inv_warp, pixel_grid, relative_pose, warp,
    )

    b, h, w = (BILINEAR_SHAPES[path][k] for k in "BHW")
    values = DEEPVOXELS_SHAPENET_CAR if path == "deepvoxels" else FFHQ_STYLEGAN_OCCLUSION
    half = b // 2
    mats = camera_matrices(CameraParamPrior(Config(values)).sample(gen, b, "cuda"))
    if depth is None:
        ys = torch.linspace(0.0, 1.0, h, device="cuda")[:, None]
        xs = torch.linspace(0.0, 1.0, w, device="cuda")[None, :]
        phase = torch.rand(b, 2, 1, 1, generator=gen, device="cuda") * (2 * math.pi)
        depth = values["depth_min"] + 0.5 + 0.25 * torch.sin(2 * math.pi * xs + phase[:, 0]) * torch.cos(
            2 * math.pi * ys + phase[:, 1])
    z = depth.reshape(b, 1, h * w)
    k = intrinsics(w, device="cuda")
    inv_k = torch.linalg.inv(k)
    p = pixel_grid(w, device="cuda")
    r, t = relative_pose(mats[:half], mats[half:])
    zp = torch.cat([warp(k, inv_k, r, t, z[:half], p), inv_warp(k, inv_k, r.transpose(1, 2), t, z[half:], p)])
    zc = torch.clamp(zp[..., 2], CLIP_Z_MIN, CLIP_Z_MAX)
    return (zp[..., 1] / zc).contiguous(), (zp[..., 0] / zc).contiguous()


def _feature_points(torch, gen):
    """The points the feature 3D-consistency loss gathers at
    (``train/steps.py:_feature_rotate_loss``): its depth is the blue channel
    of the real batch in [-1, 1] (the main paths' synthetic images, the first
    B of them at 128 px), average-pooled to the 32x32 feature tap, under
    cameras from ``ffhq_stylegan_occlusion.yml``'s prior."""
    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
    from rgbd_gan_tpu_torch.train.losses import _avg_pool_by

    b, h = BILINEAR_SHAPES["rotate_feature"]["B"], BILINEAR_SHAPES["rotate_feature"]["H"]
    real = torch.from_numpy(synthetic_dataset(64, 128)[:b].transpose(0, 2, 3, 1).copy()).cuda()
    depth = _avg_pool_by(real.to(torch.float32)[..., -1:] / 127.5 - 1.0, 128 // h)
    return _warp_points(torch, "rotate_feature", gen, depth[..., 0])


def _device_or_wall(ms) -> float:
    dev, wall = ms
    return dev if dev is not None else wall


def _in_turns(torch, calls: dict, order):
    """Calls timed alternately in ``order``: the mean time of each over its
    turns, and the list of turn times."""
    turns = [(k, _device_or_wall(_time_ms(torch, calls[k]))) for k in order]
    return {k: statistics.mean(t for k_, t in turns if k_ == k) for k in set(order)}, [round(t, 4) for _, t in turns]


# the launch count that each route of K1 and K2 moves
FWD_KEYS = {"vec4": "fwd", "generic": "fwd", "lanes": "fwd_lanes"}
BWD_KEYS = {"vec4": "bwd_vec4", "generic": "bwd", "lanes": "bwd_lanes"}


def phase_kernels(torch, path: str):
    """K1 and K2 against the plain version at the shapes ``path`` gives them,
    on uniform random points, on the points the 3D loss gathers at and, at
    the feature loss's shapes, on the points that loss gathers at; each
    kernel and the old thread-per-point one in turns where both take the
    call (K2 at every C, K1 at C != 4; at C = 4 the old forward is the
    vectorised one); one PyTorch call for each beside them. Returns the
    largest errors and, by point set, the exact mode's times and bounds."""
    from rgbd_gan_tpu_torch.ops import bilinear
    from rgbd_gan_tpu_torch.tools import bilinear_yardstick as yardstick

    b, h, w, c, n = (BILINEAR_SHAPES[path][k] for k in "BHWCN")
    g = torch.Generator(device="cuda").manual_seed(0)
    img = torch.rand(b, h, w, c, generator=g, device="cuda")
    # in-bounds, out-of-bounds and integer points
    u = torch.rand(b, n, generator=g, device="cuda") * 1.4 * (h - 1) - 0.2 * (h - 1)
    v = torch.rand(b, n, generator=g, device="cuda") * 1.4 * (w - 1) - 0.2 * (w - 1)
    u[:, ::7] = torch.floor(u[:, ::7])
    v[:, ::5] = torch.floor(v[:, ::5])
    cot = torch.randn(b, n, c, generator=g, device="cuda")
    points = {"random": (u, v), "warp": _warp_points(torch, path, g)}
    if path == "rotate_feature":
        points["feature"] = _feature_points(torch, g)
    vec4 = c == 4
    if (bilinear.fwd_route(c), bilinear.bwd_route(c)) != (("vec4",) * 2 if vec4 else ("lanes",) * 2):
        raise AssertionError(f"K1/K2's inputs (C={c}) do not take the kernels expected")
    fwd_routes = ("vec4",) if vec4 else ("lanes", "generic")
    bwd_routes = (bilinear.bwd_route(c), "generic")
    duv_atol = DUV_ATOL * math.sqrt(c / 4)
    errs = {"fwd": 0.0, "bwd": 0.0}
    by_points = {}
    for kind, (pu, pv) in points.items():
        for exact in BILINEAR_EXACT_MODES[path]:
            bound, in_bounds = _gather_bounds(torch, img, pu, pv, exact)
            log("kernel_bounds", shapes=path, points=kind, exact=exact, fwd=json.dumps(bound["fwd"]),
                bwd=json.dumps(bound["bwd"]), in_bounds_points=in_bounds, of=b * n,
                in_bounds_share=f"{in_bounds / (b * n):.4f}")
            ref = bilinear.bilinear_gather_reference(img, pu, pv, exact)
            fwd_errs = {}
            for route in fwd_routes:
                before = dict(bilinear.launches)
                out = bilinear._fwd(img, pu, pv, exact, route=route)
                torch.cuda.synchronize()
                key = FWD_KEYS[route]
                if bilinear.launches != {**before, key: before[key] + 1}:
                    raise AssertionError(f"K1 route {route} launched {bilinear.launches} (before {before})")
                fwd_errs[route] = (out - ref).abs().max().item()
            e_fwd = max(fwd_errs.values())
            rdimg, rdu, rdv = bilinear.bilinear_gather_reference_vjp(img, pu, pv, cot, exact)
            bwd_errs, bwd_ok = {}, True
            for route in bwd_routes:
                before = dict(bilinear.launches)
                dimg, du, dv = bilinear._bwd(img, pu, pv, cot, exact, route=route)
                torch.cuda.synchronize()
                key = BWD_KEYS[route]
                if bilinear.launches != {**before, key: before[key] + 1}:
                    raise AssertionError(f"K2 route {route} launched {bilinear.launches} (before {before})")
                bwd_errs[route] = {"dimg": (dimg - rdimg).abs().max().item(), "du": (du - rdu).abs().max().item(),
                                   "dv": (dv - rdv).abs().max().item()}
                bwd_ok &= (torch.allclose(dimg, rdimg, rtol=DIMG_RTOL, atol=DIMG_ATOL)
                           and max(bwd_errs[route]["du"], bwd_errs[route]["dv"]) <= duv_atol)
                if exact and not torch.all(du == 0):
                    bwd_ok = False
            # one PyTorch call each: F.grid_sample and its backward at the same points
            grid = yardstick.library_grid(pu, pv, h, w, exact)
            lout = yardstick.gather(img, grid)
            ldimg, ldu, ldv = yardstick.gather_vjp(img, grid, cot, exact)
            mask = (pu >= 0) & (pu < h - 1) & (pv >= 0) & (pv < w - 1)
            away_v, away_u = (mask & (x - torch.floor(x) > GRID_LINE_MARGIN) & (torch.ceil(x) - x > GRID_LINE_MARGIN)
                              for x in (pv, pu))
            lib_errs = {"fwd": (lout - ref).abs().max().item(), "dimg": (ldimg - rdimg).abs().max().item(),
                        "dv": (ldv - rdv)[away_v].abs().max().item() if bool(away_v.any()) else 0.0,
                        "du": 0.0 if exact else ((ldu - rdu)[away_u].abs().max().item() if bool(away_u.any()) else 0.0)}
            lib_ok = (lib_errs["fwd"] <= GRID_SAMPLE_ATOL
                      and torch.allclose(ldimg, rdimg, rtol=GRID_SAMPLE_DV_RTOL, atol=GRID_SAMPLE_DV_ATOL)
                      and max(lib_errs["dv"], lib_errs["du"]) <= LIBRARY_DUV_ATOL)
            del out, ref, rdimg, rdu, rdv, dimg, du, dv, lout, ldimg, ldu, ldv
            calls = {
                "fwd": lambda: bilinear._fwd(img, pu, pv, exact),
                "fwd_plain": lambda: bilinear.bilinear_gather_reference(img, pu, pv, exact),
                "fwd_library": lambda: yardstick.gather(img, grid),
                "bwd": lambda: bilinear._bwd(img, pu, pv, cot, exact),
                "bwd_plain": lambda: bilinear.bilinear_gather_reference_vjp(img, pu, pv, cot, exact),
                "bwd_library": lambda: yardstick.grid_sampler_backward(img, grid, cot),
            }
            ms = {k: _time_ms(torch, fn) for k, fn in calls.items()}
            t = {k: _device_or_wall(v) for k, v in ms.items()}
            # the thread-per-point kernel (the first port's) and the new one, in turns
            fields, record = {}, dict(t)
            for key, routes, run in (("fwd", fwd_routes, bilinear._fwd), ("bwd", bwd_routes, bilinear._bwd)):
                if len(routes) < 2:
                    continue
                new = routes[0]
                args = (img, pu, pv) + ((cot,) if key == "bwd" else ())
                in_turns = {r: (lambda r=r: run(*args, exact, route=r)) for r in routes}
                turns, turn_list = _in_turns(torch, in_turns, ("generic", new, new, "generic"))
                fields.update({f"{key}_turns_ms": json.dumps(turn_list),
                               f"{key}_generic_over_{new}": f"{turns['generic'] / turns[new]:.3f}"})
                record.update({f"{key}_generic": turns["generic"], f"{key}_in_turns": turns[new]})
            if vec4:
                merge = yardstick.modelled_merge_factor(pu, pv, h, w, exact)
                fields.update(modelled_corner_additions_per_reduction=f"{merge:.3f}")
                record.update(modelled_corner_additions_per_reduction=merge)
            for k, (dev, wall) in ms.items():
                fields[f"{k}_device_ms"] = "none" if dev is None else f"{dev:.4f}"
                fields[f"{k}_wall_ms"] = f"{wall:.4f}"
            log(
                "kernels", shapes=path, points=kind, B=b, H=h, W=w, C=c, N=n, exact=exact,
                fwd_max_abs_err=json.dumps(fwd_errs), bwd_max_abs_err=json.dumps(bwd_errs),
                library_max_abs_err=json.dumps(lib_errs), **fields,
                fwd_share_of_bound=f"{bound['fwd']['bound_ms'] / t['fwd']:.3f}",
                bwd_share_of_bound=f"{bound['bwd']['bound_ms'] / t['bwd']:.3f}",
                fwd_over_library=f"{t['fwd'] / t['fwd_library']:.3f}",
                bwd_over_library=f"{t['bwd'] / t['bwd_library']:.3f}",
            )
            if not (e_fwd <= FWD_ATOL and bwd_ok):
                raise AssertionError(f"kernel parity failed ({path} shapes, {kind} points, exact={exact})")
            if not lib_ok:
                raise AssertionError(f"library calls disagree with the plain version ({path}, {kind}, exact={exact})")
            # the kernels that the main path runs
            e_fwd, e_bwd = fwd_errs[fwd_routes[0]], max(bwd_errs[bwd_routes[0]].values())
            errs["fwd"], errs["bwd"] = max(errs["fwd"], e_fwd), max(errs["bwd"], e_bwd)
            if exact:  # the main path runs exact mode
                record.update(bounds=bound, in_bounds_points=in_bounds, fwd_max_abs_err=e_fwd,
                              bwd_max_abs_err=e_bwd)
                by_points[kind] = record
    return errs, by_points


def _gather_bounds(torch, img, u, v, exact: bool):
    """K1's and K2's bounds on this run's points, and the count of points in
    bounds. Bytes: every point's u and v are read and its output row (K1)
    or its du and dv (K2) written; the image is read at the pixels that the
    in-bounds points' corners touch, each once; K2 also reads the in-bounds
    points' cotangent rows and writes the whole of d img. Operations, per
    in-bounds point, channel and corner: 4 for K1, 6 for K2."""
    b, h, w, c = img.shape
    mask = (u >= 0) & (u < h - 1) & (v >= 0) & (v < w - 1)
    in_bounds = int(mask.sum())
    batch = torch.arange(b, device=u.device)[:, None].expand_as(u)
    key = (batch[mask] * h + u[mask].to(torch.int64)) * w + v[mask].to(torch.int64)
    corners = [key, key + 1] if exact else [key, key + 1, key + w, key + w + 1]
    touched = int(torch.unique(torch.cat(corners)).numel())
    coords = 4 * (u.numel() + v.numel())
    fwd = _bound(4 * touched * c + coords + 4 * u.numel() * c, in_bounds * c * len(corners) * 4)
    bwd = _bound(4 * touched * c + 4 * in_bounds * c + 4 * img.numel() + 2 * coords,
                 in_bounds * c * len(corners) * 6)
    return {"fwd": fwd, "bwd": bwd}, in_bounds


def _bound(n_bytes: int, n_flops: int) -> dict:
    """The least time (ms) the card could take: bytes over the memory rate
    or float32 operations over the peak rate, whichever is larger."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * n_flops / PEAK_F32_FLOPS
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": n_bytes, "flops": n_flops}


def _lift_inputs(torch):
    """Voxel grid, frustum coordinates under cameras from the yml's prior,
    their mask and a cotangent, at the DeepVoxels step's shapes."""
    from rgbd_gan_tpu_torch.core.config import Config
    from rgbd_gan_tpu_torch.geometry.camera import camera_matrices
    from rgbd_gan_tpu_torch.geometry.prior import CameraParamPrior
    from rgbd_gan_tpu_torch.models.deepvoxels import frustum_camera_coords, frustum_voxel_coords

    b, g, c, n = (LIFT_SHAPE[k] for k in "BGCN")
    gen = torch.Generator(device="cuda").manual_seed(0)
    voxel = torch.randn(b, g, g, g, c, generator=gen, device="cuda")
    thetas6 = CameraParamPrior(Config(DEEPVOXELS_SHAPENET_CAR)).sample(gen, b, "cuda")
    coords_const = torch.from_numpy(frustum_camera_coords()).cuda()
    vox, in_bounds = frustum_voxel_coords(camera_matrices(thetas6), coords_const)
    assert vox.shape == (b, 3, n)
    cot = torch.randn(b, n, c, generator=gen, device="cuda")
    return voxel, vox.contiguous(), in_bounds.contiguous(), cot


def _cells_per_run(torch, vox, in_bounds, g: int, walk: int = 32) -> float:
    """Valid cells per run of one corner base along the walks of the
    vectorised lift backward (each thread walks ``walk`` neighbouring cells
    and reduces its corner sums when the base changes): the merge factor of
    its reductions on these inputs."""
    b, _, n = vox.shape
    i0 = torch.where(in_bounds[:, None], vox, torch.zeros_like(vox)).to(torch.int64).clamp(0, g - 1)
    key = ((i0[:, 2] * g + i0[:, 1]) * g + i0[:, 0]).reshape(b, n // walk, walk)
    valid = in_bounds.reshape(b, n // walk, walk)
    pos = torch.arange(walk, device=vox.device).expand_as(key)
    last = torch.cummax(torch.where(valid, pos, torch.full_like(pos, -1)), dim=-1).values
    prev = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]], dim=-1)  # last valid cell before
    starts = valid & ((prev < 0) | (torch.gather(key, -1, prev.clamp(min=0)) != key))
    return float(valid.sum()) / float(starts.sum())


def phase_lift_kernels(torch):
    import torch.nn.functional as F

    from rgbd_gan_tpu_torch.models.deepvoxels import LIFT_WINDOW
    from rgbd_gan_tpu_torch.ops import trilinear

    voxel, vox, in_bounds, cot = _lift_inputs(torch)
    b, g, c, n = (LIFT_SHAPE[k] for k in "BGCN")
    valid = int(in_bounds.sum())
    # forward: the grid and the mask are read once, the coordinates of the
    # valid cells, and every output row is written; 8 corners x (multiply +
    # add) plus the weights per valid (cell, channel). Backward: the valid
    # cells' cotangent rows instead of the grid, and dV written once.
    fwd = _bound(4 * voxel.numel() + b * n + valid * 12 + 4 * b * n * c, valid * c * 22)
    bwd = _bound(b * n + valid * 12 + 4 * valid * c + 4 * voxel.numel(), valid * c * 20)
    bounds = {"fwd": fwd, "bwd": bwd, "fwd_win": fwd, "bwd_win": bwd}
    log("lift_bounds", fwd=json.dumps(fwd), bwd=json.dumps(bwd), valid_cells=valid, of=b * n,
        cells_per_corner_base_run=f"{_cells_per_run(torch, vox, in_bounds, g):.3f}")

    errs, times = {}, {}
    for window in (None, LIFT_WINDOW):
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            out = trilinear._fwd(voxel, vox, in_bounds, dtype, window)
            torch.cuda.synchronize()
            ref = trilinear.trilinear_lift_reference(voxel, vox, in_bounds, dtype, window)
            e_fwd = (out - ref).abs().max().item()
            rtol, atol = (LIFT_F32_RTOL, LIFT_F32_ATOL) if f32 else (LIFT_BF16_RTOL, LIFT_BF16_ATOL)
            fwd_ok = torch.allclose(out, ref, rtol=rtol, atol=atol)
            del out, ref
            dv = trilinear._bwd(voxel.shape, vox, in_bounds, cot, dtype, window)
            torch.cuda.synchronize()
            rdv = trilinear.trilinear_lift_reference_vjp(voxel.shape, vox, in_bounds, cot, dtype, window)
            e_bwd = (dv - rdv).abs().max().item()
            bwd_ok = torch.allclose(dv, rdv, rtol=LIFT_DV_RTOL, atol=LIFT_DV_ATOL)
            del dv, rdv
            calls = {
                "fwd": lambda: trilinear._fwd(voxel, vox, in_bounds, dtype, window),
                "fwd_plain": lambda: trilinear.trilinear_lift_reference(voxel, vox, in_bounds, dtype, window),
                "bwd": lambda: trilinear._bwd(voxel.shape, vox, in_bounds, cot, dtype, window),
                "bwd_plain": lambda: trilinear.trilinear_lift_reference_vjp(
                    voxel.shape, vox, in_bounds, cot, dtype, window),
            }
            ms = {k: _time_ms(torch, fn, reps=5) for k, fn in calls.items()}
            fields = {}
            for k, (dev, wall) in ms.items():
                fields[f"{k}_device_ms"] = "none" if dev is None else f"{dev:.4f}"
                fields[f"{k}_wall_ms"] = f"{wall:.4f}"
            log("lift_kernels", window=window, operands="f32" if f32 else "bf16",
                fwd_max_abs_err=f"{e_fwd:.3e}", dv_max_abs_err=f"{e_bwd:.3e}", **fields)
            if not (fwd_ok and bwd_ok):
                raise AssertionError(f"lift kernel parity failed (window={window}, dtype={dtype})")
            # the main paths run the windowed pair with bf16 operands (the
            # yml's default) and the full pair with f32 (lift_mode pallas_f32)
            if f32 == (window is None):
                suffix = "" if window is None else "_win"
                for k in ("fwd", "bwd"):
                    dev, wall = ms[k]
                    pdev, pwall = ms[k + "_plain"]
                    times[k + suffix] = dev if dev is not None else wall
                    times[k + suffix + "_plain"] = pdev if pdev is not None else pwall
                errs["fwd" + suffix], errs["bwd" + suffix] = e_fwd, e_bwd

    # the forward's two kernels on the main paths' pairs, in turns on this
    # card: the thread-per-(cell, channel) kernel (the forward before the
    # vectorised one) and the vectorised kernel
    for window, dtype in ((None, torch.float32), (LIFT_WINDOW, torch.bfloat16)):
        outs = {r: trilinear._fwd(voxel, vox, in_bounds, dtype, window, route=r) for r in ("generic", "vec4")}
        torch.cuda.synchronize()
        diffs = {"generic_max_abs_diff_to_vec4": (outs["generic"] - outs["vec4"]).abs().max().item()}
        del outs
        order = ("generic", "vec4", "vec4", "generic")
        turns = [(r, _time_ms(torch, lambda r=r: trilinear._fwd(voxel, vox, in_bounds, dtype, window, route=r),
                              reps=5)) for r in order]
        ms = {r: statistics.mean(dev if dev is not None else wall for r_, (dev, wall) in turns if r_ == r)
              for r in set(order)}
        suffix = "" if window is None else "_win"
        times["fwd" + suffix + "_generic"] = ms["generic"]
        log("lift_fwd_routes", window=window, operands="f32" if dtype == torch.float32 else "bf16",
            chosen=trilinear.fwd_route(c, voxel.data_ptr()), **{f"{r}_ms": f"{ms[r]:.4f}" for r in sorted(ms)},
            turns_ms=json.dumps([round(dev if dev is not None else wall, 4) for _, (dev, wall) in turns]),
            generic_over_vec4=f"{ms['generic'] / ms['vec4']:.3f}", **{k: f"{v:.3e}" for k, v in diffs.items()})

    # the backward's two kernels on the same pairs, in turns: the thread-per-
    # (cell, channel) kernel with scalar atomics (the backward before the
    # vectorised one) and the vectorised kernel, each against the plain version
    for window, dtype in ((None, torch.float32), (LIFT_WINDOW, torch.bfloat16)):
        dvs = {r: trilinear._bwd(voxel.shape, vox, in_bounds, cot, dtype, window, route=r)
               for r in ("generic", "vec4")}
        torch.cuda.synchronize()
        rdv = trilinear.trilinear_lift_reference_vjp(voxel.shape, vox, in_bounds, cot, dtype, window)
        diffs = {"generic_max_abs_diff_to_vec4": (dvs["generic"] - dvs["vec4"]).abs().max().item()}
        diffs.update({f"{r}_max_abs_err": (dv - rdv).abs().max().item() for r, dv in dvs.items()})
        ok = all(torch.allclose(dv, rdv, rtol=LIFT_DV_RTOL, atol=LIFT_DV_ATOL) for dv in dvs.values())
        del dvs, rdv
        order = ("generic", "vec4", "vec4", "generic")
        turns = [(r, _time_ms(torch, lambda r=r: trilinear._bwd(voxel.shape, vox, in_bounds, cot, dtype, window,
                                                                route=r), reps=5)) for r in order]
        ms = {r: statistics.mean(dev if dev is not None else wall for r_, (dev, wall) in turns if r_ == r)
              for r in set(order)}
        suffix = "" if window is None else "_win"
        times["bwd" + suffix + "_generic"] = ms["generic"]
        log("lift_bwd_routes", window=window, operands="f32" if dtype == torch.float32 else "bf16",
            chosen=trilinear.bwd_route(c, cot.data_ptr()), **{f"{r}_ms": f"{ms[r]:.4f}" for r in sorted(ms)},
            turns_ms=json.dumps([round(dev if dev is not None else wall, 4) for _, (dev, wall) in turns]),
            generic_over_vec4=f"{ms['generic'] / ms['vec4']:.3f}",
            vec4_share_of_bound=f"{bwd['bound_ms'] / ms['vec4']:.3f}", **{k: f"{v:.3e}" for k, v in diffs.items()})
        if not ok:
            raise AssertionError(f"lift backward routes disagree with the plain version (window={window})")

    # one PyTorch call for the same sample (valid cells): a yardstick, used nowhere in the port
    vol = voxel.permute(0, 4, 1, 2, 3).contiguous()
    grid = (vox.transpose(1, 2) * (2.0 / (g - 1)) - 1.0).reshape(b, 1, 1, n, 3).contiguous()

    def library():
        return F.grid_sample(vol, grid, mode="bilinear", padding_mode="border", align_corners=True)

    lib_out = library().reshape(b, c, n).transpose(1, 2) * in_bounds[..., None]
    ours = trilinear._fwd(voxel, vox, in_bounds, torch.float32, None)
    e_lib = (lib_out - ours).abs().max().item()
    del lib_out, ours
    dev, wall = _time_ms(torch, library, reps=5)
    times["library_fwd"] = dev if dev is not None else wall
    log("lift_library", call="F.grid_sample(bilinear,border,align_corners)", max_abs_diff_to_k3=f"{e_lib:.3e}",
        device_ms="none" if dev is None else f"{dev:.4f}", wall_ms=f"{wall:.4f}")
    if e_lib > GRID_SAMPLE_ATOL:
        raise AssertionError(f"F.grid_sample disagrees with K3 by {e_lib}")

    # and its backward for K4: the gradient to the volume only, from the masked cotangent
    masked_cot = (cot * in_bounds[..., None]).transpose(1, 2).reshape(b, c, 1, 1, n).contiguous()

    def library_bwd():
        return torch.ops.aten.grid_sampler_3d_backward(masked_cot, vol, grid, 0, 1, True, [True, False])[0]

    lib_dv = library_bwd().permute(0, 2, 3, 4, 1)
    ours = trilinear._bwd(voxel.shape, vox, in_bounds, cot, torch.float32, None)
    e_lib_dv = (lib_dv - ours).abs().max().item()
    lib_dv_ok = torch.allclose(lib_dv, ours, rtol=GRID_SAMPLE_DV_RTOL, atol=GRID_SAMPLE_DV_ATOL)
    del lib_dv, ours
    dev, wall = _time_ms(torch, library_bwd, reps=5)
    times["library_bwd"] = dev if dev is not None else wall
    log("lift_library_bwd", call="aten.grid_sampler_3d_backward(bilinear,border,align_corners,input grad only)",
        max_abs_diff_to_k4=f"{e_lib_dv:.3e}", device_ms="none" if dev is None else f"{dev:.4f}",
        wall_ms=f"{wall:.4f}")
    if not lib_dv_ok:
        raise AssertionError(f"grid_sampler_3d_backward disagrees with K4 by {e_lib_dv}")
    return errs, times, bounds


def phase_conv(torch):
    """K6 on its path: the benchmark tool's measuring function, with every
    launch count zeroed just before and read just after. Its times are CUDA
    event times of back-to-back calls (the tool's own), not the profiler's
    kernel sums: every call here takes 0.08 ms or more on the card, and the
    profiler's sum has undercounted a K6 call (0.51 ms where events read
    1.18 ms, a rate above the f32 peak)."""
    from rgbd_gan_tpu_torch.tools import bench_conv

    _reset_launches()
    records = bench_conv.measure(reps=CONV_REPS)
    torch.cuda.synchronize()
    launches = _read_launches()
    failed, misrouted = [], []
    for r in records:
        allowed = CONV_F32_REL * r["max_abs_y"]
        err = r["max_abs_err"] if r["dtype"] == "float32" else r["max_excess_over_one_bf16_ulp"]
        log("conv", **{k: (json.dumps(v) if isinstance(v, (list, dict)) else v) for k, v in r.items()},
            allowed=allowed)
        if not err <= allowed:
            failed.append((r["dtype"], r["shape"], err, allowed))
        # every bf16 call on the tensor cores, every f32 call on the FMA kernel
        key = "conv3x3_tc" if r["dtype"] == "bfloat16" else "conv3x3"
        if r["launches"] != {**{k: 0 for k in r["launches"]}, key: r["kernel_calls"]}:
            misrouted.append((r["dtype"], r["shape"], r["launches"]))
    calls = sum(r["kernel_calls"] for r in records)
    log("conv_path", launches=json.dumps(launches), kernel_calls=calls)
    if failed:
        raise AssertionError(f"K6 parity failed: {failed}")
    if misrouted:
        raise AssertionError(f"K6 calls on the wrong kernel: {misrouted}")
    n = launches["conv"]
    if 0 in n.values() or sum(n.values()) != calls:
        raise AssertionError(f"K6 path: {n} launches for {calls} calls")
    if any(launches["bilinear"].values()) or any(launches["trilinear"].values()):
        raise AssertionError(f"K6 path launched other kernels: {launches}")
    # the FMA kernel (bf16's route before the tensor-core kernel) against the
    # tensor-core kernel, in turns on this card; outside the path's count
    # Both are held to the bf16 check above: the FMA kernel's bf16 instance
    # still takes the calls the tensor-core kernel cannot.
    compared = bench_conv.compare_fma_and_tc(reps=CONV_REPS)
    for r in compared:
        allowed = CONV_F32_REL * r["max_abs_y"]
        log("conv_fma_vs_tc", **{k: (json.dumps(v) if isinstance(v, list) else v) for k, v in r.items()},
            allowed=allowed)
        for which in ("fma", "tc"):
            err = r[f"{which}_max_excess_over_one_bf16_ulp"]
            if not err <= allowed:
                failed.append(("bfloat16", which, r["shape"], err, allowed))
    # the FMA kernel against cuDNN in float32 (TF32 off), in turns on this card
    versus_library = bench_conv.compare_f32_with_library(reps=CONV_REPS)
    for r in versus_library:
        allowed = CONV_F32_REL * r["max_abs_y"]
        log("conv_fma_vs_cudnn", **{k: (json.dumps(v) if isinstance(v, list) else v) for k, v in r.items()},
            allowed=allowed)
        if not r["max_abs_err"] <= allowed:
            failed.append(("float32", "fma", r["shape"], r["max_abs_err"], allowed))
    if failed:
        raise AssertionError(f"K6 parity failed in the in-turn comparisons: {failed}")
    return records, n, compared, versus_library


def _small_config():
    from rgbd_gan_tpu_torch.core.config import Config

    cfg = dict(FFHQ_STYLEGAN_OCCLUSION)
    cfg.update(ch=32, batchsize=4, stage_interval="0,0,0,0,0,0,0", max_stage=7, gather_mode="pallas")
    return Config(cfg)


def phase_step_parity(torch):
    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
    from rgbd_gan_tpu_torch.models.generators import stylegan_make_hidden
    from rgbd_gan_tpu_torch.ops import bilinear
    from rgbd_gan_tpu_torch.train.trainer import Trainer

    config = _small_config()
    data = synthetic_dataset(8, 32)
    # the same draws for both devices, made on the CPU
    g = torch.Generator().manual_seed(1)
    z = torch.cat([stylegan_make_hidden(g, 2, config.ch)] * 2)
    losses = {}
    bilinear.reset_launches()
    for device in ("cpu", "cuda"):
        trainer = Trainer(config, dataset=data, seed=0, device=device)  # same weights
        thetas6 = trainer.prior.sample(torch.Generator().manual_seed(2), 4, "cpu")
        spec = trainer._spec_for(0, 6)  # 32 px, rotate and occlusion on
        x = torch.from_numpy(data[:4].transpose(0, 2, 3, 1).copy()).to(device)
        _, metrics = trainer._step(spec)(trainer.state, x, 0.0, z=z, thetas6=thetas6)
        losses[device] = {k: float(v) for k, v in metrics.items() if "loss" in k}
    # the card's step: K1 once and the vectorised K2 once; the CPU's launches none
    if bilinear.launches != BILINEAR_ONE_STEP:
        raise AssertionError(f"step parity: bilinear launches {bilinear.launches}")
    worst = 0.0
    for k, a in losses["cpu"].items():
        b = losses["cuda"][k]
        worst = max(worst, abs(a - b))
        if not (math.isfinite(b) and abs(a - b) <= STEP_ATOL + STEP_RTOL * abs(a)):
            raise AssertionError(f"step parity failed for {k}: cpu {a} vs cuda {b}")
    log("step_parity", cpu=json.dumps(losses["cpu"]), cuda=json.dumps(losses["cuda"]),
        max_abs_diff=f"{worst:.3e}", rtol=STEP_RTOL, atol=STEP_ATOL, launches=json.dumps(bilinear.launches))


def phase_deepvoxels_step_parity(torch, phase: str = "step_parity_deepvoxels", extra=None,
                                 occlusion_types=("accumulative", "deepvoxels"), per_step=BILINEAR_ONE_STEP,
                                 noisy_after_update=()):
    """One small DeepVoxels step (ch 32, batch 2) on the CPU and on the card
    from the same weights and draws, per occlusion net; ``extra`` adds yml
    options, ``per_step`` the bilinear launches the card's step must make.
    For the occlusion nets in ``noisy_after_update`` dis/loss_adv is held to
    ``DIS_AFTER_UPDATE_NOISY_ATOL``, and a second CPU step from weights moved
    by 1e-7 of their mean magnitude shows how far float32 noise alone moves
    it."""
    from rgbd_gan_tpu_torch.core.config import Config
    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
    from rgbd_gan_tpu_torch.models.deepvoxels import deepvoxels_make_hidden
    from rgbd_gan_tpu_torch.ops import bilinear, trilinear
    from rgbd_gan_tpu_torch.train.trainer import Trainer

    data = synthetic_dataset(4, 64)
    g = torch.Generator().manual_seed(3)
    ch, batch = 32, 2
    names = ("z", "z2", "z_d", "z2_d") + (("z3", "z4", "z3_d", "z4_d") if (extra or {}).get("background_generator")
                                          else ())
    draws = {k: deepvoxels_make_hidden(g, batch, ch) for k in names}
    draws["z"][1], draws["z2"][1] = draws["z"][0], draws["z2"][0]  # the paired latents
    for occlusion_type in occlusion_types:
        # float32 operands on both devices: the CPU runs the plain lift (full),
        # the card the windowed kernels, equal under the span invariant
        config = Config(dict(DEEPVOXELS_SHAPENET_CAR, ch=ch, batchsize=batch, occlusion_type=occlusion_type,
                             lift_mode="pallas_win_f32", **(extra or {})))
        losses, modes, params = {}, {}, {}
        trilinear.reset_launches()
        bilinear.reset_launches()
        for device in ("cpu", "cuda"):
            trainer = Trainer(config, dataset=data, seed=0, device=device)  # same weights
            thetas6 = trainer.prior.sample(torch.Generator().manual_seed(4), batch, "cpu")
            spec = trainer._spec_for(0, 8)
            x = torch.from_numpy(data[:batch].transpose(0, 2, 3, 1).copy()).to(device)
            _, metrics = trainer._step(spec)(trainer.state, x, 0.0, thetas6=thetas6, **draws)
            losses[device] = {k: float(v) for k, v in metrics.items() if "loss" in k}
            modes[device] = trainer.state.gen.lift_mode
            params[device] = torch.cat([p.detach().flatten().cpu() for p in trainer.state.gen.parameters()])
        apart = float(((params["cpu"] - params["cuda"]).abs() > 1e-4).float().mean())
        worst = 0.0
        noisy = occlusion_type in noisy_after_update
        after_atol = DIS_AFTER_UPDATE_NOISY_ATOL if noisy else DIS_AFTER_UPDATE_ATOL
        log_fields = dict(
            occlusion_type=occlusion_type, options=json.dumps(extra or {}), lift_modes=json.dumps(modes),
            cpu=json.dumps(losses["cpu"]),
            cuda=json.dumps(losses["cuda"]), launches=json.dumps(trilinear.launches),
            bilinear_launches=json.dumps(bilinear.launches),
            share_of_generator_elements_apart=f"{apart:.5f}",
        )
        if noisy:
            trainer = Trainer(config, dataset=data, seed=0, device="cpu")
            moved = torch.Generator().manual_seed(11)
            with torch.no_grad():
                for p in trainer.state.gen.parameters():
                    p.add_(1e-7 * p.abs().mean() * torch.randn(p.shape, generator=moved))
            x = torch.from_numpy(data[:batch].transpose(0, 2, 3, 1).copy())
            _, metrics = trainer._step(trainer._spec_for(0, 8))(trainer.state, x, 0.0, thetas6=thetas6, **draws)
            log_fields["cpu_dis_after_update_moved_by_1e-7_weights"] = (
                f"{abs(float(metrics['dis/loss_adv']) - losses['cpu']['dis/loss_adv']):.3e}")
        for k, a in losses["cpu"].items():
            b = losses["cuda"][k]
            after_update = k == "dis/loss_adv"
            if not after_update:
                worst = max(worst, abs(a - b))
            tol = after_atol if after_update else STEP_ATOL + STEP_RTOL * abs(a)
            if not (math.isfinite(b) and abs(a - b) <= tol):
                log(phase, **log_fields)
                raise AssertionError(f"{phase} failed for {k}: cpu {a} vs cuda {b}")
        log(phase, **log_fields, max_abs_diff_before_update=f"{worst:.3e}", rtol=STEP_RTOL,
            atol=STEP_ATOL, dis_after_update_abs_diff=f"{abs(losses['cpu']['dis/loss_adv'] - losses['cuda']['dis/loss_adv']):.3e}",
            dis_after_update_atol=after_atol)
        if apart > MAX_SHARE_APART:
            raise AssertionError(f"{phase}: {apart:.4f} of the generator's elements ended apart")
        if trilinear.launches != {**LIFT_NONE, "fwd_win_vec4": 2, "bwd_win_vec4": 1}:
            raise AssertionError(f"{phase}: lift launches {trilinear.launches}")
        if bilinear.launches != per_step:
            raise AssertionError(f"{phase}: bilinear launches {bilinear.launches}, not {per_step}")


def _watch_dtypes(sites: dict):
    """Forward pre-hooks on the trainer's modules named in ``sites`` (``gen.``
    or ``dis.`` and the module's path, or ``lift_frustum`` for the voxel grid
    the lift gets) recording the dtypes of their first input; returns the
    record and a function that takes the hooks out."""
    from rgbd_gan_tpu_torch.models import deepvoxels
    from rgbd_gan_tpu_torch.train import trainer as trainer_module

    seen = {name: set() for name in sites}
    setup_generator, setup_discriminator = trainer_module.setup_generator, trainer_module.setup_discriminator
    lift_frustum = deepvoxels.lift_frustum

    def hooked(model, prefix):
        for name in sites:
            if name.startswith(prefix):
                model.get_submodule(name[len(prefix):]).register_forward_pre_hook(
                    lambda module, args, name=name: seen[name].add(args[0].dtype))
        return model

    def watched_lift(voxel, *args, **kwargs):
        seen["lift_frustum"].add(voxel.dtype)
        return lift_frustum(voxel, *args, **kwargs)

    def hooked_generator(*args, **kwargs):
        gen, make_hidden = setup_generator(*args, **kwargs)
        return hooked(gen, "gen."), make_hidden

    trainer_module.setup_generator = hooked_generator
    trainer_module.setup_discriminator = lambda *args, **kwargs: hooked(setup_discriminator(*args, **kwargs), "dis.")
    if "lift_frustum" in sites:
        deepvoxels.lift_frustum = watched_lift

    def undo():
        trainer_module.setup_generator, trainer_module.setup_discriminator = setup_generator, setup_discriminator
        deepvoxels.lift_frustum = lift_frustum

    return seen, undo


def _drive(torch, has_yaml: bool, phase: str, values: dict, image_px: int, name: str, watch=None, after=None,
           bilinear_per_step=BILINEAR_ONE_STEP, iterations=None):
    """Run ``values`` through the CLI's run function on 64 synthetic images
    with every kernel's launch count zeroed just before and read just after;
    returns the launch counts of the bilinear and the trilinear kernels
    (each bilinear kernel must have launched ``bilinear_per_step`` times an
    iteration; K6, wired into no model, must not launch). ``watch`` maps
    sites (see :func:`_watch_dtypes`) to the one dtype each must see.
    ``after(config)`` runs once the run passed, before its directory is
    removed. The run must end after ``iterations`` iterations (by default
    the yml's)."""
    from rgbd_gan_tpu_torch.cli import train as cli
    from rgbd_gan_tpu_torch.core.config import Config
    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset

    seen, undo = _watch_dtypes(watch or {})
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        data_dir = os.path.join(work, "data")
        os.makedirs(data_dir)
        np.save(os.path.join(data_dir, "images.npy"), synthetic_dataset(64, image_px))
        values = dict(values, dataset_path=data_dir, image_path="unused/*.png", out=os.path.join(work, "out"))
        iterations, batch = iterations or values["iteration"], values["batchsize"]
        stamps = []

        def on_row(row):
            torch.cuda.synchronize()
            stamps.append((row["iteration"], time.perf_counter(), row))

        if has_yaml:
            import yaml

            path = os.path.join(work, f"{name}_smoke.yml")
            with open(path, "w") as f:
                yaml.safe_dump(values, f)
            config = cli.load_config(path)
            route = "yml"
        else:
            config = Config(values)
            route = "config-in-code"
        config.gpu = 0
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        trainer = cli.run(config, on_row=on_row)
        torch.cuda.synchronize()
        counts = _read_launches()
        launches, lift_launches = counts["bilinear"], counts["trilinear"]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        rows = [r for _, _, r in stamps]
        step_ms = [1e3 * (stamps[i][1] - stamps[i - 1][1]) for i in range(1, len(stamps))]
        median_ms = statistics.median(step_ms)
        finite = all(
            math.isfinite(r[k]) for r in rows for k in r if k.startswith(("gen/", "dis/"))
        )
        out_files = sorted(os.listdir(os.path.join(work, "out")))
        fields = dict(
            config=route, iteration=trainer.state.iteration, launches=json.dumps(launches),
            **{f"median_ms_per_step_2_{iterations}": f"{median_ms:.3f}"},
            img_per_s=f"{batch * 1e3 / median_ms:.2f}",
            step_ms=json.dumps([round(t, 3) for t in step_ms]), peak_mem_gib=f"{peak_gib:.3f}",
            last=json.dumps(rows[-1]), files=json.dumps(out_files),
        )
        if values["generator_architecture"] == "deepvoxels":
            fields.update(lift_launches=json.dumps(lift_launches), lift_mode=trainer.state.gen.lift_mode)
        if values.get("r1_interval", 1) > 1:
            # step_ms[j] is row j + 1's step: the penalty's steps apart from the plain ones
            r1 = [t for t, row in zip(step_ms, rows[1:]) if row["dis/loss_gp"] > 0]
            plain = [t for t, row in zip(step_ms, rows[1:]) if row["dis/loss_gp"] == 0]
            fields.update(r1_step_ms=json.dumps([round(t, 3) for t in r1]),
                          plain_step_median_ms=f"{statistics.median(plain):.3f}", plain_steps=len(plain))
        if watch:
            fields.update(dtypes=json.dumps({k: sorted(str(d) for d in v) for k, v in seen.items()}))
        log(phase, **fields)
        if trainer.state.iteration != iterations or not finite or len(rows) != iterations:
            raise AssertionError(f"{phase}: expected {iterations} iterations with finite losses")
        # by default K1 and the vectorised K2 once per iteration, the thread-per-point K2 never
        if launches != {k: n * iterations for k, n in bilinear_per_step.items()}:
            raise AssertionError(f"{phase}: bilinear kernel launches {launches}, not {iterations} x {bilinear_per_step}")
        if any(counts["conv"].values()):
            raise AssertionError(f"{phase}: K6 is wired into no model, yet launched {counts['conv']}")
        if "Generator_latest.npz" not in out_files or "Discriminator_latest.npz" not in out_files:
            raise AssertionError(f"{phase}: snapshot missing")
        wrong = {k: v for k, v in seen.items() if v != {watch[k]}}
        if wrong:
            raise AssertionError(f"{phase}: inputs not in the expected dtype: {wrong} (expected {watch})")
        if after is not None:
            after(config)
        return launches, lift_launches, out_files
    finally:
        undo()
        shutil.rmtree(work, ignore_errors=True)


def phase_main_path(torch, has_yaml: bool):
    launches, lift_launches, _ = _drive(
        torch, has_yaml, "main_path", FFHQ_STYLEGAN_OCCLUSION, 128, "ffhq_stylegan_occlusion")
    if any(lift_launches.values()):
        raise AssertionError(f"main path: the StyleGAN step launched the lift {lift_launches}")
    return launches


def phase_step_parity_bf16(torch):
    """Phase 5's step with ``mixed16`` and ``r1_interval: 2``, two steps."""
    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
    from rgbd_gan_tpu_torch.models.generators import stylegan_make_hidden
    from rgbd_gan_tpu_torch.ops import bilinear
    from rgbd_gan_tpu_torch.train.trainer import Trainer

    data = synthetic_dataset(8, 32)
    g = torch.Generator().manual_seed(1)
    zs = [torch.cat([stylegan_make_hidden(g, 2, 32)] * 2) for _ in range(2)]
    losses, launches = {}, {}
    for run, device, mixed16 in (("cpu", "cpu", True), ("cuda", "cuda", True), ("cuda_f32", "cuda", False)):
        config = _small_config()
        config.mixed16, config.r1_interval = mixed16, 2
        trainer = Trainer(config, dataset=data, seed=0, device=device)  # same weights
        bilinear.reset_launches()
        losses[run] = []
        for it in range(2):
            thetas6 = trainer.prior.sample(torch.Generator().manual_seed(2 + it), 4, "cpu")
            spec = trainer._spec_for(it, 6)  # 32 px, rotate and occlusion on
            x = torch.from_numpy(data[4 * it:4 * it + 4].transpose(0, 2, 3, 1).copy()).to(device)
            _, metrics = trainer._step(spec)(trainer.state, x, 0.0, z=zs[it], thetas6=thetas6)
            losses[run].append({k: float(v) for k, v in metrics.items() if "loss" in k})
        launches[run] = dict(bilinear.launches)

    def worst(a, b):
        return max(abs(x[k] - y[k]) for x, y in zip(losses[a], losses[b]) for k in x)

    reading, bf16_vs_f32 = worst("cpu", "cuda"), worst("cuda", "cuda_f32")
    log("step_parity_bf16", cpu=json.dumps(losses["cpu"]), cuda=json.dumps(losses["cuda"]),
        cuda_f32=json.dumps(losses["cuda_f32"]), max_abs_diff=f"{reading:.3e}", atol=STEP_BF16_ATOL,
        card_bf16_vs_card_f32_max_abs_diff=f"{bf16_vs_f32:.3e}", launches=json.dumps(launches["cuda"]))
    if launches["cuda"] != {k: 2 * n for k, n in BILINEAR_ONE_STEP.items()} or any(launches["cpu"].values()):
        raise AssertionError(f"bf16 step parity: bilinear launches {launches}")
    for run, (first, second) in losses.items():
        if not (first["dis/loss_gp"] > 0 and second["dis/loss_gp"] == 0):
            raise AssertionError(f"bf16 step parity: {run} took R1 on the wrong step: {losses[run]}")
        if not all(math.isfinite(v) for step in (first, second) for v in step.values()):
            raise AssertionError(f"bf16 step parity: {run} has a loss that is not finite")
    if reading > STEP_BF16_ATOL:
        raise AssertionError(f"bf16 step parity: CPU and card {reading:.3e} apart, above {STEP_BF16_ATOL}")


def phase_main_path_bf16(torch, has_yaml: bool):
    """The StyleGAN main path with ``mixed16``: R1 every step, then lazy R1."""
    bf16, f32 = torch.bfloat16, torch.float32
    # stage 10: blocks 0-5 and the toRGBD head out5; D's blocks 5-0
    sites = {"gen.gen.block5.c1": bf16, "gen.gen.out5": f32, "dis.block1.c0": bf16}
    values = dict(FFHQ_STYLEGAN_OCCLUSION, mixed16=True)
    every, lift, _ = _drive(torch, has_yaml, "main_path_bf16", values, 128, "ffhq_stylegan_occlusion_bf16", sites)
    lazy, lazy_lift, _ = _drive(torch, has_yaml, "main_path_bf16_lazy_r1", dict(values, r1_interval=16, iteration=18),
                                128, "ffhq_stylegan_occlusion_bf16_lazy_r1", sites)
    if any(lift.values()) or any(lazy_lift.values()):
        raise AssertionError(f"bf16 main path: the StyleGAN step launched the lift {lift} {lazy_lift}")
    return every, lazy


def phase_deepvoxels_bf16(torch, has_yaml: bool):
    """The DeepVoxels main path with ``mixed16``."""
    bf16, f32 = torch.bfloat16, torch.float32
    sites = {"gen.voxel_gen.block1.c0": bf16, "gen.style_generator.c4": bf16, "dis.block1.c0": bf16,
             "lift_frustum": f32}
    bil, lift, _ = _drive(torch, has_yaml, "main_path_deepvoxels_bf16", dict(DEEPVOXELS_SHAPENET_CAR, mixed16=True), 64,
                          "deepvoxels_shapenet_car_bf16", sites)
    if lift != {**LIFT_NONE, "fwd_win_vec4": 10, "bwd_win_vec4": 5}:
        raise AssertionError(f"deepvoxels bf16 path: lift launches {lift}")
    return bil, lift


def _eval_preview_deepvoxels(torch, config, counts: dict) -> None:
    """``cli/evaluate.py --preview`` on a DeepVoxels snapshot: the 8x8 grid in
    4 chunks of 16, each one eval-mode generator forward through the
    windowed lift's forward (K5) and no other kernel of the port."""
    from rgbd_gan_tpu_torch.cli import evaluate

    _reset_launches()
    t0 = time.perf_counter()
    results = evaluate.run(config, preview=True)
    torch.cuda.synchronize()
    counts.update(_read_launches())
    grid = _read_grid(results["preview"])
    log("eval_preview_deepvoxels", seconds=f"{time.perf_counter() - t0:.2f}", grid=json.dumps(list(grid.shape)),
        launches=json.dumps(counts))
    if counts["trilinear"] != {**LIFT_NONE, "fwd_win_vec4": 4} or any(counts["bilinear"].values()) or any(
            counts["conv"].values()):
        raise AssertionError(f"deepvoxels eval preview: launches {counts}, not 4 forwards of the windowed lift")
    if grid.shape != _grid_shape(64):
        raise AssertionError(f"deepvoxels eval preview: grid of shape {grid.shape}")


def _grid_shape(image_px: int) -> tuple:
    """The 8x8 preview grid's shape: RGB and depth rows of images at least 64 px."""
    side = max(image_px, 64)
    return (16 * side, 8 * side, 3)


def _read_grid(path: str) -> np.ndarray:
    """A preview grid as an array, from its png (or, without PIL, its npy)."""
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image

    return np.asarray(Image.open(path))


def phase_deepvoxels_paths(torch, has_yaml: bool):
    """The DeepVoxels main path (the yml's default lift: bf16, windowed), with
    the evaluation CLI's preview of its snapshot, and 2 iterations with
    ``lift_mode: pallas_f32`` (the full kernels)."""
    eval_counts = {}
    bil_win, win, files = _drive(
        torch, has_yaml, "main_path_deepvoxels", DEEPVOXELS_SHAPENET_CAR, 64, "deepvoxels_shapenet_car",
        after=lambda config: _eval_preview_deepvoxels(torch, config, eval_counts))
    # per iteration: the G phase lifts forward and backward, the D phase
    # forward only; at C = 32 every launch on the vectorised kernels
    if win != {**LIFT_NONE, "fwd_win_vec4": 10, "bwd_win_vec4": 5}:
        raise AssertionError(f"deepvoxels main path: lift launches {win}")
    if "Map_latest.npz" not in files:
        raise AssertionError("deepvoxels main path: Map_latest.npz missing")
    bil_full, full, _ = _drive(
        torch, has_yaml, "main_path_deepvoxels_f32", dict(DEEPVOXELS_SHAPENET_CAR, lift_mode="pallas_f32", iteration=2),
        64, "deepvoxels_shapenet_car_f32")
    if full != {**LIFT_NONE, "fwd_vec4": 4, "bwd_vec4": 2}:
        raise AssertionError(f"deepvoxels pallas_f32 path: lift launches {full}")
    lift = {"deepvoxels": win, "deepvoxels_f32": full, "deepvoxels_eval_preview": eval_counts["trilinear"]}
    return lift, bil_win, bil_full


def _dcgan_small_config(mixed16: bool):
    from rgbd_gan_tpu_torch.core.config import Config

    return Config(dict(DCGAN_SHAPENET_CAR, ch=32, batchsize=4, stage_interval="0,0,0,0,0,0,0", max_stage=7,
                       gather_mode="pallas", mixed16=mixed16))


def phase_dcgan_step_parity(torch):
    """Phase 5's twin for DCGAN: one step (32 px, rotate and occlusion on, R1)
    on the CPU and on the card from the same weights and draws, in float32
    (phase 5's tolerance) and in bf16 (phase 10's); beside it the distance
    between the card's bf16 and float32 steps."""
    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
    from rgbd_gan_tpu_torch.models.generators import dcgan_make_hidden
    from rgbd_gan_tpu_torch.ops import bilinear
    from rgbd_gan_tpu_torch.train.trainer import Trainer

    data = synthetic_dataset(8, 32)
    z = torch.cat([dcgan_make_hidden(torch.Generator().manual_seed(5), 2, 32)] * 2)
    losses, launches = {}, {}
    for run, device, mixed16 in (("cpu", "cpu", False), ("cuda", "cuda", False), ("cpu_bf16", "cpu", True),
                                 ("cuda_bf16", "cuda", True)):
        trainer = Trainer(_dcgan_small_config(mixed16), dataset=data, seed=0, device=device)  # same weights
        thetas6 = trainer.prior.sample(torch.Generator().manual_seed(6), 4, "cpu")
        spec = trainer._spec_for(0, 6)
        if spec.architecture != "dcgan":
            raise AssertionError(f"dcgan step parity: the step was built for {spec.architecture}")
        x = torch.from_numpy(data[:4].transpose(0, 2, 3, 1).copy()).to(device)
        bilinear.reset_launches()
        _, metrics = trainer._step(spec)(trainer.state, x, 0.0, z=z, thetas6=thetas6)
        losses[run] = {k: float(v) for k, v in metrics.items() if "loss" in k}
        launches[run] = dict(bilinear.launches)

    def worst(a, b):
        return max(abs(losses[a][k] - losses[b][k]) for k in losses[a])

    f32, bf16 = worst("cpu", "cuda"), worst("cpu_bf16", "cuda_bf16")
    log("step_parity_dcgan", **{run: json.dumps(v) for run, v in losses.items()}, max_abs_diff_f32=f"{f32:.3e}",
        rtol=STEP_RTOL, atol=STEP_ATOL, max_abs_diff_bf16=f"{bf16:.3e}", atol_bf16=STEP_BF16_ATOL,
        card_bf16_vs_card_f32_max_abs_diff=f"{worst('cuda_bf16', 'cuda'):.3e}", launches=json.dumps(launches))
    for run in ("cuda", "cuda_bf16"):
        if launches[run] != BILINEAR_ONE_STEP or any(launches[run.replace("cuda", "cpu")].values()):
            raise AssertionError(f"dcgan step parity: bilinear launches {launches}")
    for k, a in losses["cpu"].items():
        b = losses["cuda"][k]
        if not (math.isfinite(b) and abs(a - b) <= STEP_ATOL + STEP_RTOL * abs(a)):
            raise AssertionError(f"dcgan step parity failed for {k}: cpu {a} vs cuda {b}")
    if not (all(math.isfinite(v) for v in losses["cuda_bf16"].values()) and bf16 <= STEP_BF16_ATOL):
        raise AssertionError(f"dcgan bf16 step parity: CPU and card {bf16:.3e} apart, above {STEP_BF16_ATOL}")


def _evaluate_dcgan(torch, config, counts: dict) -> None:
    """``cli/evaluate.py --preview --fid --inception`` on a DCGAN snapshot
    with a random Inception-v3; then the Inception forward alone."""
    import warnings

    from rgbd_gan_tpu_torch.cli import evaluate
    from rgbd_gan_tpu_torch.eval.inception import INPUT_SIZE, load_params

    _reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-weights warning and sqrtm's on a rank-deficient product
        results = evaluate.run(config, preview=True, fid=True, inception=True, n_images=EVAL_IMAGES,
                               batchsize=EVAL_BATCH)
        model = load_params(None, "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts.update(_read_launches())
    grid = _read_grid(results["preview"])
    x = torch.rand(EVAL_BATCH, INPUT_SIZE, INPUT_SIZE, 3, generator=torch.Generator(device="cuda").manual_seed(7),
                   device="cuda") * 255
    with torch.no_grad():
        device_ms, wall_ms = _time_ms(torch, lambda: model(x, get_feature=True), reps=5)
    fid, (is_mean, is_std) = results["fid"], results["inception_score"]
    log("eval_dcgan", seconds=f"{seconds:.2f}", fid=fid, inception_score=is_mean, inception_score_std=is_std,
        n_images=EVAL_IMAGES, grid=json.dumps(list(grid.shape)), launches=json.dumps(counts),
        inception_ms_per_batch_of_100_at_299=f"{device_ms if device_ms is not None else wall_ms:.3f}",
        inception_wall_ms=f"{wall_ms:.3f}")
    if not (math.isfinite(fid) and fid >= 0.0 and is_mean >= 1.0 - 1e-6):
        raise AssertionError(f"dcgan eval: FID {fid}, IS {is_mean}")
    if grid.shape != _grid_shape(128):
        raise AssertionError(f"dcgan eval: preview grid of shape {grid.shape}")
    if any(v for kind in counts.values() for v in kind.values()):
        raise AssertionError(f"dcgan eval: launched the port's kernels {counts}")


def phase_dcgan_main_path(torch, has_yaml: bool):
    """The DCGAN main path in float32 (then the evaluation CLI on its
    snapshot) and in bf16."""
    bf16, f32 = torch.bfloat16, torch.float32
    eval_counts = {}
    paths = {}
    paths["dcgan"], lift, _ = _drive(torch, has_yaml, "main_path_dcgan", DCGAN_SHAPENET_CAR, 128,
                                     "dcgan_shapenet_car", after=lambda c: _evaluate_dcgan(torch, c, eval_counts))
    # stage 10: blocks 0-4 and the toRGBD head out4; D's blocks 5-0
    sites = {"gen.block4.c1": bf16, "gen.out4": f32, "dis.block1.c0": bf16}
    paths["dcgan_bf16"], lift_bf16, _ = _drive(torch, has_yaml, "main_path_dcgan_bf16",
                                               dict(DCGAN_SHAPENET_CAR, mixed16=True), 128, "dcgan_shapenet_car_bf16",
                                               sites)
    if any(lift.values()) or any(lift_bf16.values()):
        raise AssertionError(f"dcgan main path: the DCGAN step launched the lift {lift} {lift_bf16}")
    return paths


def phase_step_window_previews(torch, has_yaml: bool):
    """``structured_spheres_dcgan.yml``'s ``step_window: 10`` as plain steps,
    with the previews of the live and the smoothed generator."""

    def previews(config):
        out = config.out
        found = {}
        for subdir in ("preview", "preview_smoothed"):
            png, npy = os.path.join(out, subdir, "image_latest.png"), os.path.join(out, f"{subdir}_latest.npy")
            path = png if os.path.exists(png) else npy
            if not os.path.exists(path):
                raise AssertionError(f"step_window: no {subdir} grid in {sorted(os.listdir(out))}")
            found[subdir] = list(_read_grid(path).shape)
        log("step_window_previews", grids=json.dumps(found))
        if any(tuple(shape) != _grid_shape(32) for shape in found.values()):
            raise AssertionError(f"step_window: preview grids of shapes {found}")

    launches, lift, _ = _drive(torch, has_yaml, "step_window_dcgan", STRUCTURED_SPHERES_DCGAN, 32,
                               "structured_spheres_dcgan", after=previews)
    if any(lift.values()):
        raise AssertionError(f"step_window: the DCGAN step launched the lift {lift}")
    return launches


def _stylegan_step_parity(torch, phase: str, extra: dict, per_step: dict) -> None:
    """Phase 5's step with ``extra`` yml options: one step on the CPU and on
    the card from the same weights and draws (the occupancy loss's jitter
    too), losses held to phase 5's tolerance; with SN, the power-iteration
    vectors after the step too."""
    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
    from rgbd_gan_tpu_torch.models.generators import stylegan_make_hidden
    from rgbd_gan_tpu_torch.ops import bilinear
    from rgbd_gan_tpu_torch.train.trainer import Trainer

    data = synthetic_dataset(8, 32)
    g = torch.Generator().manual_seed(7)
    draws = {"z": torch.cat([stylegan_make_hidden(g, 2, 32)] * 2)}
    if extra.get("use_occupancy_net_loss"):
        draws["occupancy_eps"] = 0.05 * torch.randn(4, 1, 32 * 32, generator=g)
    losses, launches, sn = {}, {}, {}
    for device in ("cpu", "cuda"):
        config = _small_config()
        for k, v in extra.items():
            setattr(config, k, v)
        trainer = Trainer(config, dataset=data, seed=0, device=device)  # same weights
        thetas6 = trainer.prior.sample(torch.Generator().manual_seed(8), 4, "cpu")
        spec = trainer._spec_for(0, 6)  # 32 px: D's feature tap is the 32x32 input of block 3
        x = torch.from_numpy(data[:4].transpose(0, 2, 3, 1).copy()).to(device)
        bilinear.reset_launches()
        _, metrics = trainer._step(spec)(trainer.state, x, 0.0, thetas6=thetas6, **draws)
        losses[device] = {k: float(v) for k, v in metrics.items() if "loss" in k}
        launches[device] = dict(bilinear.launches)
        sn[device] = {k: v.cpu() for k, v in trainer.state.dis.state_dict().items() if k.endswith(".u")}
    worst = max(abs(losses["cpu"][k] - losses["cuda"][k]) for k in losses["cpu"])
    u_apart = max([float((sn["cpu"][k] - sn["cuda"][k]).abs().max()) for k in sn["cpu"]], default=0.0)
    log(phase, options=json.dumps(extra), cpu=json.dumps(losses["cpu"]), cuda=json.dumps(losses["cuda"]),
        max_abs_diff=f"{worst:.3e}", rtol=STEP_RTOL, atol=STEP_ATOL, sn_vectors=len(sn["cpu"]),
        sn_max_abs_diff=f"{u_apart:.3e}", launches=json.dumps(launches["cuda"]))
    if launches["cuda"] != per_step or any(launches["cpu"].values()):
        raise AssertionError(f"{phase}: bilinear launches {launches}, not {per_step}")
    for k, a in losses["cpu"].items():
        b = losses["cuda"][k]
        if not (math.isfinite(b) and abs(a - b) <= STEP_ATOL + STEP_RTOL * abs(a)):
            raise AssertionError(f"{phase} failed for {k}: cpu {a} vs cuda {b}")
    if bool(extra.get("sn")) != bool(sn["cpu"]) or u_apart > SN_U_ATOL:
        raise AssertionError(f"{phase}: SN vectors {len(sn['cpu'])}, {u_apart:.3e} apart")


def phase_family_step_parity(torch):
    """Phase 16: one small step of each new path on the CPU and on the card:
    DeepVoxels with the background generator (both occlusion nets), with
    RenderNet and with SN; StyleGAN with SN, rotate-feature, the occupancy
    loss and rotate_conv_input, and with rotate-feature and R1 (the feature-
    gradient penalty)."""
    phase_deepvoxels_step_parity(torch, "step_parity_deepvoxels_background", dict(background_generator=True),
                                 per_step=BILINEAR_BACKGROUND_STEP, noisy_after_update=("deepvoxels",))
    phase_deepvoxels_step_parity(torch, "step_parity_deepvoxels_rendernet", dict(rendernet_projection=True),
                                 occlusion_types=("accumulative",))
    phase_deepvoxels_step_parity(torch, "step_parity_deepvoxels_sn", dict(sn=True), occlusion_types=("accumulative",))
    _stylegan_step_parity(torch, "step_parity_sn_rotate_feature",
                          dict(sn=True, rotate_feature=True, use_occupancy_net_loss=True, rotate_conv_input=True),
                          BILINEAR_ROTATE_FEATURE_STEP)
    _stylegan_step_parity(torch, "step_parity_rotate_feature_r1", dict(rotate_feature=True),
                          BILINEAR_ROTATE_FEATURE_STEP)


def _watch_feature_gathers():
    """Wraps K1's wrapper so that every gather at C != 4 (the feature
    3D-consistency loss's) keeps its image's height and width and its u and
    v, by reference: no work on the card and no synchronisation inside the
    timed run. Returns that list and the function that unwraps it."""
    from rgbd_gan_tpu_torch.ops import bilinear

    fwd, gathers = bilinear._fwd, []

    def watched(img, u, v, exact, route=None):
        if img.shape[3] != 4:
            gathers.append((img.shape[1], img.shape[2], u, v))
        return fwd(img, u, v, exact, route)

    bilinear._fwd = watched

    def undo():
        bilinear._fwd = fwd

    return gathers, undo


def _in_bounds(gathers) -> tuple:
    """The in-bounds points of the gathers that :func:`_watch_feature_gathers`
    kept, and their count of points, counted once the run is over."""
    inside = sum(int(((u >= 0) & (u < h - 1) & (v >= 0) & (v < w - 1)).sum()) for h, w, u, v in gathers)
    return inside, sum(u.numel() for _, _, u, _ in gathers)


def phase_family_paths(torch, has_yaml: bool):
    """Phase 17: the full-width paths of this slice through the CLI's run
    function, with their launch counts asserted (per iteration: the
    background run K1 and the vectorised K2 twice; the SN/rotate-feature run
    the vectorised K1 and K2 once and the lanes K1 and K2 twice, with the
    in-bounds share of those feature gathers; the lift, on the DeepVoxels
    runs, twice forward and once backward)."""
    paths, lift = {}, {}
    paths["deepvoxels_background"], lift["deepvoxels_background"], _ = _drive(
        torch, has_yaml, "main_path_deepvoxels_background", DEEPVOXELS_BACKGROUND, 64,
        "deepvoxels_shapenet_car_background", bilinear_per_step=BILINEAR_BACKGROUND_STEP)
    paths["deepvoxels_rendernet"], lift["deepvoxels_rendernet"], _ = _drive(
        torch, has_yaml, "main_path_deepvoxels_rendernet", DEEPVOXELS_RENDERNET, 64,
        "deepvoxels_shapenet_car_rendernet")
    for name, n in (("deepvoxels_background", 5), ("deepvoxels_rendernet", 3)):
        if lift[name] != {**LIFT_NONE, "fwd_win_vec4": 2 * n, "bwd_win_vec4": n}:
            raise AssertionError(f"{name}: lift launches {lift[name]}")
    gathers, undo = _watch_feature_gathers()
    try:
        paths["stylegan_sn_rotate_feature"], lift_sn, files = _drive(
            torch, has_yaml, "main_path_sn_rotate_feature", FFHQ_SN_ROTATE_FEATURE, 128,
            "ffhq_stylegan_occlusion_sn_rotate_feature", bilinear_per_step=BILINEAR_ROTATE_FEATURE_STEP)
    finally:
        undo()
    inside, points = _in_bounds(gathers)
    log("main_path_sn_rotate_feature_gathers", gathers=len(gathers), in_bounds_points=inside, of=points,
        in_bounds_share=f"{inside / points:.4f}")
    if any(lift_sn.values()):
        raise AssertionError(f"sn/rotate-feature path: the StyleGAN step launched the lift {lift_sn}")
    return paths, lift


def _rgb_small_config(extra: dict, dcgan: bool = False):
    config = _dcgan_small_config(False) if dcgan else _small_config()
    config.rgb = True
    for k, v in extra.items():
        setattr(config, k, v)
    return config


def _hold(phase: str, losses: dict, atol: float) -> float:
    """The largest CPU-vs-card distance over the losses of each step; fails
    past ``atol + STEP_RTOL * |cpu|`` or on a loss that is not finite."""
    worst = 0.0
    for cpu, cuda in zip(losses["cpu"], losses["cuda"]):
        for k, a in cpu.items():
            b = cuda[k]
            worst = max(worst, abs(a - b))
            if not (math.isfinite(b) and abs(a - b) <= atol + STEP_RTOL * abs(a)):
                raise AssertionError(f"{phase} failed for {k}: cpu {a} vs cuda {b}")
    return worst


def _no_kernel_launched(phase: str) -> dict:
    counts = _read_launches()
    if any(v for kind in counts.values() for v in kind.values()):
        raise AssertionError(f"{phase}: launched the port's kernels {counts}; the RGB paths gather nothing")
    return counts


def phase_rgb_step_parity(torch):
    """Phase 18: the RGB step (StyleGAN with R1; DCGAN with lazy R1 over two
    steps; StyleGAN in bf16), the legacy step with mixing forced on, and the
    forwards of the encoder, BigBiGAN's and the disentangled discriminator,
    each on the CPU and on the card from the same weights and inputs. No
    kernel of the port may launch."""
    import copy

    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
    from rgbd_gan_tpu_torch.models.discriminator import DisentangledDiscriminator
    from rgbd_gan_tpu_torch.models.extras import BigBiGANDiscriminator, Encoder
    from rgbd_gan_tpu_torch.models.generators import dcgan_make_hidden, stylegan_make_hidden
    from rgbd_gan_tpu_torch.train.legacy import make_legacy_train_step
    from rgbd_gan_tpu_torch.train.steps import StepSpec
    from rgbd_gan_tpu_torch.train.trainer import Trainer

    data = synthetic_dataset(8, 32)
    g = torch.Generator().manual_seed(9)
    runs = {
        "rgb_stylegan_r1": (_rgb_small_config({}), [torch.cat([stylegan_make_hidden(g, 2, 32)] * 2)], STEP_ATOL),
        "rgb_dcgan_lazy_r1": (_rgb_small_config({"r1_interval": 2}, dcgan=True),
                              [torch.cat([dcgan_make_hidden(g, 2, 32)] * 2) for _ in range(2)], STEP_ATOL),
        "rgb_stylegan_bf16": (_rgb_small_config({"mixed16": True}), [torch.cat([stylegan_make_hidden(g, 2, 32)] * 2)],
                              STEP_BF16_ATOL),
    }
    _reset_launches()
    for phase, (config, zs, atol) in runs.items():
        losses = {}
        for device in ("cpu", "cuda"):
            trainer = Trainer(config, dataset=data, seed=0, device=device)  # same weights
            losses[device] = []
            for it, z in enumerate(zs):
                spec = trainer._spec_for(it, 6)
                x = torch.from_numpy(data[4 * it:4 * it + 4].transpose(0, 2, 3, 1).copy()).to(device)
                _, metrics = trainer._step(spec)(trainer.state, x, 0.0, z=z)
                losses[device].append({k: float(v) for k, v in metrics.items() if "loss" in k})
        worst = _hold(phase, losses, atol)
        log(phase, cpu=json.dumps(losses["cpu"]), cuda=json.dumps(losses["cuda"]), max_abs_diff=f"{worst:.3e}",
            rtol=STEP_RTOL, atol=atol)
        if "gen/loss_rotate" in losses["cuda"][0]:
            raise AssertionError(f"{phase}: the RGB step took a 3D loss")
        if len(zs) == 2 and not (losses["cuda"][0]["dis/loss_gp"] > 0 and losses["cuda"][1]["dis/loss_gp"] == 0):
            raise AssertionError(f"{phase}: lazy R1 on the wrong step: {losses['cuda']}")

    # the legacy step: the same draws on both devices, mixing forced on in both
    # phases. Its D phase renders through the generator *after* Adam's first
    # step, which moves each element by about alpha times the sign of its
    # gradient, so its dis/loss_adv is held as phase 6 holds the DeepVoxels
    # one (DIS_AFTER_UPDATE_ATOL, and the share of generator elements apart
    # by MAX_SHARE_APART); the losses before the update to phase 5's
    # tolerance. At the plain init (the 4x4 constant all ones) float32 noise
    # picks most of those signs: dis/loss_adv read 7.5e-2 apart on the card
    # (NVIDIA H100 80GB HBM3, 700 W), and on the CPU moving the weights by
    # 1e-7 of themselves moved it by 3.5e-2. So both start from weights
    # moved by seeded noise, as the CPU parity tests do: there the same 1e-7
    # moves it by 2.6e-6, and the card read 3.7e-3.
    draws = {k: stylegan_make_hidden(g, 4, 32) for k in ("z", "z2", "z_d", "z2_d")}
    losses, params = {}, {}
    for device in ("cpu", "cuda"):
        trainer = Trainer(_rgb_small_config({}), dataset=data, seed=0, device=device)
        noise = torch.Generator().manual_seed(10)
        with torch.no_grad():
            for p in list(trainer.state.gen.parameters()) + list(trainer.state.dis.parameters()):
                p.add_((0.05 * torch.randn(p.shape, generator=noise)).to(device))
        step = make_legacy_train_step(trainer.make_hidden, StepSpec(stage_floor=6, batch_size=4, max_stage=7,
                                                                    style_mixing_rate=1.0))
        x = torch.from_numpy(data[:4].transpose(0, 2, 3, 1).copy()).to(device)
        _, metrics = step(trainer.state, x, 0.0, mix=True, mix_d=True, **draws)
        losses[device] = {k: float(v) for k, v in metrics.items() if "loss" in k}
        params[device] = torch.cat([p.detach().flatten().cpu() for p in trainer.state.gen.parameters()])
    after = abs(losses["cpu"]["dis/loss_adv"] - losses["cuda"]["dis/loss_adv"])
    apart = float(((params["cpu"] - params["cuda"]).abs() > 1e-4).float().mean())
    before = {device: [{k: v for k, v in ls.items() if k != "dis/loss_adv"}] for device, ls in losses.items()}
    worst = _hold("legacy_step_parity", before, STEP_ATOL)
    log("legacy_step_parity", cpu=json.dumps(losses["cpu"]), cuda=json.dumps(losses["cuda"]),
        max_abs_diff_before_update=f"{worst:.3e}", rtol=STEP_RTOL, atol=STEP_ATOL,
        dis_after_update_abs_diff=f"{after:.3e}", dis_after_update_atol=DIS_AFTER_UPDATE_ATOL,
        share_of_generator_elements_apart=f"{apart:.5f}")
    if not (math.isfinite(losses["cuda"]["dis/loss_adv"]) and after <= DIS_AFTER_UPDATE_ATOL):
        raise AssertionError(f"legacy step parity: dis/loss_adv after the update {after:.3e} apart")
    if apart > MAX_SHARE_APART:
        raise AssertionError(f"legacy step parity: {apart:.4f} of the generator's elements ended apart")

    # the heads' forwards, training mode (the encoder's BatchNorm on the batch's statistics)
    heads = {
        "encoder": (Encoder(32, 16, generator=torch.Generator().manual_seed(0)), [(4, 32, 32, 3)], (5, 0.3)),
        "bigbigan": (BigBiGANDiscriminator(32, 16, res=True, generator=torch.Generator().manual_seed(0)),
                     [(4, 32, 32, 3), (4, 16), (4, 9)], (6, 0.0)),
        "disentangled": (DisentangledDiscriminator(32, res=True, generator=torch.Generator().manual_seed(0)),
                         [(4, 32, 32, 3)], (5, 0.3)),
    }
    apart = {}
    for name, (module, shapes, static) in heads.items():
        inputs = [torch.randn(*shape, generator=g) for shape in shapes]
        on_card = copy.deepcopy(module).cuda()
        with torch.no_grad():
            want = module(*inputs, *static)
            got = on_card(*[t.cuda() for t in inputs], *static)
        want, got = (want if isinstance(want, tuple) else (want,)), (got if isinstance(got, tuple) else (got,))
        apart[name] = max(float((a - b.cpu()).abs().max()) / float(a.abs().max()) for a, b in zip(want, got))
    log("heads_parity", rel_diff=json.dumps({k: f"{v:.3e}" for k, v in apart.items()}), rel_tol=HEAD_REL)
    if any(v > HEAD_REL for v in apart.values()):
        raise AssertionError(f"heads parity: {apart} above {HEAD_REL}")
    _no_kernel_launched("rgb_step_parity")


def phase_rgb_paths(torch, has_yaml: bool):
    """Phase 19: the full-width RGB paths through the CLI's run function
    (StyleGAN f32 and bf16, DCGAN f32), each launching no kernel of the
    port; ``cli/evaluate.py --preview`` on the StyleGAN RGB snapshot; the
    legacy step at full width; and the nvprof run of
    ``structured_spheres_dcgan.yml`` with ``rgb: True``."""
    bf16, f32 = torch.bfloat16, torch.float32
    paths, lifts = {}, {}
    eval_counts = {}

    def preview(config):
        from rgbd_gan_tpu_torch.cli import evaluate

        _reset_launches()
        results = evaluate.run(config, preview=True)
        torch.cuda.synchronize()
        eval_counts.update(_no_kernel_launched("eval_preview_rgb"))
        grid = _read_grid(results["preview"])
        log("eval_preview_rgb", grid=json.dumps(list(grid.shape)), launches=json.dumps(eval_counts))
        if grid.shape != (8 * 128, 8 * 128, 3):
            raise AssertionError(f"rgb eval preview: grid of shape {grid.shape}, not 8x8 RGB images of 128 px")

    paths["stylegan_rgb"], lifts["stylegan_rgb"], _ = _drive(
        torch, has_yaml, "main_path_rgb", FFHQ_STYLEGAN_RGB, 128, "ffhq_stylegan_rgb", after=preview,
        bilinear_per_step=BILINEAR_NONE)
    sites = {"gen.gen.block5.c1": bf16, "gen.gen.out5": f32, "dis.block1.c0": bf16}
    paths["stylegan_rgb_bf16"], lifts["stylegan_rgb_bf16"], _ = _drive(
        torch, has_yaml, "main_path_rgb_bf16", dict(FFHQ_STYLEGAN_RGB, mixed16=True), 128, "ffhq_stylegan_rgb_bf16",
        sites, bilinear_per_step=BILINEAR_NONE)
    paths["dcgan_rgb"], lifts["dcgan_rgb"], _ = _drive(
        torch, has_yaml, "main_path_dcgan_rgb", DCGAN_SHAPENET_CAR_RGB, 128, "dcgan_shapenet_car_rgb",
        bilinear_per_step=BILINEAR_NONE)
    paths["legacy"], lifts["legacy"] = _legacy_path(torch)

    def profiled(config):
        trace = os.path.join(config.out, "profile", "trace.json")
        size = os.path.getsize(trace) if os.path.exists(trace) else 0
        with open(trace) as f:
            text = f.read() if size else ""
        kernel_events = len(re.findall(r'"cat":\s*"kernel"', text))
        grids = {sub: list(_read_grid(os.path.join(config.out, sub, "image_latest.png")).shape)
                 for sub in ("preview", "preview_smoothed")}
        log("nvprof_rgb", trace_bytes=size, kernel_events=kernel_events, grids=json.dumps(grids))
        if not (size and '"traceEvents"' in text and kernel_events):
            raise AssertionError(f"nvprof: no trace with CUDA kernels at {trace} ({size} bytes)")
        if any(tuple(shape) != (8 * 64, 8 * 64, 3) for shape in grids.values()):
            raise AssertionError(f"nvprof: preview grids of shapes {grids}")

    paths["dcgan_rgb_nvprof"], lifts["dcgan_rgb_nvprof"], _ = _drive(
        torch, has_yaml, "main_path_dcgan_rgb_nvprof", STRUCTURED_SPHERES_DCGAN_NVPROF, 32,
        "structured_spheres_dcgan_rgb_nvprof", after=profiled, bilinear_per_step=BILINEAR_NONE,
        iterations=NVPROF_ITERATIONS)
    paths["rgb_eval_preview"], lifts["rgb_eval_preview"] = eval_counts["bilinear"], eval_counts["trilinear"]
    if any(v for lift in lifts.values() for v in lift.values()):
        raise AssertionError(f"rgb paths: the lift launched {lifts}")
    return paths, lifts


def _legacy_path(torch):
    """The legacy step at the StyleGAN yml's widths (ch 256, batch 32, 128 px,
    an RGB generator, R1) with the legacy updater's style mixing, 3 steps on
    the trainer's stream of draws; each step timed to its end."""
    from rgbd_gan_tpu_torch.core.config import Config
    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
    from rgbd_gan_tpu_torch.train.legacy import make_legacy_train_step
    from rgbd_gan_tpu_torch.train.steps import StepSpec
    from rgbd_gan_tpu_torch.train.trainer import Trainer

    values = dict(FFHQ_STYLEGAN_RGB, style_mixing_rate=LEGACY_MIXING_RATE)
    trainer = Trainer(Config(values), dataset=synthetic_dataset(64, 128), seed=0, device="cuda")
    spec = StepSpec(stage_floor=10, batch_size=values["batchsize"], max_stage=values["max_stage"],
                    style_mixing_rate=LEGACY_MIXING_RATE)
    step = make_legacy_train_step(trainer.make_hidden, spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    step_ms, rows = [], []
    for _ in range(LEGACY_STEPS):
        x = torch.from_numpy(trainer.iterator.next()).cuda()
        t0 = time.perf_counter()
        _, metrics = step(trainer.state, x, 0.0, trainer.rng)
        rows.append({k: float(v) for k, v in metrics.items()})  # the host reads the losses: the step has ended
        step_ms.append(1e3 * (time.perf_counter() - t0))
    counts = _no_kernel_launched("legacy_path")
    log("legacy_path", steps=LEGACY_STEPS, style_mixing_rate=LEGACY_MIXING_RATE,
        step_ms=json.dumps([round(t, 3) for t in step_ms]), median_ms_per_step_2_3=f"{statistics.median(step_ms[1:]):.3f}",
        img_per_s=f"{values['batchsize'] * 1e3 / statistics.median(step_ms[1:]):.2f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}", last=json.dumps(rows[-1]))
    if not all(math.isfinite(v) for row in rows for v in row.values()) or any(row["nan"] for row in rows):
        raise AssertionError(f"legacy path: losses not finite {rows}")
    return counts["bilinear"], counts["trilinear"]


# ---------------------------------------------------------------------------
# phase 20: data parallelism, two ranks on the one card
# ---------------------------------------------------------------------------


def _digest(modules) -> int:
    """A 63-bit hash of the modules' parameters and buffers, bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for m in modules:
        for t in m.state_dict().values():
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def _dp_nccl_probe(torch, rank, world, work, args):
    """Two NCCL ranks on one card: the all-reduce's answer, or its refusal."""
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device="cuda:0")
    try:
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return {"ok": True, "sum": x.tolist()}
    except Exception as e:  # the refusal is the finding
        return {"ok": False, "answer": f"{type(e).__name__}: {e}"[:800]}


def _dp_nccl_one_rank(torch, rank, world, work, args):
    """A one-rank NCCL group: the port's averaging functions on CUDA tensors."""
    from rgbd_gan_tpu_torch.parallel.mesh import all_mean, mean_metrics, world_size

    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(1000, device="cuda", generator=g), torch.randn(3, 5, device="cuda", generator=g)]
    means = all_mean(xs)
    metrics = mean_metrics({"a": torch.tensor(1.5, device="cuda")}, torch.tensor(True, device="cuda"))
    torch.cuda.synchronize()
    return {"world": world_size(), "max_abs_diff": max(float((a - b).abs().max()) for a, b in zip(means, xs)),
            "metric": float(metrics["a"]), "nan": bool(metrics["nan"])}


def _dp_parity(torch, rank, world, work, args):
    """One StyleGAN step at phase 5's width on ``args['device']``, rank r on
    its shard of 4 images with its own draws, made on the CPU."""
    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
    from rgbd_gan_tpu_torch.models.generators import stylegan_make_hidden
    from rgbd_gan_tpu_torch.parallel.mesh import shard_batch
    from rgbd_gan_tpu_torch.train.trainer import Trainer

    config = _small_config()
    config.batchsize, config.use_mpi = 4 * world, True
    data = synthetic_dataset(4 * world, 32)
    trainer = Trainer(config, dataset=data, seed=0, device=args["device"])  # the same weights on every rank
    g = torch.Generator().manual_seed(100 + rank)
    z = torch.cat([stylegan_make_hidden(g, 2, config.ch)] * 2)
    thetas6 = trainer.prior.sample(g, 4, "cpu")
    x = torch.from_numpy(shard_batch(data, rank, world).transpose(0, 2, 3, 1).copy()).to(args["device"])
    spec = trainer._spec_for(0, 6)
    _reset_launches()
    _, metrics = trainer._step(spec)(trainer.state, x, 0.0, z=z, thetas6=thetas6)
    if args["device"] == "cuda":
        torch.cuda.synchronize()
    return {"losses": {k: float(v) for k, v in metrics.items() if "loss" in k}, "nan": bool(metrics["nan"]),
            "local_batch": spec.batch_size, "digest": _digest([trainer.state.gen, trainer.state.dis]),
            "launches": _read_launches()}


def _dp_path(torch, rank, world, work, args):
    """``args['values']`` (with ``use_mpi: True``) through the CLI's run
    function on the card, each rank with an ``out`` of its own, the launch
    counts zeroed just before and read just after; the parameters' digest
    reduced across the ranks (max and min). On DeepVoxels, each call of the
    step's BatchNorm averaging records this rank's statistics before it and
    the result."""
    import torch.distributed as dist

    from rgbd_gan_tpu_torch.cli import train as cli
    from rgbd_gan_tpu_torch.core.config import Config
    from rgbd_gan_tpu_torch.train import steps_deepvoxels

    out = os.path.join(work, f"out_r{rank}")
    config = Config(dict(args["values"], dataset_path=args["data"], image_path="unused/*.png", out=out))
    config.gpu = 0
    stamps, stats = [], {}
    mean_batch_stats = steps_deepvoxels.mean_batch_stats

    def recorded(gen):
        own = {k: v.clone() for k, v in gen.state_dict().items() if k.endswith((".mean", ".var"))}
        mean_batch_stats(gen)
        stats.update(own={k: v.tolist() for k, v in own.items()},
                     mean={k: v.tolist() for k, v in gen.state_dict().items() if k in own})

    def on_row(row):
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), row))

    steps_deepvoxels.mean_batch_stats = recorded
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        trainer = cli.run(config, on_row=on_row, device="cuda")
        torch.cuda.synchronize()
        counts = _read_launches()
    finally:
        steps_deepvoxels.mean_batch_stats = mean_batch_stats
    digest = _digest([trainer.state.gen, trainer.state.dis])
    spread = torch.tensor([digest, -digest], dtype=torch.int64, device="cuda")
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    step_ms = [1e3 * (stamps[i][0] - stamps[i - 1][0]) for i in range(1, len(stamps))]
    return {"step_ms": step_ms, "median_ms": statistics.median(step_ms), "rows": [r for _, r in stamps],
            "iteration": trainer.state.iteration, "local_batch": trainer.local_batch,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts,
            "digest_max": int(spread[0]), "digest_min": -int(spread[1]),
            "files": sorted(os.listdir(out)) if os.path.isdir(out) else None, "batch_stats": stats}


DP_LEGS = {"nccl_probe": _dp_nccl_probe, "nccl_one_rank": _dp_nccl_one_rank, "parity": _dp_parity,
           "path": _dp_path}


def _dp_rank(rank: int, world: int, backend: str, init_file: str, legs, work: str) -> None:
    """One rank of phase 20, in a process of its own: joins a ``world``-rank
    ``backend`` group through a file store, runs ``legs`` ((name, kind,
    args) in order) and writes their results to ``work/rank{rank}.json``
    (with the traceback under ``error`` if one raised)."""
    import traceback

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(0)  # every rank on the one card, not LOCAL_RANK's
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=world)
        for name, kind, args in legs:
            results[name] = DP_LEGS[kind](torch, rank, world, work, args)
        if all(kind != "nccl_probe" for _, kind, _ in legs):
            dist.barrier()  # no rank tears the group down while another still runs: that can abort
    except Exception:
        results["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn_ranks(work: str, world: int, backend: str, legs, timeout: float):
    """Run :func:`_dp_rank` in ``world`` spawned processes and return each
    rank's results; a rank that does not end within ``timeout`` seconds is
    killed and reads ``{"error": "timed out"}``."""
    import multiprocessing

    os.makedirs(work)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank, args=(r, world, backend, os.path.join(work, "store"), legs, work))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    results = []
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
        path = os.path.join(work, f"rank{r}.json")
        results.append(json.load(open(path)) if os.path.exists(path) else {"error": f"timed out or died ({p.exitcode})"})
    return results


def _dp_failed(phase: str, results) -> None:
    for r, res in enumerate(results):
        if "error" in res:
            raise AssertionError(f"{phase}: rank {r} failed:\n{res['error']}")


def phase_data_parallel(torch, device: str = "cuda", stylegan=None, deepvoxels=None, image_px=(128, 64)):
    """Phase 20: data parallelism with two ranks on the one card, each a
    spawned process given its device (not torchrun's LOCAL_RANK: the card has
    one index). First NCCL's answer to two ranks on one device; a one-rank
    NCCL group running the averaging functions on CUDA tensors; then, with
    the backend the probe leaves (gloo, which reduces CUDA tensors through
    the host, where NCCL refuses), (a) phase 5's step on two ranks on the
    card against the same two-rank step on the CPU under gloo, (b) the
    full-width StyleGAN path and (c) the RenderNet DeepVoxels path through
    the CLI's run function. ``device="cpu"`` with small ``stylegan`` and
    ``deepvoxels`` values rehearses the legs on the CPU. Returns the
    bilinear launch counts of (b) and (c), and the lift counts of (c), each
    summed over the ranks."""
    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset

    stylegan = stylegan or FFHQ_STYLEGAN_DP
    deepvoxels = deepvoxels or DEEPVOXELS_RENDERNET_DP
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        backend = "gloo"
        if device == "cuda":
            # the earlier phases' cached blocks go back to the card, which the ranks share with this process
            import gc

            gc.collect()
            torch.cuda.empty_cache()
            log("dp_parent_memory", allocated_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}",
                reserved_gib=f"{torch.cuda.memory_reserved() / 2**30:.3f}")
            probe = _spawn_ranks(os.path.join(work, "probe"), DP_WORLD, "nccl",
                                 [("nccl_probe", "nccl_probe", {})], DP_PROBE_TIMEOUT)
            answers = [res.get("nccl_probe", {"ok": False, "answer": res.get("error", "")[-800:]}) for res in probe]
            refused = not all(a["ok"] for a in answers)
            log("dp_nccl_two_ranks_one_card", refused=refused, answers=json.dumps(answers))
            backend = "gloo" if refused else "nccl"
            (one,) = _spawn_ranks(os.path.join(work, "nccl1"), 1, "nccl", [("nccl", "nccl_one_rank", {})], 300)
            _dp_failed("dp_nccl_one_rank", [one])
            log("dp_nccl_one_rank", **{k: json.dumps(v) for k, v in one["nccl"].items()})
            if one["nccl"]["max_abs_diff"] != 0 or one["nccl"]["world"] != 1 or not one["nccl"]["nan"]:
                raise AssertionError(f"dp_nccl_one_rank: {one}")
        for name, px in zip(("data_stylegan", "data_deepvoxels"), image_px):
            os.makedirs(os.path.join(work, name))
            np.save(os.path.join(work, name, "images.npy"), synthetic_dataset(64, px))
        legs = [("parity_card", "parity", {"device": device}),
                ("stylegan", "path", {"values": stylegan, "data": os.path.join(work, "data_stylegan")}),
                ("deepvoxels", "path", {"values": deepvoxels, "data": os.path.join(work, "data_deepvoxels")})]
        cpu_leg = [("parity_cpu", "parity", {"device": "cpu"})]
        if backend == "gloo":  # one gloo group reduces the CPU's tensors and the card's
            ranks = _spawn_ranks(os.path.join(work, "ranks"), DP_WORLD, backend, cpu_leg + legs, DP_TIMEOUT)
            cpu = ranks
        else:
            ranks = _spawn_ranks(os.path.join(work, "ranks"), DP_WORLD, backend, legs, DP_TIMEOUT)
            cpu = _spawn_ranks(os.path.join(work, "cpu"), DP_WORLD, "gloo", cpu_leg, DP_TIMEOUT)
        _dp_failed("data_parallel", ranks + cpu)
        return _dp_check(backend, ranks, cpu, stylegan, deepvoxels, on_card=device == "cuda")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _dp_check(backend, ranks, cpu, stylegan, deepvoxels, on_card: bool):
    """Phase 20's assertions and lines (off the card, in a rehearsal, no
    kernel launches)."""
    one_step = BILINEAR_ONE_STEP if on_card else BILINEAR_NONE
    # (a) parity: the card's two-rank step against the CPU's
    card = [r["parity_card"] for r in ranks]
    host = [r["parity_cpu"] for r in cpu]
    worst = _hold("dp_step_parity", {"cpu": [host[0]["losses"]], "cuda": [card[0]["losses"]]}, STEP_ATOL)
    log("dp_step_parity", backend=backend, local_batch=card[0]["local_batch"], cpu=json.dumps(host[0]["losses"]),
        cuda=json.dumps(card[0]["losses"]), max_abs_diff=f"{worst:.3e}", atol=STEP_ATOL, rtol=STEP_RTOL,
        digests=json.dumps([c["digest"] for c in card]), launches=json.dumps([c["launches"]["bilinear"] for c in card]))
    for name, pair in (("card", card), ("cpu", host)):
        if len({c["digest"] for c in pair}) != 1 or any(c["losses"] != pair[0]["losses"] or c["nan"] for c in pair):
            raise AssertionError(f"dp_step_parity: the {name} ranks differ: {pair}")
    if any(c["launches"]["bilinear"] != one_step for c in card):
        raise AssertionError(f"dp_step_parity: bilinear launches {[c['launches'] for c in card]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    bilinear, lift = {}, {}
    for path, values, per_step, lift_per_step in (
            ("stylegan", stylegan, one_step, {}),
            ("deepvoxels", deepvoxels, one_step, {"fwd_win_vec4": 2, "bwd_win_vec4": 1} if on_card else {})):
        legs = [r[path] for r in ranks]
        n = values["iteration"]
        log(f"dp_main_path_{path}", card=repr(smi), backend=backend, ranks=DP_WORLD, global_batch=values["batchsize"],
            local_batch=legs[0]["local_batch"],
            **{f"rank{r}_median_ms_per_step_2_{n}": f"{leg['median_ms']:.3f}" for r, leg in enumerate(legs)},
            **{f"rank{r}_peak_mem_gib": f"{leg['peak_mem_gib']:.3f}" for r, leg in enumerate(legs)},
            step_ms=json.dumps([[round(t, 3) for t in leg["step_ms"]] for leg in legs]),
            launches=json.dumps([leg["launches"] for leg in legs]), digests=json.dumps([legs[0]["digest_max"],
                                                                                      legs[0]["digest_min"]]),
            files=json.dumps([leg["files"] for leg in legs]), last=json.dumps(legs[0]["rows"][-1]))
        rows = legs[0]["rows"]
        if any(leg["iteration"] != n or len(leg["rows"]) != n for leg in legs) or not all(
                math.isfinite(row[k]) for row in rows for k in row if k.startswith(("gen/", "dis/"))):
            raise AssertionError(f"dp {path}: expected {n} iterations with finite losses")
        if rows[-1]["batch_size"] != values["batchsize"] or legs[0]["local_batch"] != values["batchsize"] // DP_WORLD:
            raise AssertionError(f"dp {path}: batch {rows[-1]['batch_size']}, local {legs[0]['local_batch']}")
        metrics = [[{k: v for k, v in row.items() if k != "elapsed_time"} for row in leg["rows"]] for leg in legs]
        if any(m != metrics[0] for m in metrics[1:]):
            raise AssertionError(f"dp {path}: the ranks report different metrics")
        for leg in legs:
            if leg["launches"]["bilinear"] != {k: v * n for k, v in per_step.items()}:
                raise AssertionError(f"dp {path}: bilinear launches {leg['launches']['bilinear']}")
            if leg["launches"]["trilinear"] != {**LIFT_NONE, **{k: v * n for k, v in lift_per_step.items()}}:
                raise AssertionError(f"dp {path}: lift launches {leg['launches']['trilinear']}")
            if any(leg["launches"]["conv"].values()):
                raise AssertionError(f"dp {path}: K6 is wired into no model, yet launched {leg['launches']['conv']}")
        # only rank 0 writes: its out has the log and the snapshot, rank 1's does not exist
        if legs[1]["files"] is not None or "log.jsonl" not in legs[0]["files"] \
                or "Generator_latest.npz" not in legs[0]["files"]:
            raise AssertionError(f"dp {path}: files {[leg['files'] for leg in legs]}")
        if legs[0]["digest_max"] != legs[0]["digest_min"]:
            raise AssertionError(f"dp {path}: the ranks' parameters differ")
        bilinear[path] = {k: sum(leg["launches"]["bilinear"][k] for leg in legs) for k in BILINEAR_NONE}
        lift[path] = {k: sum(leg["launches"]["trilinear"][k] for leg in legs) for k in LIFT_NONE}
    # (c) the RenderNet BatchNorm statistics: the same on both ranks, the mean of the ranks' own
    stats = [r["deepvoxels"]["batch_stats"] for r in ranks]
    worst = 0.0
    for k in stats[0]["mean"]:
        own = [np.asarray(s["own"][k], np.float32) for s in stats]
        mean = np.asarray(stats[0]["mean"][k], np.float32)
        if any(s["mean"][k] != stats[0]["mean"][k] for s in stats) or np.allclose(own[0], own[1]):
            raise AssertionError(f"dp deepvoxels: {k} differs across ranks, or the ranks' own statistics agree")
        worst = max(worst, float(np.abs(mean - (own[0] + own[1]) / 2).max() / max(np.abs(mean).max(), 1e-30)))
    log("dp_deepvoxels_batch_stats", stats=len(stats[0]["mean"]), max_rel_from_mean_of_ranks=f"{worst:.3e}",
        rtol=DP_STATS_RTOL)
    if not stats[0]["mean"] or worst > DP_STATS_RTOL:
        raise AssertionError(f"dp deepvoxels: statistics {worst} from the mean of the ranks' own")
    return bilinear, lift


# ---------------------------------------------------------------------------
# phase 21: the Inception converter chain on the card
# ---------------------------------------------------------------------------


def phase_converter(torch, device: str = "cuda", size: int = 299):
    """Phase 21: a synthetic ``classify_image_graph_def.pb`` (the real
    topology and shapes, random constants) through the port's tool to the
    npz, loaded with ``load_params`` on ``device``; the port's GraphDef
    executor on ``device`` against the loaded model with TF's
    count-exclude-padding average pool swapped in (``pool_3`` features and
    the logits, within ``CONVERTER_REL`` of their largest), against itself
    on the CPU, and (printed) against the model's own padded pools. No
    kernel of the port may launch."""
    import torch.nn.functional as F

    from rgbd_gan_tpu_torch.eval import graphdef_exec, inception
    from rgbd_gan_tpu_torch.eval import tf_graphdef as gd
    from rgbd_gan_tpu_torch.tools import convert_inception
    from rgbd_gan_tpu_torch.tools.inception_graph import synthetic_consts, wired_graphdef

    work = tempfile.mkdtemp(prefix="chip_smoke_inception_", dir=os.path.dirname(os.path.abspath(__file__)))
    pool = inception._avg_pool_3x3
    try:
        pb, npz = os.path.join(work, convert_inception.PB_NAME), os.path.join(work, "inception.npz")
        with open(pb, "wb") as f:
            f.write(wired_graphdef(synthetic_consts(np.random.RandomState(21)), size))
        _reset_launches()
        t0 = time.perf_counter()
        convert_inception.main([pb, "--out", npz, "--device", device])
        convert_s = time.perf_counter() - t0
        model = inception.load_params(npz, device=device)
        graph = gd.GraphDef(open(pb, "rb").read())
        x = np.random.RandomState(5).uniform(0, 255, size=(2, size, size, 3)).astype(np.float32)
        feeds = {"ExpandDims:0": x}
        executor = graphdef_exec.GraphExecutor(graph, device)
        feat = executor.run("pool_3:0", feeds).reshape(2, -1)
        logits = torch.cat([executor.run("softmax/logits:0", {"ExpandDims:0": x[i:i + 1]}) for i in range(2)])
        feat_cpu = graphdef_exec.GraphExecutor(graph, "cpu").run("pool_3:0", feeds).reshape(2, -1)
        with torch.no_grad():
            xt = torch.from_numpy(x).to(device)
            own = model(xt, get_feature=True)
            inception._avg_pool_3x3 = lambda h: F.avg_pool2d(h, 3, 1, 1, count_include_pad=False)
            tf_feat = model(xt, get_feature=True)
            tf_logits = model.logit(tf_feat)
        ms = None
        if device == "cuda":  # the whole graph, host dispatch included
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                executor.run("pool_3:0", feeds)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / 3
        counts = _read_launches()

        def rel(a, b):
            return float((a.cpu() - b.cpu()).abs().max()) / float(b.abs().max())

        fields = dict(size=size, convert_s=f"{convert_s:.2f}", feature_rel=f"{rel(feat, tf_feat):.3e}",
                      logit_rel=f"{rel(logits, tf_logits):.3e}", card_vs_cpu_rel=f"{rel(feat, feat_cpu):.3e}",
                      vs_model_own_pools_rel=f"{rel(feat, own):.3e}", tol=CONVERTER_REL,
                      executor_ms_batch_2=f"{ms:.3f}" if ms is not None else "not measured",
                      launches=json.dumps(counts))
        log("converter", **fields)
        if max(rel(feat, tf_feat), rel(logits, tf_logits), rel(feat, feat_cpu)) > CONVERTER_REL:
            raise AssertionError(f"converter: executor and converted model apart: {fields}")
        if any(v for kind in counts.values() for v in kind.values()):
            raise AssertionError(f"converter: launched the port's kernels {counts}")
    finally:
        inception._avg_pool_3x3 = pool
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    try:
        import rgbd_gan_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    started = time.perf_counter()
    has_yaml = phase_device(torch)
    bilinear_parity = {path: phase_kernels(torch, path) for path in BILINEAR_SHAPES}
    lift_errs, lift_times, lift_bounds = phase_lift_kernels(torch)
    conv_records, conv_launches, conv_compared, conv_versus_library = phase_conv(torch)
    phase_step_parity(torch)
    phase_deepvoxels_step_parity(torch)
    by_path = {"stylegan": phase_main_path(torch, has_yaml)}
    lift_by_path, by_path["deepvoxels"], by_path["deepvoxels_f32"] = phase_deepvoxels_paths(torch, has_yaml)
    phase_step_parity_bf16(torch)
    by_path["stylegan_bf16"], by_path["stylegan_bf16_lazy_r1"] = phase_main_path_bf16(torch, has_yaml)
    by_path["deepvoxels_bf16"], lift_by_path["deepvoxels_bf16"] = phase_deepvoxels_bf16(torch, has_yaml)
    phase_dcgan_step_parity(torch)
    by_path.update(phase_dcgan_main_path(torch, has_yaml))
    by_path["dcgan_step_window"] = phase_step_window_previews(torch, has_yaml)
    phase_family_step_parity(torch)
    family_paths, family_lift = phase_family_paths(torch, has_yaml)
    by_path.update(family_paths)
    lift_by_path.update(family_lift)
    phase_rgb_step_parity(torch)
    rgb_paths, rgb_lift = phase_rgb_paths(torch, has_yaml)
    by_path.update(rgb_paths)
    lift_by_path.update(rgb_lift)
    dp_paths, dp_lift = phase_data_parallel(torch)
    by_path.update({f"{path}_dp_{DP_WORLD}_ranks": counts for path, counts in dp_paths.items()})
    lift_by_path.update({f"{path}_dp_{DP_WORLD}_ranks": counts for path, counts in dp_lift.items()})
    phase_converter(torch)
    log("wall", seconds=f"{time.perf_counter() - started:.1f}")

    def entry(name, source, replaces, n_launches, err, ms, plain_ms, bound, library_ms=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": library_ms}

    bil, tri = "rgbd_gan_tpu_torch/csrc/bilinear.cu", "rgbd_gan_tpu_torch/csrc/trilinear.cu"
    pallas = "rgbd_gan_tpu/ops/%s_pallas.py:%d"
    kernels = []
    # the bilinear pair runs on every training path: `launches` is the sum of
    # the runs' counts, the other numbers are those at the StyleGAN shapes on
    # random points (the DCGAN step's too); the DeepVoxels shapes' and the
    # feature 3D-consistency loss's (C = 257) stand beside them, each on
    # every set of points
    def figures(path, key, kind):
        r = bilinear_parity[path][1][kind]
        f = {"max_abs_err": r[key + "_max_abs_err"], "ms": r[key], "plain_ms": r[key + "_plain"],
             "library_ms": r[key + "_library"], "bound_ms": r["bounds"][key]["bound_ms"],
             "bound_by": r["bounds"][key]["bound_by"], "in_bounds_points": r["in_bounds_points"]}
        if key + "_generic" in r:  # the thread-per-point kernel, timed in turns with the path's
            f.update(generic_ms=r[key + "_generic"], in_turns_ms=r[key + "_in_turns"])
        if key == "bwd" and "modelled_corner_additions_per_reduction" in r:
            f["modelled_corner_additions_per_reduction"] = r["modelled_corner_additions_per_reduction"]
        return f

    for key, line, counted, kernel in (
            ("fwd", 111, ("fwd", "fwd_lanes"), "bilinear_fwd_kernel<EXACT, true> (C = 4), bilinear_fwd_lanes_kernel "
             "(other C)"),
            ("bwd", 130, ("bwd_vec4", "bwd_lanes", "bwd"), "bilinear_bwd_vec4_kernel (C = 4), "
             "bilinear_bwd_lanes_kernel (other C)")):
        wide = lanes_instance(key, True, BILINEAR_SHAPES["rotate_feature"]["C"])
        top = figures("stylegan", key, "random")
        e = dict(
            entry("bilinear_gather_" + key, bil, pallas % ("bilinear", line),
                  sum(counts[k] for counts in by_path.values() for k in counted),
                  max(bilinear_parity[path][0][key] for path in BILINEAR_SHAPES), top["ms"], top["plain_ms"], top,
                  top["library_ms"]),
            kernel=kernel,
            launches_by_path={path: sum(counts[k] for k in counted) for path, counts in by_path.items()},
            launches_by_kernel={k: sum(counts[k] for counts in by_path.values()) for k in counted},
            **{k: v for k, v in top.items() if k in ("generic_ms", "in_turns_ms",
                                                     "modelled_corner_additions_per_reduction")},
            at_warp_points=figures("stylegan", key, "warp"),
            at_deepvoxels_shapes=dict(figures("deepvoxels", key, "random"),
                                      at_warp_points=figures("deepvoxels", key, "warp")),
            # the feature 3D-consistency loss's gathers: C = 257, a warp a point
            at_rotate_feature_shapes=dict(figures("rotate_feature", key, "random"), kernel=wide,
                                          shape=BILINEAR_SHAPES["rotate_feature"],
                                          at_warp_points=figures("rotate_feature", key, "warp"),
                                          at_feature_points=figures("rotate_feature", key, "feature")),
        )
        kernels.append(e)
    for key, line in (("fwd", 110), ("bwd", 141), ("fwd_win", 210), ("bwd_win", 240)):
        # the vectorised kernels ran: the windowed pair on the yml's default, the full pair on pallas_f32
        counted = key + "_vec4"
        e = entry(
            "trilinear_lift_" + key, tri, pallas % ("trilinear", line),
            sum(counts[counted] for counts in lift_by_path.values()), lift_errs[key],
            lift_times[key], lift_times[key + "_plain"], lift_bounds[key],
            lift_times["library_" + key[:3]],
        )
        # the vectorised kernel ran; the thread-per-(cell, channel) one, timed in turns
        e.update(kernel=f"lift_{key[:3]}_vec4_kernel", generic_ms=lift_times[key + "_generic"],
                 launches_by_path={path: counts[counted] for path, counts in lift_by_path.items()})
        kernels.append(e)
    # K6 on its path (the benchmark), one entry per kernel: the FMA kernel
    # with float32 at the first shape on top, the tensor-core kernel with
    # bfloat16 at the first shape; every (dtype, shape) of each stands beside
    fields = ("dtype", "shape", "route", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "peak",
              "max_abs_err", "max_abs_y", "rel_err_plain", "rel_err_library", "kernel_tflops", "library_tflops")
    for name, source, route in (("conv3x3_bias_lrelu", "conv3x3.cu", "fma"),
                                ("conv3x3_bias_lrelu_tc", "conv3x3_tc.cu", "tc")):
        mine = [r for r in conv_records if r["route"] == route]
        first = mine[0]
        e = dict(
            entry(name, "rgbd_gan_tpu_torch/csrc/" + source, pallas % ("conv", 37),
                  conv_launches["conv3x3" if route == "fma" else "conv3x3_tc"], first["max_abs_err"],
                  first["ms"], first["plain_ms"], first, first["library_ms"]),
            by_dtype_and_shape=[{k: r[k] for k in fields} for r in mine],
        )
        if route == "tc":
            e["fma_vs_tc_in_turns"] = conv_compared
        else:
            e["fma_vs_cudnn_f32_in_turns"] = conv_versus_library
        kernels.append(e)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
