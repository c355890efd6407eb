"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each printing one line; any failure exits non-zero:

1. device: CUDA, triton/yaml availability, nvcc, card name and power limit;
   builds the bilinear-gather, trilinear-lift and 3x3-conv kernels from
   `rgbd_gan_tpu_torch/csrc/`, one nvcc for each source, all at once.
2. bilinear kernel parity at the StyleGAN step's shapes (B=32, H=W=128, C=4,
   N=16384) and at the DeepVoxels step's (B=10, H=W=64, N=4096), exact True
   and False: K1 (forward) and K2 (backward) against the plain PyTorch
   version, with both times.
3. trilinear kernel parity at the DeepVoxels step's shapes (B=10, G=32,
   C=32, N=56*64*64 frustum cells under cameras from the yml's prior): K3,
   K4 and the windowed pair K5, float32 and bf16 operands, against the plain
   PyTorch version, with both times; `F.grid_sample` timed beside K3 and its
   backward (`aten.grid_sampler_3d_backward`) beside K4.
4. K6, the fused 3x3 conv + bias + leaky ReLU, on its path: the measuring
   function of `rgbd_gan_tpu_torch.tools.bench_conv` at its five shapes in
   float32 and bfloat16, holding the kernel against the plain PyTorch
   version, with its time, the plain version's, cuDNN conv + leaky ReLU's
   and the bound.
5. one StyleGAN train step at a small width (ch 32, batch 4, 32 px, rotate
   and occlusion on) from the same weights and draws, on the CPU with the
   plain gather and on the card with the kernels; the losses must agree.
6. the same for one DeepVoxels step (ch 32, batch 2, both occlusion nets).
7. the StyleGAN main path: the port's trainer at full width (ch 256, batch
   32, 128 px, the ffhq_stylegan_occlusion values) for 5 iterations through
   the CLI's run function, with a snapshot at the end; losses finite, and
   each bilinear kernel launched once per iteration.
8. the DeepVoxels main path: the deepvoxels_shapenet_car values (ch 256,
   batch 10, 64 px, accumulative, focal gamma 2) for 5 iterations the same
   way; the windowed lift launched twice forward and once backward per
   iteration, the bilinear kernels once each.
9. the same configuration with `lift_mode: pallas_f32` for 2 iterations, so
   that the full-width lift kernels run on a path too.

Each path (the benchmark of phase 4 and the three runs of phases 7-9) is
driven with every kernel's launch count set to 0 just before it and read
just after. The line before the last is a JSON object describing
each kernel (its time beside its bound, the plain version's time and, where
one exists, a single PyTorch call's); the last is
`{"ok": true, "device": {...}}`. There is no CPU path: without a card the
script exits with an error.
"""

from __future__ import annotations

import json
import math
import os
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
    z_translate=0, use_mpi=False, enable_cuda_profiling=False,
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
    z_translate=0, uniform_distribution=True, use_mpi=False,
    snapshot_interval=10000, evaluation_sample_interval=50, display_interval=1,
    get_model_from_interation="", style_mixing_rate=0.0, enable_blur=False,
)
# the bilinear gather's shapes on the StyleGAN path and on the DeepVoxels paths
BILINEAR_SHAPES = {
    "stylegan": dict(B=32, H=128, W=128, C=4, N=128 * 128),
    "deepvoxels": dict(B=10, H=64, W=64, C=4, N=64 * 64),
}
LIFT_SHAPE = dict(B=10, G=32, C=32, N=56 * 64 * 64)
# published peaks of one H100 SXM: HBM bytes/s and f32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
FWD_ATOL = 1e-5
DIMG_RTOL, DIMG_ATOL = 1e-5, 1e-4  # atomics reorder the sums
DUV_ATOL = 1e-5
STEP_RTOL, STEP_ATOL = 1e-3, 1e-4  # CPU vs card, f32 with TF32 off
LIFT_F32_RTOL, LIFT_F32_ATOL = 1e-5, 1e-5  # fused multiply-adds against separate ones
LIFT_BF16_RTOL, LIFT_BF16_ATOL = 2.0**-7, 1e-5  # at most one bf16 ulp where a sum's order differs
LIFT_DV_RTOL, LIFT_DV_ATOL = 1e-5, 1e-4  # atomics reorder the sums
GRID_SAMPLE_ATOL = 1e-4  # another formula for the same weights
GRID_SAMPLE_DV_RTOL, GRID_SAMPLE_DV_ATOL = 1e-4, 2e-4  # the same, summed over a corner's cells
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


def _reset_launches() -> None:
    from rgbd_gan_tpu_torch.ops import bilinear, conv, trilinear

    bilinear.launches.update(fwd=0, bwd=0)
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
    from rgbd_gan_tpu_torch.ops._build import nvcc_path

    nvcc_version = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True).stdout
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    from rgbd_gan_tpu_torch.ops import bilinear, conv, trilinear

    def build(module):
        t0 = time.perf_counter()
        lib = module.build()
        return lib.name, f"{time.perf_counter() - t0:.2f}"

    with ThreadPoolExecutor(max_workers=3) as pool:
        built = dict(pool.map(build, (bilinear, trilinear, conv)))
    log(
        "device", torch=torch.__version__, cuda=torch.version.cuda, triton=has_triton, yaml=has_yaml,
        nvcc=repr(nvcc_version.strip().splitlines()[-1] if nvcc_version else "missing"),
        build_s=json.dumps(built),
    )
    print(smi, flush=True)
    return has_yaml


def _time_ms(torch, fn, reps: int = 20):
    """(device ms, wall ms) per call. Device time is the sum of the CUDA
    kernels the call launches, from the profiler (None if it records no
    device time); wall time is between CUDA events around back-to-back calls,
    so it includes the host's launch overhead where that exceeds the kernels."""
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.device_time for e in kernels)
    return (device_us / 1e3 / reps if device_us > 0 else None), wall


def phase_kernels(torch, path: str):
    """K1 and K2 against the plain version at the shapes ``path`` gives them."""
    from rgbd_gan_tpu_torch.ops import bilinear

    b, h, w, c, n = (BILINEAR_SHAPES[path][k] for k in "BHWCN")
    g = torch.Generator(device="cuda").manual_seed(0)
    img = torch.rand(b, h, w, c, generator=g, device="cuda")
    # in-bounds, out-of-bounds and integer points
    u = torch.rand(b, n, generator=g, device="cuda") * 1.4 * (h - 1) - 0.2 * (h - 1)
    v = torch.rand(b, n, generator=g, device="cuda") * 1.4 * (w - 1) - 0.2 * (w - 1)
    u[:, ::7] = torch.floor(u[:, ::7])
    v[:, ::5] = torch.floor(v[:, ::5])
    cot = torch.randn(b, n, c, generator=g, device="cuda")
    errs = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for exact in (True, False):
        out = bilinear._fwd(img, u, v, exact)
        torch.cuda.synchronize()
        ref = bilinear.bilinear_gather_reference(img, u, v, exact)
        torch.cuda.synchronize()
        e_fwd = (out - ref).abs().max().item()
        dimg, du, dv = bilinear._bwd(img, u, v, cot, exact)
        torch.cuda.synchronize()
        rdimg, rdu, rdv = bilinear.bilinear_gather_reference_vjp(img, u, v, cot, exact)
        torch.cuda.synchronize()
        e_dimg = (dimg - rdimg).abs().max().item()
        dimg_ok = torch.allclose(dimg, rdimg, rtol=DIMG_RTOL, atol=DIMG_ATOL)
        e_du = (du - rdu).abs().max().item()
        e_dv = (dv - rdv).abs().max().item()
        calls = {
            "fwd": lambda: bilinear._fwd(img, u, v, exact),
            "fwd_plain": lambda: bilinear.bilinear_gather_reference(img, u, v, exact),
            "bwd": lambda: bilinear._bwd(img, u, v, cot, exact),
            "bwd_plain": lambda: bilinear.bilinear_gather_reference_vjp(img, u, v, cot, exact),
        }
        ms = {k: _time_ms(torch, fn) for k, fn in calls.items()}
        if exact:
            # the main path runs exact mode; device time where the profiler has it
            times = {k: (dev if dev is not None else wall) for k, (dev, wall) in ms.items()}
        fields = {}
        for k, (dev, wall) in ms.items():
            fields[f"{k}_device_ms"] = "none" if dev is None else f"{dev:.4f}"
            fields[f"{k}_wall_ms"] = f"{wall:.4f}"
        log(
            "kernels", shapes=path, B=b, H=h, W=w, N=n, exact=exact, fwd_max_abs_err=f"{e_fwd:.3e}", dimg_max_abs_err=f"{e_dimg:.3e}",
            du_max_abs_err=f"{e_du:.3e}", dv_max_abs_err=f"{e_dv:.3e}", **fields,
        )
        if not (e_fwd <= FWD_ATOL and dimg_ok and e_du <= DUV_ATOL and e_dv <= DUV_ATOL):
            raise AssertionError(f"kernel parity failed ({path} shapes, exact={exact})")
        errs["fwd"] = max(errs["fwd"], e_fwd)
        errs["bwd"] = max(errs["bwd"], e_dimg, e_du, e_dv)
    # least time for the same work: every point of this run's data is read
    # (u, v) and written (out, or du and dv); the image is read once, and the
    # backward also reads the cotangent and writes d img
    fwd_bytes = 4 * (img.numel() + u.numel() + v.numel() + b * n * c)
    bwd_bytes = 4 * (2 * img.numel() + 2 * (u.numel() + v.numel()) + b * n * c)
    in_bounds = int(((u >= 0) & (u < h - 1) & (v >= 0) & (v < w - 1)).sum())
    bounds = {
        "fwd": _bound(fwd_bytes, in_bounds * c * 2 * 4),  # exact mode: 2 corners, 2 weights
        "bwd": _bound(bwd_bytes, in_bounds * c * 2 * 6),
    }
    log("kernel_bounds", shapes=path, fwd=json.dumps(bounds["fwd"]), bwd=json.dumps(bounds["bwd"]),
        in_bounds_points=in_bounds, of=b * n)
    return errs, times, bounds


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
    log("lift_bounds", fwd=json.dumps(fwd), bwd=json.dumps(bwd), valid_cells=valid, of=b * n)

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
    failed = []
    for r in records:
        allowed = CONV_F32_REL * r["max_abs_y"]
        err = r["max_abs_err"] if r["dtype"] == "float32" else r["max_excess_over_one_bf16_ulp"]
        log("conv", **{k: (json.dumps(v) if isinstance(v, list) else v) for k, v in r.items()}, allowed=allowed)
        if not err <= allowed:
            failed.append((r["dtype"], r["shape"], err, allowed))
    log("conv_path", launches=json.dumps(launches), kernel_calls=sum(r["kernel_calls"] for r in records))
    if failed:
        raise AssertionError(f"K6 parity failed: {failed}")
    n = launches["conv"]["conv3x3"]
    if n == 0 or n != sum(r["kernel_calls"] for r in records):
        raise AssertionError(f"K6 path: {n} launches for {sum(r['kernel_calls'] for r in records)} calls")
    if any(launches["bilinear"].values()) or any(launches["trilinear"].values()):
        raise AssertionError(f"K6 path launched other kernels: {launches}")
    return records, n


def _small_config():
    from rgbd_gan_tpu_torch.core.config import Config

    cfg = dict(FFHQ_STYLEGAN_OCCLUSION)
    cfg.update(ch=32, batchsize=4, stage_interval="0,0,0,0,0,0,0", max_stage=7, gather_mode="pallas")
    return Config(cfg)


def phase_step_parity(torch):
    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
    from rgbd_gan_tpu_torch.models.generators import stylegan_make_hidden
    from rgbd_gan_tpu_torch.train.trainer import Trainer

    config = _small_config()
    data = synthetic_dataset(8, 32)
    # the same draws for both devices, made on the CPU
    g = torch.Generator().manual_seed(1)
    z = torch.cat([stylegan_make_hidden(g, 2, config.ch)] * 2)
    losses = {}
    for device in ("cpu", "cuda"):
        trainer = Trainer(config, dataset=data, seed=0, device=device)  # same weights
        thetas6 = trainer.prior.sample(torch.Generator().manual_seed(2), 4, "cpu")
        spec = trainer._spec_for(0, 6)  # 32 px, rotate and occlusion on
        x = torch.from_numpy(data[:4].transpose(0, 2, 3, 1).copy()).to(device)
        _, metrics = trainer._step(spec)(trainer.state, x, 0.0, z=z, thetas6=thetas6)
        losses[device] = {k: float(v) for k, v in metrics.items() if "loss" in k}
    worst = 0.0
    for k, a in losses["cpu"].items():
        b = losses["cuda"][k]
        worst = max(worst, abs(a - b))
        if not (math.isfinite(b) and abs(a - b) <= STEP_ATOL + STEP_RTOL * abs(a)):
            raise AssertionError(f"step parity failed for {k}: cpu {a} vs cuda {b}")
    log("step_parity", cpu=json.dumps(losses["cpu"]), cuda=json.dumps(losses["cuda"]),
        max_abs_diff=f"{worst:.3e}", rtol=STEP_RTOL, atol=STEP_ATOL)


def phase_deepvoxels_step_parity(torch):
    from rgbd_gan_tpu_torch.core.config import Config
    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
    from rgbd_gan_tpu_torch.models.deepvoxels import deepvoxels_make_hidden
    from rgbd_gan_tpu_torch.ops import trilinear
    from rgbd_gan_tpu_torch.train.trainer import Trainer

    data = synthetic_dataset(4, 64)
    g = torch.Generator().manual_seed(3)
    ch, batch = 32, 2
    draws = {k: deepvoxels_make_hidden(g, batch, ch) for k in ("z", "z2", "z_d", "z2_d")}
    draws["z"][1], draws["z2"][1] = draws["z"][0], draws["z2"][0]  # the paired latents
    for occlusion_type in ("accumulative", "deepvoxels"):
        # float32 operands on both devices: the CPU runs the plain lift (full),
        # the card the windowed kernels, equal under the span invariant
        config = Config(dict(DEEPVOXELS_SHAPENET_CAR, ch=ch, batchsize=batch, occlusion_type=occlusion_type,
                             lift_mode="pallas_win_f32"))
        losses, modes, params = {}, {}, {}
        trilinear.reset_launches()
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
        log_fields = dict(
            occlusion_type=occlusion_type, lift_modes=json.dumps(modes), cpu=json.dumps(losses["cpu"]),
            cuda=json.dumps(losses["cuda"]), launches=json.dumps(trilinear.launches),
            share_of_generator_elements_apart=f"{apart:.5f}",
        )
        for k, a in losses["cpu"].items():
            b = losses["cuda"][k]
            after_update = k == "dis/loss_adv"
            if not after_update:
                worst = max(worst, abs(a - b))
            tol = DIS_AFTER_UPDATE_ATOL if after_update else STEP_ATOL + STEP_RTOL * abs(a)
            if not (math.isfinite(b) and abs(a - b) <= tol):
                log("step_parity_deepvoxels", **log_fields)
                raise AssertionError(f"deepvoxels step parity failed for {k}: cpu {a} vs cuda {b}")
        log("step_parity_deepvoxels", **log_fields, max_abs_diff_before_update=f"{worst:.3e}", rtol=STEP_RTOL,
            atol=STEP_ATOL, dis_after_update_abs_diff=f"{abs(losses['cpu']['dis/loss_adv'] - losses['cuda']['dis/loss_adv']):.3e}",
            dis_after_update_atol=DIS_AFTER_UPDATE_ATOL)
        if apart > MAX_SHARE_APART:
            raise AssertionError(f"deepvoxels step parity: {apart:.4f} of the generator's elements ended apart")
        if trilinear.launches != {"fwd": 0, "bwd": 0, "fwd_win": 2, "bwd_win": 1}:
            raise AssertionError(f"deepvoxels step parity: lift launches {trilinear.launches}")


def _drive(torch, has_yaml: bool, phase: str, values: dict, image_px: int, name: str):
    """Run ``values`` through the CLI's run function on 64 synthetic images
    with every kernel's launch count zeroed just before and read just after;
    returns the launch counts of the bilinear and the trilinear kernels
    (K6, wired into no model, must not launch)."""
    from rgbd_gan_tpu_torch.cli import train as cli
    from rgbd_gan_tpu_torch.core.config import Config
    from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset

    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        data_dir = os.path.join(work, "data")
        os.makedirs(data_dir)
        np.save(os.path.join(data_dir, "images.npy"), synthetic_dataset(64, image_px))
        values = dict(values, dataset_path=data_dir, image_path="unused/*.png", out=os.path.join(work, "out"))
        iterations, batch = values["iteration"], values["batchsize"]
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
        if name != "ffhq_stylegan_occlusion":
            fields.update(lift_launches=json.dumps(lift_launches), lift_mode=trainer.state.gen.lift_mode)
        log(phase, **fields)
        if trainer.state.iteration != iterations or not finite or len(rows) != iterations:
            raise AssertionError(f"{phase}: expected {iterations} iterations with finite losses")
        if launches != {"fwd": iterations, "bwd": iterations}:
            raise AssertionError(f"{phase}: bilinear kernel launches {launches} != {iterations} each")
        if counts["conv"]["conv3x3"]:
            raise AssertionError(f"{phase}: K6 is wired into no model, yet launched {counts['conv']}")
        if "Generator_latest.npz" not in out_files or "Discriminator_latest.npz" not in out_files:
            raise AssertionError(f"{phase}: snapshot missing")
        return launches, lift_launches, out_files
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_main_path(torch, has_yaml: bool):
    launches, lift_launches, _ = _drive(
        torch, has_yaml, "main_path", FFHQ_STYLEGAN_OCCLUSION, 128, "ffhq_stylegan_occlusion")
    if any(lift_launches.values()):
        raise AssertionError(f"main path: the StyleGAN step launched the lift {lift_launches}")
    return launches


def phase_deepvoxels_paths(torch, has_yaml: bool):
    """The DeepVoxels main path (the yml's default lift: bf16, windowed) and
    2 iterations with ``lift_mode: pallas_f32`` (the full kernels)."""
    bil_win, win, files = _drive(
        torch, has_yaml, "main_path_deepvoxels", DEEPVOXELS_SHAPENET_CAR, 64, "deepvoxels_shapenet_car")
    # per iteration: the G phase lifts forward and backward, the D phase forward only
    if win != {"fwd": 0, "bwd": 0, "fwd_win": 10, "bwd_win": 5}:
        raise AssertionError(f"deepvoxels main path: lift launches {win}")
    if "Map_latest.npz" not in files:
        raise AssertionError("deepvoxels main path: Map_latest.npz missing")
    bil_full, full, _ = _drive(
        torch, has_yaml, "main_path_deepvoxels_f32", dict(DEEPVOXELS_SHAPENET_CAR, lift_mode="pallas_f32", iteration=2),
        64, "deepvoxels_shapenet_car_f32")
    if full != {"fwd": 4, "bwd": 2, "fwd_win": 0, "bwd_win": 0}:
        raise AssertionError(f"deepvoxels pallas_f32 path: lift launches {full}")
    lift = {**{k: win[k] for k in ("fwd_win", "bwd_win")}, **{k: full[k] for k in ("fwd", "bwd")}}
    return lift, bil_win, bil_full


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

    has_yaml = phase_device(torch)
    bilinear_parity = {path: phase_kernels(torch, path) for path in BILINEAR_SHAPES}
    errs, times, bounds = bilinear_parity["stylegan"]
    lift_errs, lift_times, lift_bounds = phase_lift_kernels(torch)
    conv_records, conv_launches = phase_conv(torch)
    phase_step_parity(torch)
    phase_deepvoxels_step_parity(torch)
    by_path = {"stylegan": phase_main_path(torch, has_yaml)}
    lift_launches, by_path["deepvoxels"], by_path["deepvoxels_f32"] = phase_deepvoxels_paths(torch, has_yaml)

    def entry(name, source, replaces, n_launches, err, ms, plain_ms, bound, library_ms=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": library_ms}

    bil, tri = "rgbd_gan_tpu_torch/csrc/bilinear.cu", "rgbd_gan_tpu_torch/csrc/trilinear.cu"
    pallas = "rgbd_gan_tpu/ops/%s_pallas.py:%d"
    kernels = []
    # the bilinear pair runs on every path: `launches` is the sum of the three
    # runs' counts, the other numbers are those at the StyleGAN shapes, and
    # the DeepVoxels shapes' stand beside them
    dv_errs, dv_times, dv_bounds = bilinear_parity["deepvoxels"]
    for key, line in (("fwd", 111), ("bwd", 130)):
        kernels.append(dict(
            entry("bilinear_gather_" + key, bil, pallas % ("bilinear", line),
                  sum(counts[key] for counts in by_path.values()),
                  max(errs[key], dv_errs[key]), times[key], times[key + "_plain"], bounds[key]),
            launches_by_path={path: counts[key] for path, counts in by_path.items()},
            at_deepvoxels_shapes={"max_abs_err": dv_errs[key], "ms": dv_times[key],
                                  "plain_ms": dv_times[key + "_plain"], "bound_ms": dv_bounds[key]["bound_ms"],
                                  "bound_by": dv_bounds[key]["bound_by"]},
        ))
    for key, line in (("fwd", 110), ("bwd", 141), ("fwd_win", 210), ("bwd_win", 240)):
        kernels.append(entry(
            "trilinear_lift_" + key, tri, pallas % ("trilinear", line), lift_launches[key], lift_errs[key],
            lift_times[key], lift_times[key + "_plain"], lift_bounds[key],
            lift_times["library_" + key[:3]],
        ))
    # K6 on its path (the benchmark): the top-level numbers are those of
    # float32 at the first shape, every (dtype, shape) stands beside them
    first = conv_records[0]
    kernels.append(dict(
        entry("conv3x3_bias_lrelu", "rgbd_gan_tpu_torch/csrc/conv3x3.cu", pallas % ("conv", 37), conv_launches,
              first["max_abs_err"], first["ms"], first["plain_ms"], first, first["library_ms"]),
        by_dtype_and_shape=[{k: r[k] for k in (
            "dtype", "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "peak", "max_abs_err",
            "max_abs_y", "rel_err_plain", "rel_err_library", "kernel_tflops", "library_tflops",
        )} for r in conv_records],
    ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
