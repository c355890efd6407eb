"""Fused 3x3 convolution + bias + leaky ReLU (K6): CUDA kernel + plain twin.

Port of :mod:`rgbd_gan_tpu.ops.conv_pallas`. On a CUDA tensor
:func:`conv3x3_bias_lrelu` runs the hand-written kernel in
``csrc/conv3x3.cu``; on a CPU tensor it runs
:func:`conv3x3_bias_lrelu_reference`, the plain PyTorch version of the same
function. A CUDA tensor never falls back to the plain version.

Semantics (those of ``conv_pallas.conv3x3_bias_lrelu``): ``x`` (B, H, W, Cin)
NHWC with ``H % TILE_H == 0``, ``kernel`` (3, 3, Cin, Cout) HWIO, ``bias``
(Cout,), SAME padding, stride 1 -> (B, H, W, Cout) in ``x.dtype``. The nine
taps are summed in float32, the bias added in float32, then
``where(acc >= 0, acc, slope * acc)`` and one cast. Operands are all float32
or all bfloat16; a bfloat16 operand is widened to float32, so each product
is exact. Forward only, like the Pallas kernel: an input that requires grad
is refused.

Weights: K6 takes the JAX layout (HWIO) as it stands, so the same numpy
arrays go to both packages and ``bridge.py`` needs no entry for it. Like the
Pallas function, K6 is wired into no model: its path is the benchmark
``rgbd_gan_tpu_torch.tools.bench_conv``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from ._build import load_library, raise_on

TILE_H = 8  # output rows per block (``conv_pallas.TILE_H``)

# Launches of the kernel since the last reset; the plain CPU path does not count.
launches = {"conv3x3": 0}

_lib = None


def reset_launches() -> None:
    launches["conv3x3"] = 0


def _check(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> None:
    """Refuse what neither the Pallas function nor the kernel takes."""
    if x.dim() != 4:
        raise ValueError(f"expected x (B,H,W,Cin); got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, cin):
        raise ValueError(f"expected kernel (3,3,{cin},Cout); got {tuple(kernel.shape)}")
    cout = kernel.shape[3]
    if tuple(bias.shape) != (cout,):
        raise ValueError(f"expected bias ({cout},); got {tuple(bias.shape)}")
    if h % TILE_H:
        raise ValueError(f"H must be a multiple of TILE_H={TILE_H} (pad H); got H={h}")
    if cin < 1:
        raise ValueError("x needs at least one input channel")
    if x.dtype not in (torch.float32, torch.bfloat16) or kernel.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"x, kernel, bias must be all float32 or all bfloat16; got {x.dtype}, "
                        f"{kernel.dtype}, {bias.dtype}")
    if len({x.device, kernel.device, bias.device}) != 1:
        raise ValueError("x, kernel, bias must be on one device")


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the kernel's reference on the card)
# ---------------------------------------------------------------------------


def conv3x3_bias_lrelu_reference(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, slope: float = 0.2
) -> torch.Tensor:
    """The Pallas formulation: pad, then nine statically shifted
    (B*H*W, Cin) x (Cin, Cout) products in float32, + bias, leaky ReLU."""
    _check(x, kernel, bias)
    b, h, w, cin = x.shape
    cout = kernel.shape[3]
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))  # (B, H+2, W+2, Cin)
    k = kernel.to(torch.float32)
    acc = torch.zeros(b * h * w, cout, dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + h, dx:dx + w, :].reshape(b * h * w, cin) @ k[dy, dx]
    acc += bias.to(torch.float32)
    out = torch.where(acc >= 0, acc, slope * acc)
    return out.reshape(b, h, w, cout).to(x.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/conv3x3.cu``."""
    global _lib
    if _lib is None:
        lib = load_library("conv3x3")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_bias_lrelu.argtypes = [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        lib.conv3x3_bias_lrelu.restype = i
        _lib = lib
    return _lib


def build() -> Path:
    """Build and load the kernel now; returns the shared library's path."""
    return Path(_library()._name)


def conv3x3_bias_lrelu(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, slope: float = 0.2
) -> torch.Tensor:
    """Fused 3x3 SAME conv + bias + leaky ReLU, NHWC / HWIO; K6 on CUDA
    tensors, the plain version on CPU tensors. Forward only."""
    if x.requires_grad or kernel.requires_grad or bias.requires_grad:
        raise ValueError("conv3x3_bias_lrelu is forward only (the Pallas kernel has no gradient): "
                         "pass tensors that do not require grad")
    if x.device.type == "cpu":
        return conv3x3_bias_lrelu_reference(x, kernel, bias, slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, kernel, bias)
    b, h, w, cin = x.shape
    cout = kernel.shape[3]
    if b > 65535 or h // TILE_H > 65535:
        raise ValueError(f"batch {b} or height {h} too large for the kernel's grid")
    x, kernel, bias = x.contiguous(), kernel.contiguous(), bias.contiguous()
    out = torch.empty(b, h, w, cout, dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_bias_lrelu(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, w, cin, cout, int(x.dtype == torch.bfloat16), float(slope), stream,
        )
    raise_on(err, "conv3x3_bias_lrelu")
    launches["conv3x3"] += 1
    return out
