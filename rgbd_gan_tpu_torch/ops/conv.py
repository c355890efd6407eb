"""Fused 3x3 convolution + bias + leaky ReLU (K6): CUDA kernels + plain twin.

Port of :mod:`rgbd_gan_tpu.ops.conv_pallas`. On a CUDA tensor
:func:`conv3x3_bias_lrelu` runs one of two hand-written kernels, chosen by
:func:`route` from the dtype, the channel counts and the alignment of ``x``
(never on a failure): bfloat16 with Cin and Cout multiples of 8 and a
16-byte-aligned ``x`` goes to the tensor-core kernel in
``csrc/conv3x3_tc.cu`` (``wgmma`` fed by TMA), everything else (float32,
whose numbers TF32 would change, and the shapes TMA cannot address) to the
FMA kernel in ``csrc/conv3x3.cu``. On a CPU tensor it runs
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
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import load_library, raise_on

TILE_H = 8  # output rows per block (``conv_pallas.TILE_H``)

# Launches of each kernel since the last reset: "conv3x3" the FMA kernel,
# "conv3x3_tc" the tensor-core kernel; the plain CPU path does not count.
launches = {"conv3x3": 0, "conv3x3_tc": 0}
_LAUNCH_KEY = {"fma": "conv3x3", "tc": "conv3x3_tc"}

_libs = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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


def route(dtype: torch.dtype, cin: int, cout: int, x_ptr: int) -> str:
    """The kernel that takes a call on the card: ``"tc"`` (tensor cores) for
    bfloat16 with Cin and Cout multiples of 8 (TMA's global strides are
    multiples of 16 bytes) and ``x`` at a 16-byte-aligned address, else
    ``"fma"``. The weights and the output the tensor-core kernel reads and
    writes are fresh allocations, aligned by construction."""
    if dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0 and x_ptr % 16 == 0:
        return "tc"
    return "fma"


def _library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    if name not in _libs:
        lib = load_library(name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "conv3x3":
            lib.conv3x3_bias_lrelu.argtypes = [p, p, p, p, i, i, i, i, i, i, f, p]
            lib.conv3x3_bias_lrelu.restype = i
        else:
            lib.conv3x3_bias_lrelu_tc.argtypes = [p, p, p, p, i, i, i, i, i, f, p]
            lib.conv3x3_bias_lrelu_tc.restype = i
        _libs[name] = lib
    return _libs[name]


def conv3x3_bias_lrelu(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, slope: float = 0.2
) -> torch.Tensor:
    """Fused 3x3 SAME conv + bias + leaky ReLU, NHWC / HWIO; K6 on CUDA
    tensors (the kernel :func:`route` picks), the plain version on CPU
    tensors. Forward only."""
    if x.requires_grad or kernel.requires_grad or bias.requires_grad:
        raise ValueError("conv3x3_bias_lrelu is forward only (the Pallas kernel has no gradient): "
                         "pass tensors that do not require grad")
    if x.device.type == "cpu":
        return conv3x3_bias_lrelu_reference(x, kernel, bias, slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return launch(x, kernel, bias, slope)


def launch(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, slope: float = 0.2, which: Optional[str] = None
) -> torch.Tensor:
    """K6 on CUDA tensors: the kernel :func:`route` picks, or ``which``
    ("tc" or "fma"), for measurements only: the benchmark also times the FMA
    kernel on bfloat16, beside the tensor-core kernel in one run."""
    _check(x, kernel, bias)
    b, h, w, cin = x.shape
    cout = kernel.shape[3]
    if b > 65535 or h // TILE_H > 65535:
        raise ValueError(f"batch {b} or height {h} too large for the kernel's grid")
    x, kernel, bias = x.contiguous(), kernel.contiguous(), bias.contiguous()
    chosen = route(x.dtype, cin, cout, x.data_ptr())
    which = which or chosen
    if which not in _LAUNCH_KEY or (which == "tc" and chosen != "tc"):
        raise ValueError(f"K6 kernel {which!r} does not take {x.dtype}, Cin {cin}, Cout {cout}, "
                         f"x at {x.data_ptr():#x}")
    out = torch.empty(b, h, w, cout, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if which == "tc":
            wt = kernel.reshape(9, cin, cout).transpose(1, 2).contiguous()  # (tap, Cout, Cin): K-major
            err = _library("conv3x3_tc").conv3x3_bias_lrelu_tc(
                x.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(),
                b, h, w, cin, cout, float(slope), stream,
            )
        else:
            err = _library("conv3x3").conv3x3_bias_lrelu(
                x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
                b, h, w, cin, cout, int(x.dtype == torch.bfloat16), float(slope), stream,
            )
    raise_on(err, f"conv3x3_bias_lrelu ({which})")
    launches[_LAUNCH_KEY[which]] += 1
    return out
