"""K6 (the fused 3x3 conv + bias + leaky ReLU) against cuDNN and its plain version.

``python -m rgbd_gan_tpu_torch.tools.bench_conv [--reps N]``

The counterpart of the JAX package's ``tools/bench_conv_pallas.py``: the
same five shapes (the D/G blocks at stages 8-10), the same draws
(``RandomState(0)``: x ``randn``, kernel ``randn * 0.05``, bias
``randn * 0.1``, float32 first and then bfloat16, rounded through
float32), forward only. For each (dtype, shape) it prints one JSON line
with the time and TFLOP/s of three ways to compute the same function on
the card:

- ``kernel``: :func:`rgbd_gan_tpu_torch.ops.conv.conv3x3_bias_lrelu` (K6;
  ``route`` names the kernel it took, "tc" for the tensor cores or "fma",
  and ``launches`` counts each kernel's launches for the record);
- ``library``: ``F.conv2d`` on channels_last views of the NHWC tensors, with
  OIHW weights and the bias, then ``F.leaky_relu(0.2)`` (two calls, one
  figure; a yardstick used nowhere in the port);
- ``plain``: :func:`~rgbd_gan_tpu_torch.ops.conv.conv3x3_bias_lrelu_reference`;

the JAX tool's relative error ``max|y - ref| / max|ref|`` of K6 against the
library and against the plain version, K6's largest absolute error against
the plain version, and the bound: the least time
the card could take, the larger of the FLOPs (2*B*H*W*Cin*Cout*9) over the peak for the dtype and the
bytes (x read once, out written once, weights and bias read once) over the
memory rate. TF32 is off. Times are CUDA-event times of back-to-back calls
after one warm-up call. Then, for each bfloat16 shape, one more line times
the FMA kernel (the route bfloat16 took before the tensor-core kernel, and
still takes where the tensor-core kernel cannot) and the tensor-core kernel
in turns (FMA, tensor cores, tensor cores, FMA), so that their ratio comes
from one card, and gives how far each lies from the plain version beyond
one bf16 ulp. Last, for each float32 shape, one line times the FMA kernel
and cuDNN (TF32 off) in turns (kernel, cuDNN, cuDNN, kernel), with the
TFLOP/s and share of bound of each. It needs a CUDA device and fails
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import conv

SHAPES = [  # (B, H, W, Cin, Cout): D/G block shapes at stages 8-10
    (32, 128, 128, 64, 64),
    (32, 128, 128, 64, 128),
    (32, 64, 64, 128, 128),
    (32, 64, 64, 128, 256),
    (32, 32, 32, 256, 256),
]
DTYPES = (torch.float32, torch.bfloat16)
SLOPE = 0.2
# published peaks of one H100 SXM (dense): HBM bytes/s, and FLOP/s for each operand type
PEAK_BYTES_PER_S = 3.35e12
PEAKS = {
    torch.float32: ("f32 FMA units, TF32 off", 67e12),
    torch.bfloat16: ("bf16 dense tensor cores", 989e12),
}


def bound(shape: Sequence[int], dtype: torch.dtype) -> Dict[str, object]:
    """The least time (ms) the card could take for one call at ``shape``."""
    b, h, w, cin, cout = shape
    size = torch.tensor([], dtype=dtype).element_size()
    flops = 2 * b * h * w * cin * cout * 9
    n_bytes = size * (b * h * w * cin + b * h * w * cout + 9 * cin * cout + cout)
    peak_name, peak = PEAKS[dtype]
    by_ops = 1e3 * flops / peak
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(by_ops, by_bytes), "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "flops": flops, "bytes": n_bytes, "peak": peak_name}


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |t| (8 significant bits)."""
    _, exponent = torch.frexp(t.abs().to(torch.float32))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), exponent - 8)


def excess_over_one_bf16_ulp(y: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """How far ``y`` lies from ``ref`` beyond one bf16 ulp of the larger of
    the two, elementwise (negative where within it)."""
    y, ref = y.float(), ref.float()
    return (y - ref).abs() - bf16_ulp(torch.maximum(y.abs(), ref.abs()))


def cuda_event_ms(fn: Callable[[], object], reps: int) -> float:
    """ms per call between CUDA events around ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def library_call(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor):
    """cuDNN conv + bias, then leaky ReLU, on channels_last views; returns a
    function of no arguments giving the NHWC result."""
    x_nchw = x.permute(0, 3, 1, 2)  # a channels_last view of the NHWC tensor
    w_oihw = kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.leaky_relu(F.conv2d(x_nchw, w_oihw, bias, padding=1), SLOPE).permute(0, 2, 3, 1)


def _draws(rng: np.random.RandomState, shape: Sequence[int], dtype: torch.dtype):
    """x ``randn``, kernel ``randn * 0.05``, bias ``randn * 0.1`` on the
    card, rounded through float32 to ``dtype``."""
    b, h, w, cin, cout = shape
    arrays = (rng.randn(b, h, w, cin), rng.randn(3, 3, cin, cout) * 0.05, rng.randn(cout) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to("cuda", dtype) for a in arrays]


def measure(reps: int = 10) -> List[Dict[str, object]]:
    """One record per (dtype, shape), in the JAX tool's order, each function
    timed over ``reps`` calls. Each record counts the calls it made to K6 in
    ``kernel_calls``."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_conv measures only on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    records = []
    for dtype in DTYPES:
        for shape in SHAPES:
            b, h, w, cin, cout = shape
            x, k, bias = _draws(rng, shape, dtype)
            calls = [0]

            def kernel():
                calls[0] += 1
                return conv.conv3x3_bias_lrelu(x, k, bias, SLOPE)

            def plain():
                return conv.conv3x3_bias_lrelu_reference(x, k, bias, SLOPE)

            library = library_call(x, k, bias)
            before = dict(conv.launches)
            y, ref, lib = kernel().float(), plain().float(), library().float()
            diff = (y - ref).abs()
            ref_max = ref.abs().max().item()
            rec = {
                "dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
                "route": conv.route(dtype, cin, cout, x.data_ptr()),
                "max_abs_err": diff.max().item(), "max_abs_y": ref_max,
                "rel_err_plain": diff.max().item() / (ref_max + 1e-6),
                "rel_err_library": (y - lib).abs().max().item() / (lib.abs().max().item() + 1e-6),
                **bound(shape, dtype),
            }
            if dtype == torch.bfloat16:  # how far K6 and the plain version lie apart beyond one bf16 ulp
                excess = excess_over_one_bf16_ulp(y, ref)
                rec["max_excess_over_one_bf16_ulp"] = max(excess.max().item(), 0.0)
                rec["n_beyond_one_bf16_ulp"] = int((excess > 0).sum())
                del excess
            del y, ref, lib, diff
            for name, fn in (("kernel", kernel), ("library", library), ("plain", plain)):
                ms = cuda_event_ms(fn, reps)
                rec[f"{name}_ms" if name != "kernel" else "ms"] = ms
                rec[f"{name}_tflops"] = rec["flops"] / ms / 1e9
            rec["kernel_calls"] = calls[0]
            rec["launches"] = {key: n - before[key] for key, n in conv.launches.items()}
            records.append(rec)
            del x, k, bias
    return records


def compare_fma_and_tc(reps: int = 10) -> List[Dict[str, object]]:
    """For each shape in bfloat16 (draws of the same laws as in
    :func:`measure`): the FMA kernel and the tensor-core kernel timed in
    turns, FMA, tensor cores, tensor cores, FMA, ``reps`` calls each time;
    ms of each kernel is the mean of its two turns. Beside: their largest
    absolute difference, ``max|ref|`` of the plain version and, for each
    kernel, its largest excess over one bf16 ulp against the plain version
    (``*_max_excess_over_one_bf16_ulp``, 0 when within it)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_conv measures only on a CUDA device")
    rng = np.random.RandomState(1)
    records = []
    for shape in SHAPES:
        x, k, bias = _draws(rng, shape, torch.bfloat16)
        calls = {which: (lambda which=which: conv.launch(x, k, bias, SLOPE, which)) for which in ("fma", "tc")}
        ys = {which: call().float() for which, call in calls.items()}
        ref = conv.conv3x3_bias_lrelu_reference(x, k, bias, SLOPE).float()
        checks = {f"{which}_max_excess_over_one_bf16_ulp": max(excess_over_one_bf16_ulp(y, ref).max().item(), 0.0)
                  for which, y in ys.items()}
        checks["max_abs_y"] = ref.abs().max().item()
        diff = (ys["fma"] - ys["tc"]).abs().max().item()
        del ys, ref
        turns = [(which, cuda_event_ms(calls[which], reps)) for which in ("fma", "tc", "tc", "fma")]
        ms = {which: sum(t for w_, t in turns if w_ == which) / 2 for which in ("fma", "tc")}
        records.append({
            "dtype": "bfloat16", "shape": list(shape), "fma_ms": ms["fma"], "tc_ms": ms["tc"],
            "fma_over_tc": ms["fma"] / ms["tc"], "turns_ms": [t for _, t in turns],
            "max_abs_diff_fma_tc": diff, **checks,
        })
        del x, k, bias
    return records


def compare_f32_with_library(reps: int = 10) -> List[Dict[str, object]]:
    """For each shape in float32 (draws of the same laws as in
    :func:`measure`): K6's FMA kernel and cuDNN conv + leaky ReLU (TF32 off)
    timed in turns, kernel, cuDNN, cuDNN, kernel, ``reps`` calls each time;
    ms of each is the mean of its two turns. Beside: the TFLOP/s and share
    of bound of each, and the kernel's largest absolute error against the
    plain version with ``max|ref|``."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_conv measures only on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(2)
    records = []
    for shape in SHAPES:
        x, k, bias = _draws(rng, shape, torch.float32)
        calls = {"fma": lambda: conv.launch(x, k, bias, SLOPE, "fma"), "cudnn": library_call(x, k, bias)}
        y = calls["fma"]()
        ref = conv.conv3x3_bias_lrelu_reference(x, k, bias, SLOPE)
        checks = {"max_abs_err": (y - ref).abs().max().item(), "max_abs_y": ref.abs().max().item()}
        del y, ref
        turns = [(which, cuda_event_ms(calls[which], reps)) for which in ("fma", "cudnn", "cudnn", "fma")]
        ms = {which: sum(t for w_, t in turns if w_ == which) / 2 for which in calls}
        rec = {"dtype": "float32", "shape": list(shape), **bound(shape, torch.float32)}
        for which in calls:
            rec[f"{which}_ms"] = ms[which]
            rec[f"{which}_tflops"] = rec["flops"] / ms[which] / 1e9
            rec[f"{which}_share_of_bound"] = rec["bound_ms"] / ms[which]
        rec.update(fma_over_cudnn=ms["fma"] / ms["cudnn"], turns_ms=[t for _, t in turns], **checks)
        records.append(rec)
        del x, k, bias
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=10, help="timed calls per function")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_conv: no CUDA device; this tool measures only on a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    for rec in measure(reps=args.reps) + compare_fma_and_tc(reps=args.reps) + compare_f32_with_library(args.reps):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
