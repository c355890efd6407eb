"""From profiler records to layers, busy time and the breakdown, on
records made by hand."""

from __future__ import annotations

import pytest

from benchmark import trace


def test_union_and_intervals():
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert trace.union_length(spans) == 12 + 10 + 1
    assert trace.busy_intervals(spans) == [(0, 12), (20, 30), (40, 41)]


@pytest.mark.parametrize("name, ancestors, layer", [
    ("void bilinear_bwd_vec4_kernel<true>", ["aten::copy_"], "kernels"),
    ("void lift_fwd_vec4_kernel<false, true>", [], "kernels"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", ["c10d::allreduce_"], "parallel"),
    ("implicit_convolve_sgemm", ["aten::cudnn_convolution", "aten::_convolution", "aten::convolution",
                                 "aten::_convolution_double_backward", "ConvolutionBackwardBackward0"], "dphase.r1"),
    ("sm80_xmma_dgrad", ["aten::cudnn_convolution_backward", "aten::convolution_backward"], "dense"),
    ("multi_tensor_apply_kernel", ["aten::_foreach_mul_"], "optim"),
    ("vectorized_elementwise_kernel", ["aten::add_"], "other"),
])
def test_layer_of(name, ancestors, layer):
    assert trace.layer_of(name, ancestors) == layer


class _Event:
    def __init__(self, name, device, start, end, corr, linked, thread=1):
        self._v = (name, device, start, end, corr, linked, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def test_device_records_follow_the_launching_operator():
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _Event("entry.step", cpu, 0, 1000, 1, 0),
        _Event("aten::convolution_backward", cpu, 10, 500, 2, 0),
        _Event("aten::cudnn_convolution_backward", cpu, 20, 400, 3, 0),
        _Event("aten::_foreach_add_", cpu, 600, 700, 4, 0),
        _Event("entry.step", cuda, 0, 1000, 50, 0),  # the span's device-side copy: no device work
        _Event("sm80_xmma_dgrad", cuda, 100, 300, 51, 3),
        _Event("multi_tensor_apply_kernel", cuda, 650, 680, 52, 4),
        _Event("entry.nan_sync", cpu, 1000, 1100, 5, 0),
    ]
    records, spans, left_out = trace.device_records(events)
    assert left_out == {"entry.step": 1}
    assert [(r["name"], r["layer"]) for r in records] == [("sm80_xmma_dgrad", "dense"),
                                                          ("multi_tensor_apply_kernel", "optim")]
    assert [s[0] for s in spans] == ["entry.step", "entry.nan_sync"]
    assert trace.layer_seconds(records)["dense"] == pytest.approx(200e-9)
    out = trace.breakdown(records, spans)
    assert out["device_ops"][0] == ["dense:sm80_xmma_dgrad", pytest.approx(200e-9)]
    # idle from the first span's start to the first kernel, and between the two kernels, both inside entry.step
    assert out["idle_gaps"] == [["entry.step", pytest.approx(350e-9)], ["entry.step", pytest.approx(100e-9)]]


def test_annotations_and_the_harness_stop_are_no_device_work():
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _Event("entry.step", cpu, 0, 1000, 1, 0),
        _Event("c10d::allreduce_", cpu, 10, 100, 2, 0),
        _Event("nccl:all_reduce", cpu, 20, 90, 6, 0),
        _Event("entry.stop", cpu, 1000, 1400, 3, 0),
        _Event("c10d::allreduce_", cpu, 1010, 1100, 4, 0),
        # NCCL's kernel and the device-side copy of its ``nccl:all_reduce`` annotation, alike in time
        _Event("ncclDevKernel_AllReduce_Sum_f32_RING_LL", cuda, 100, 600, 50, 6),
        _Event("nccl:all_reduce", cuda, 100, 600, 51, 2),
        _Event("Memcpy HtoD (Pageable -> Device)", cuda, 950, 1010, 52, 2),
        # the ranks' "the window is over" flag: launched under entry.stop, it waits for the slowest rank
        _Event("ncclDevKernel_AllReduce_Max_f32_RING_LL", cuda, 1100, 1390, 53, 4),
        _Event("aten::add_", cpu, 1450, 1460, 5, 0),
        _Event("vectorized_elementwise_kernel", cuda, 1500, 1600, 54, 5),
    ]
    records, spans, left_out = trace.device_records(events)
    assert left_out == {"nccl:all_reduce": 1}
    assert [r["name"] for r in records] == ["ncclDevKernel_AllReduce_Sum_f32_RING_LL",
                                            "Memcpy HtoD (Pageable -> Device)", "vectorized_elementwise_kernel"]
    assert trace.layer_seconds(records)["parallel"] == pytest.approx(500e-9)
    assert trace.busy_seconds(records) == pytest.approx(660e-9)
    assert [s[0] for s in spans] == ["entry.step", "entry.stop"]
    # the wait for the slowest rank is idle, named by the harness's span
    assert trace.breakdown(records, spans)["idle_gaps"][0] == ["entry.stop", pytest.approx(490e-9)]
