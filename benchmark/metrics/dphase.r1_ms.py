"""``dphase.r1_ms``: R1's double backward: device ms a step under ``aten::_convolution_double_backward``, over the profiled steps (rank 0 on several cards).
Silent where nothing of the layer ran."""


def read(run):
    return run.layer_ms_per_step("dphase.r1")
