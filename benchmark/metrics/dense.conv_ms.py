"""``dense.conv_ms``: device ms a step under ``aten::convolution`` and ``aten::convolution_backward``, none of R1's double backward, over the profiled steps (rank 0 on several cards).
Silent where nothing of the layer ran."""


def read(run):
    return run.layer_ms_per_step("dense")
