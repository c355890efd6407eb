"""``kernels.ms``: device ms a step of the port's hand-written kernels (``bilinear_*``, ``lift_*``), over the profiled steps (rank 0 on several cards).
Silent where nothing of the layer ran."""


def read(run):
    return run.layer_ms_per_step("kernels")
