"""``optim.ms``: device ms a step under the optimizer's ``aten::_foreach_*`` operators, over the profiled steps (rank 0 on several cards).
Silent where nothing of the layer ran."""


def read(run):
    return run.layer_ms_per_step("optim")
