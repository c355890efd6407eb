"""``step.mfu``: model FLOPs of the steps done over the seconds they took,
as a share (%) of the cards' peak in the precision the cell states (f32
with TF32 off: 67 TFLOP/s a card; bf16: 989), over the traced window's
iterations outside the profiled sub-window. The FLOPs a step come from the
configuration's file (every convolution and matmul of the reference step,
counted from the shapes by ``benchmark/flops.py``), as the mean over the
cell's R1 cycle."""


def read(run):
    if not run.steady_iterations or run.steady_s <= 0:
        return None
    return 100.0 * run.flops_per_step * run.steady_iterations / run.steady_s / run.peak_flops
