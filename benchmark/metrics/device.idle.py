"""``device.idle``: the share (%) of the profiled sub-window's wall time in
which no operation ran on the device (1 - the union of the kernels'
intervals / the sub-window), the busy time averaged over the cards."""


def read(run):
    if not run.profiled_steps or run.profiled_s <= 0 or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.profiled_s)
