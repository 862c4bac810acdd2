"""idle_share.<cell kind>: the share (%) of the traced window in which no
operation ran on the device: one minus the union of the device
operations' intervals in the profiler's trace over the window's length.
The window holds whole requests only."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
