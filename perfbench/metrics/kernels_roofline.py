"""Kernels: the least device time of the profiled calls' work over the summed
device time of every kernel they ran, whatever kernels implement it. The
work of a call or request: its int16 input read once and its produced
frames' int32 output written once over HBM's rate, or 4 int32 operations a
live tap and lane of every produced frame over the int32 rate, whichever is
larger (perfbench/peaks.py). %."""

from perfbench import peaks


def read(run):
    if not run.trace.get("kernel_s") or run.window.profiled is None:
        return None
    bound = 0.0
    for k in range(*run.window.profiled):
        b = peaks.device_bound_s(run.work(k), run.peaks)
        if b is None:
            return None
        bound += b
    return 100.0 * bound / run.trace["kernel_s"]
