"""Host-card link: the least time the profiled calls' transfers need, each
call's larger of its int16 input and its int32 output, once, at the link's
published rate in one direction (perfbench/peaks.py), over the seconds in
which a copy between host and card ran in the trace (overlapping copies
counted once). %."""

from perfbench import peaks


def read(run):
    if not run.trace.get("memcpy_s") or run.window.profiled is None:
        return None
    bound = 0.0
    for k in range(*run.window.profiled):
        b = peaks.link_bound_s(run.work(k, taps=False), run.peaks)
        if b is None:
            return None
        bound += b
    return 100.0 * bound / run.trace["memcpy_s"]
