"""Device: the share of the profiled window in which neither a kernel nor a
copy ran on the card (torch.profiler's device activity), %."""


def read(run):
    if not run.trace.get("window_s"):
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
