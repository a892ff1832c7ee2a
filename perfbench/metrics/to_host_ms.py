"""Copy out: the host time of a call's _to_host seam (a mixed farm's every
group's, summed): farm_unstage_kernel issued, the download into the result
pool's pinned buffer and the wait for it, which waits for the launches too.
Median a call, ms."""

import statistics


def read(run):
    values = [c["to_host"] for c in run.span_calls() if "to_host" in c]
    return 1e3 * statistics.median(values) if values else None
