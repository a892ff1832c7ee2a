"""Host pool: from each host copy's publication to its last pool thread's
first byte, the counter pool_late_ns in the port (crt_farm_host_stats).
Median a call, ms, groups summed."""

from perfbench.metrics import _rows


def read(run):
    return _rows.median(run, "crt.farm.call", 1e-6, "pool_late_ns")
