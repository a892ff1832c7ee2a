"""Host pool: the issuing thread's time spinning for the pool threads'
parts of a call's host copies, the counter pool_wait_ns in the port
(crt_farm_host_stats). Median a call, ms, groups summed."""

from perfbench.metrics import _rows


def read(run):
    return _rows.median(run, "crt.farm.call", 1e-6, "pool_wait_ns")
