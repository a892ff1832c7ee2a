"""Scan issue: the kernel launches a request queued, the counter
scan_launches of the port's crt.scan.request row (1 where one launch walks
every step; a port without the counter gives nothing). Median a request,
launches."""

from perfbench.metrics import _rows


def read(run):
    return _rows.median(run, "crt.scan.request", 1, "scan_launches")
