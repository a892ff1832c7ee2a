"""Scan issue: ScanProgram.run, every launch of a request queued, the span
crt.scan.run in the port. Median a request, ms."""

from perfbench.metrics import _rows


def read(run):
    return _rows.median(run, "crt.scan.request", 1e3, "crt.scan.run")
