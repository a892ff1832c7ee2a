"""Scan issue: ScanProgram's construction (validation, allocation, every
launch's arguments), the span crt.scan.build in the port. Median a request,
ms."""

from perfbench.metrics import _rows


def read(run):
    return _rows.median(run, "crt.scan.request", 1e3, "crt.scan.build")
