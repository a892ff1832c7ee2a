"""Scan issue: the host time of resample_scan_fused on a card, ScanProgram's
construction and run (every launch queued), without the synchronise.
Median a request, ms."""

import statistics


def read(run):
    values = [c["scan_host"] for c in run.span_calls() if "scan_host" in c]
    return 1e3 * statistics.median(values) if values else None
