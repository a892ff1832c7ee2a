"""Staging: the host's own pass over a farm call's streams before the farm
library's copy, the span crt.farm.stage.rows in the port (a mixed farm's
per-stream conversion and table of row addresses, a group at a time). Median
a call, ms, groups summed."""

from perfbench.metrics import _rows


def read(run):
    return _rows.median(run, "crt.farm.call", 1e3, "crt.farm.stage.rows")
