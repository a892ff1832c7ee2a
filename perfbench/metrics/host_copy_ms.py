"""Staging: the farm library's host copy of a call's chunk into pinned
memory with its pieces' uploads issued, the span crt.farm.stage.host in the
port (crt_farm_host_stage). Median a call, ms, groups summed."""

from perfbench.metrics import _rows


def read(run):
    return _rows.median(run, "crt.farm.call", 1e3, "crt.farm.stage.host")
