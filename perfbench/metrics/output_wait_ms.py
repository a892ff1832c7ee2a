"""Copy out: the host blocked until the card has done a call's launches,
unstage and download, the span crt.farm.to_host.wait in the port. Median a
call, ms, groups summed."""

from perfbench.metrics import _rows


def read(run):
    return _rows.median(run, "crt.farm.call", 1e3, "crt.farm.to_host.wait")
