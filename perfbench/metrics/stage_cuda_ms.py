"""Staging: the staging's two calls into the CUDA runtime, the spans
crt.farm.stage.wait (crt_farm_sync: the card done with the pinned input)
and crt.farm.stage.kernel (farm_stage_kernel's launch) in the port. With
stage_rows_ms and host_copy_ms they make up the port's staging. Median a
call, ms, groups summed."""

from perfbench.metrics import _rows


def read(run):
    return _rows.median(run, "crt.farm.call", 1e3, "crt.farm.stage.wait",
                        "crt.farm.stage.kernel")
