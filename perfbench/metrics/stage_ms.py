"""Staging: the host time of a call's staging seam (UniformStreamFarm._stage;
a mixed farm's every group's _stage_streams, summed): the chunk through the
farm library's host threads into pinned memory, its pieces' uploads issued,
the stage launch issued. Median a call, ms."""

import statistics


def read(run):
    values = [c["stage"] for c in run.span_calls() if "stage" in c]
    return 1e3 * statistics.median(values) if values else None
