"""Grouping: a mixed farm's host time outside its groups' staging, launches
and emits (MixedStreamFarm.process less every group's _stage_streams, the
_launch_groups call and every group's _finish_emit): the per-stream
conversions and checks, the table of row addresses, the distribution of the
outputs to the streams. Median a call, ms; nothing for a uniform farm."""

import statistics


def read(run):
    values = [c["call"] - c.get("stage", 0.0) - c.get("launch", 0.0) - c["finish"]
              for c in run.span_calls() if "finish" in c]
    return 1e3 * statistics.median(values) if values else None
