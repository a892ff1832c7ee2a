"""The port's own rows of the window's calls outside its profiled part
(``clownresampler_tpu_torch.utils.profiling.recent_calls``: one row a farm
call or scan request, spans in seconds, counters as counted), and a
quantity's median a call. A port without the recorder gives no rows."""

import statistics


def window_rows(run, kind: str) -> list:
    """The last ``run.window.calls`` rows of ``kind`` less the profiled tail
    (``run.window.profiled``)."""
    from clownresampler_tpu_torch.utils import profiling

    recent = getattr(profiling, "recent_calls", None)
    if recent is None or not run.window.calls:
        return []
    rows = recent(kind, run.window.calls)
    if run.window.profiled is not None:
        first, end = run.window.profiled
        rows = rows[: max(0, len(rows) - (end - first))]
    return rows


def median(run, kind: str, scale: float, *names: str):
    """The median a row of ``names`` summed, times ``scale``, or None with
    no rows."""
    values = [sum(row[n] for n in names) for row in window_rows(run, kind)
              if all(n in row for n in names)]
    return scale * statistics.median(values) if values else None
