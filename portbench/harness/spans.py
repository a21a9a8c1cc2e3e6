"""The program's own spans and counters, for the metric readers that read
them: ``span_table()`` of ``crop2seg_tpu_torch/utils/profiling.py``, taken
after the window from the module the program has already loaded, so that
``harness/program.py`` stays the only module that imports the program. The
table fills only while a profiler runs, so after a ``--trace 1`` run it
holds the traced stretch's units and nothing else. A program without the
table reads None, as does a span or counter it does not have.

A unit here is the program's own counter (``tile.patches``,
``step.samples``), not the harness's count, so that each ratio is taken
where the work happens."""
from __future__ import annotations

import sys

from portbench.harness import readers

MODULE = "crop2seg_tpu_torch.utils.profiling"


def table():
    """The program's span table, or None."""
    read = getattr(sys.modules.get(MODULE), "span_table", None)
    return read() if callable(read) else None


def _units(t, counter):
    return t["counters"].get(counter, 0) if t is not None else 0


def host_ms(r, names, counter, less=(), own=False):
    """Host milliseconds a unit of the spans ``names`` (their self time
    with ``own``), less the whole time of the spans ``less``. None where
    the trace holds no device operation: on the CPU the host does the
    card's work, and a span's host time is not its cost to issue it."""
    t = table()
    n = _units(t, counter)
    rows = [t["spans"][k] for k in names if k in t["spans"]] if n else []
    if r.trace is None or r.trace["busy_s"] <= 0 or not rows:
        return None
    seconds = (sum(row["self_s" if own else "host_s"] for row in rows)
               - sum(t["spans"][k]["host_s"] for k in less if k in t["spans"]))
    return 1e3 * seconds / n


def device_ms(r, names, counter):
    """Device milliseconds a unit of the kernels launched under the spans
    ``names`` on their own thread (the trace summary's ``host_ops``)."""
    n = _units(table(), counter)
    ms = readers.device_ms_under(r, names)
    if ms is None or not n:
        return None
    return ms * r.traced_work / n
