"""What several metric readers (``metrics/<name>.py``) compute alike. A
reader applies to the cells that BENCHMARK.json's ``workloads`` list for
its metric, and returns None where it finds nothing to read."""
from __future__ import annotations

from portbench.harness import counts


def rate(r):
    """Work (patches or samples) of the window over its seconds."""
    return r.work / r.window_s


def idle_share(r):
    """The share of the traced stretch in which no operation ran on the
    card (the union of the device's kernel, copy and set intervals)."""
    if r.trace is None or r.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])


def mfu(r):
    """Model FLOPs a unit of work (``r.flops_per_work``, counted on the plain
    reference) times the work of the traced stretch over its seconds, as a
    share of the card's dense peak at the configuration's dtype."""
    if r.trace is None or r.trace["busy_s"] <= 0:
        return None
    return 100.0 * r.flops_per_work * r.traced_work / r.trace["window_s"] / counts.PEAK_FLOP_PER_S[
        r.dtype]


def device_ms_under(r, host_ops):
    """Device milliseconds a unit of work of the kernels launched under the
    named host ops and their children."""
    if r.trace is None:
        return None
    seconds = sum(r.trace["host_ops"].get(op, 0.0) for op in host_ops)
    return 1e3 * seconds / r.traced_work if seconds > 0 else None


def device_ms_of_kernels(r, names):
    """Device milliseconds a unit of work of the device operations whose
    name holds any of ``names``."""
    if r.trace is None:
        return None
    seconds = sum(row[1] for row in r.trace["device_ops"] if any(n in row[0] for n in names))
    return 1e3 * seconds / r.traced_work if seconds > 0 else None
