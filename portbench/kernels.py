"""What the per-layer readers take from a traced window: the idle share,
device time by the host operation that launched it, and counts of host
operations."""

from __future__ import annotations


def idle_pct(ctx) -> float | None:
    """The traced window's share with no kernel or copy on the card."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def device_ms_per_unit(ctx, host_ops) -> float | None:
    """Device milliseconds launched from inside ``host_ops``, per unit
    (fit, request) of the window traced with the host's operations; None
    where nothing ran under them."""
    tr = ctx.get("host_trace")
    if tr is None or not ctx.get("host_traced_units"):
        return None
    t = tr.device_time_under(host_ops)
    if t <= 0:
        return None
    return 1e3 * t / ctx["host_traced_units"]


def host_ops_per_unit(ctx, host_ops) -> float | None:
    """Calls of the host operations ``host_ops`` per unit (fit, request) of
    the window traced with the host's operations; None where none ran."""
    tr = ctx.get("host_trace")
    if tr is None or not ctx.get("host_traced_units"):
        return None
    k = tr.host_op_count(host_ops)
    return k / ctx["host_traced_units"] if k else None
