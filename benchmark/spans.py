"""Readings of the program's own spans in a profile of the traced unit.

The program opens ``torch.profiler.record_function`` ranges at its layer
boundaries while a profiler records (``mpinets_torch/utils/trace.py``):
``rollout.policy``, ``rollout.env``, ``policy.tail``, ``train.batch``,
``train.step`` and one ``wait.h2d.<site>`` a blocking copy from the host to
the card. They share the profile's clock with the device's operations, so
each idle gap of the device is put down to the span the host was in when
the gap began, and each span's device time is that of the operations
launched while the host was inside it. A parent commit without spans reads
None everywhere here.
"""

from __future__ import annotations

import bisect

from benchmark import trace

WAIT = "wait."


def ranges(tr: trace.Trace, name: str):
    """Sorted (start, end) of the host ranges named ``name`` that start in
    the window."""
    lo, hi = tr.window
    return sorted((s, e) for n, s, e in tr.host if n == name and lo <= s <= hi)


def waits(tr: trace.Trace) -> int:
    """Number of ``wait.*`` spans that start in the window."""
    lo, hi = tr.window
    return sum(1 for n, s, _ in tr.host if n.startswith(WAIT) and lo <= s <= hi)


def gaps(tr: trace.Trace):
    """(start, length) of each interval of the window in which no device
    operation ran (between the union's intervals, as ``trace.idle_gaps``),
    in microseconds."""
    lo, hi = tr.window
    out, at = [], lo
    for s, e in sorted(trace.clip([(s, e) for _, s, e in tr.device], lo, hi)):
        if s > at:
            out.append((at, s - at))
        at = max(at, e)
    if hi > at:
        out.append((at, hi - at))
    return out


def idle_us_in(tr: trace.Trace, name: str):
    """Device idle microseconds in the gaps that begin inside a ``name``
    span (whatever is nested in it, such as a ``wait.*``); None where the
    window has no such span."""
    spans = ranges(tr, name)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    total = 0.0
    for at, length in gaps(tr):
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at < spans[i][1]:
            total += length
    return total


def device_us_under(prof, name: str):
    """Device microseconds of the operations launched while the host was
    inside a ``name`` span, on the span's thread; None where the profile
    has no such span. Each device operation is matched to its launch call
    (a runtime call, ``cu*``) by the correlation id they share: the hand
    kernels are launched through ``ctypes`` with no torch op around them,
    and the profile does not attach them to the range open at their
    launch."""
    from torch.autograd import DeviceType

    events = prof.events()
    by_thread = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name == name:
            by_thread.setdefault(e.thread, []).append((e.time_range.start, e.time_range.end))
    if not by_thread:
        return None
    for spans in by_thread.values():
        spans.sort()
    launched = {e.id: (e.thread, e.time_range.start) for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    total = 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        thread, at = launched.get(e.id, (None, None))
        spans = by_thread.get(thread)
        if not spans:
            continue
        i = bisect.bisect_right(spans, (at, float("inf"))) - 1
        if i >= 0 and at <= spans[i][1]:
            total += e.time_range.end - e.time_range.start
    return total


def per_step_ms(us, ctx):
    """Microseconds of the traced unit -> milliseconds a policy step."""
    if us is None or not ctx["steps"]:
        return None
    return us / 1e3 / ctx["steps"]


def waits_per_step(ctx, enclosing: str):
    """``wait.*`` spans a policy step; None where the program opened no
    ``enclosing`` span (a program without spans), so that a program with
    spans and no waits reads 0."""
    tr = ctx["trace"]
    if not ranges(tr, enclosing) or not ctx["steps"]:
        return None
    return waits(tr) / ctx["steps"]
