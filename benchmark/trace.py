"""Reduction of a ``torch.profiler`` trace to the numbers the per-layer
metrics read.

After ``chip_smoke.py::profile_rollout`` (kernel time by name, the busy
share) and ``::profile_train_layers`` (device time of the kernels launched
under an autograd node, its children's included), frozen here; the busy time is
the union of the device's operation intervals, not their sum, so that
overlapping operations count once.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Tuple

#: Host calls that launch work on the device; a graph launch counts once.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")


class Trace(NamedTuple):
    """The events of one traced window, times in microseconds."""

    device: List[Tuple[str, float, float]]   # every device operation (kernel, copy, set)
    host: List[Tuple[str, float, float]]     # host ops and ranges, not runtime calls
    launches: int                             # host launch calls
    window: Tuple[float, float]               # the window's range on the same clock


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_us(trace: Trace) -> float:
    lo, hi = trace.window
    return union_us(clip([(s, e) for _, s, e in trace.device], lo, hi))


def idle_share(trace: Trace) -> float:
    lo, hi = trace.window
    return 1.0 - busy_us(trace) / (hi - lo)


def device_us_by_name(trace: Trace) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, s, e in trace.device:
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def kernel_us(trace: Trace, match) -> float:
    """Device time of the operations whose name ``match`` accepts."""
    return sum(e - s for name, s, e in trace.device if match(name))


def idle_gaps(trace: Trace, top=10, longest=400):
    """The device's idle gaps inside the window, labelled by the innermost
    host op running when each began; the ``longest`` gaps, summed by label,
    the ``top`` labels. -> [(label, seconds)]."""
    lo, hi = trace.window
    merged = []
    for s, e in sorted(clip([(s, e) for _, s, e in trace.device], lo, hi)):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    edges = [lo] + [x for m in merged for x in m] + [hi]
    gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    host = sorted(trace.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    sums: Dict[str, float] = {}
    for length, at in gaps[:longest]:
        i = bisect.bisect_right(starts, at)
        label = "host between ops (Python)"
        best = None
        for name, s, e in reversed(host[max(0, i - 64):i]):
            if e >= at and (best is None or s > best[1]):
                best = (name, s)
        if best is not None:
            label = best[0]
        sums[label] = sums.get(label, 0.0) + length / 1e6
    return sorted(sums.items(), key=lambda kv: -kv[1])[:top]


def collect(prof, window_name: str) -> Trace:
    """The device operations, host ops and launch calls of a finished
    profile, and the range of the ``record_function(window_name)`` that
    marks the window."""
    from torch.autograd import DeviceType

    device, host, launches, window = [], [], 0, None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append((e.name, s, t))
        elif e.name == window_name:
            window = (s, t)
        elif e.name in LAUNCH_CALLS:
            launches += 1
        elif not e.name.startswith(("cuda", "cu")):
            host.append((e.name, s, t))
    if window is None:
        raise RuntimeError(f"the profile has no range {window_name!r}")
    return Trace(device, host, launches, window)


def breakdown(trace: Trace, top=10):
    """The ``breakdown`` of a result line: the device operations that took
    most time, and the longest idle gaps by what the host was doing."""
    ops = sorted(device_us_by_name(trace).items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:120], us / 1e6] for name, us in ops],
            "idle_gaps": [[name[:120], s] for name, s in idle_gaps(trace, top)]}


#: The profiler's name of an autograd node's backward, before the node's name.
NODE = "autograd::engine::evaluate_function: "


def kernel_us_under_node(prof, node: str):
    """Device time of the kernels launched under autograd's ``node``
    backward (not nested in another node), its children's included, after
    ``chip_smoke.py::profile_train_layers``; None where the profile
    attributes no kernel to it."""
    from torch.autograd import DeviceType

    def kernel_us_of(e):
        return (sum(k.duration for k in e.kernels if k.name != e.name)
                + sum(kernel_us_of(c) for c in e.cpu_children))

    def nested(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            if e.name.startswith(NODE):
                return True
        return False

    total, found = 0.0, False
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name == NODE + node and not nested(e):
            found = True
            total += kernel_us_of(e)
    return total if found and total > 0 else None


def unit_idle_share(ctx):
    """1 - the traced unit's device busy time over the time the same unit
    took untraced (``ctx["unit_s"]``), in %; None where there is nothing to
    read. The profiler slows the host's launches, so the traced window's
    own length would count the tracer's cost as idle."""
    tr = ctx["trace"]
    if not tr.device or not ctx["unit_s"]:
        return None
    return 100.0 * (1.0 - busy_us(tr) / 1e6 / ctx["unit_s"])
