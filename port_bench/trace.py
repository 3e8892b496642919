"""The traced window: torch.profiler over the window, reduced to the
device's busy time (the union of its kernels, copies and sets), the device
operations that took the most time, and the device's idle time labelled by
what the host was doing (the port's innermost program phase at that
moment, from `utils.phases`; `outside_prove` between jobs).  Totals are
kept in memory; no trace file is written."""

from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Dict, List, Tuple

MARK = "port_bench.mark"
TOP = 10


def start(on_card: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    prof = profile(activities=acts, record_shapes=False, with_stack=False, profile_memory=False)
    prof.start()
    return prof


def mark() -> float:
    """A host event at a known wall-clock time, to place the program's phase
    intervals on the profiler's clock."""
    from torch.profiler import record_function

    t = time.time()
    with record_function(MARK):
        pass
    return t


def short_name(name: str) -> str:
    """A kernel's name without namespaces, return type and parameter list;
    template arguments kept when short.  Copies and sets keep their name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = re.sub(r"\(anonymous namespace\)::|^void ", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    name = name[:cut]
    m = re.match(r"^([^<]*)<(.*)>$", name)
    if m and len(m.group(2)) > 24:
        name = m.group(1) + "<...>"
    return name.split("::")[-1] if "<" not in name else name


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    return int(f()) if f is not None else int(getattr(e, what + "_us")() * 1000)


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def label_gaps(busy: List[Tuple[int, int]], lo: int, hi: int,
               phases: List[Tuple[str, int, int]]) -> Dict[str, float]:
    """Seconds of [lo, hi) outside `busy`, by the shortest phase interval
    that holds each gap's midpoint."""
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    by_len = sorted(phases, key=lambda p: p[2] - p[1])
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) // 2
        name = next((n for n, s, e in by_len if s <= mid < e), "outside_prove")
        out[name] += (b - a) / 1e9
    return dict(out)


def summarize(prof, mark_t: float, intervals, window_s: float) -> dict:
    """Stops the profiler and reduces its events over the window."""
    from torch.autograd import DeviceType

    prof.stop()
    events = prof.profiler.kineto_results.events()
    mark_ns, dev, per_name = None, [], defaultdict(float)
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            a = _ns(e, "start")
            d = _ns(e, "duration")
            dev.append((a, a + d))
            per_name[short_name(e.name())] += d / 1e9
        elif mark_ns is None and e.name() == MARK:
            mark_ns = _ns(e, "start")
    if mark_ns is None:
        raise RuntimeError("the profiler recorded no window mark")
    lo, hi = mark_ns, mark_ns + int(window_s * 1e9)
    busy = [(max(a, lo), min(b, hi)) for a, b in union(dev) if b > lo and a < hi]
    offset = mark_ns - int(mark_t * 1e9)
    phases = [(n, int(a * 1e9) + offset, int(b * 1e9) + offset) for n, a, b in intervals]
    idle = label_gaps(busy, lo, hi, phases)
    top_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    del events
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "device_events": len(dev),
        "breakdown": {"device_ops": [[n, s] for n, s in top_ops],
                      "idle_gaps": [[n, s] for n, s in top_idle]},
    }
