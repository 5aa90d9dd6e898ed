"""The device trace of a traced section, reduced to what the metrics read.

A copy of the idea of ``josefine_tpu_torch/bench_engine.py`` ``_traced`` /
``_busy_ms`` / ``_kernel_kind`` (commit 2a01ac5), with one repair: the
busy time is the union of the device's intervals, not their sum, which
equals the union only when one stream runs one operation at a time.

The section runs under ``torch.profiler`` with host and card activity.
Host spans the drivers open with :func:`label` name what the host was
doing; an idle gap on the card is charged to the outermost label and the
innermost host operation that cover its middle.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict

import torch

PREFIX = "bench:"
TOP = 10


def label(name: str):
    """A host span in the trace (a no-op outside a profiled section)."""
    return torch.profiler.record_function(PREFIX + name)


def kernel_kind(name: str) -> str:
    """A short name for a device operation: a PyTorch kernel's functor or
    kernel family, else the name's first 60 characters."""
    m = (re.search(r"\w+Functor<[\w, ]*>", name)
         or re.search(r"\w+_kernel_impl(?=\()|\w+Kernel\w*", name))
    return m.group(0) if m else name[:60]


def is_kernel(name: str) -> bool:
    """A device event that is a kernel, not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset"))


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merge intervals into disjoint ones, in order."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(host: list[tuple[float, float, str]], device: list[tuple[float, float, str]],
                  wall_s: float) -> dict:
    """Device busy time (union), kernel count and summed kernel time, the
    device operations that took most time, and the idle time
    by what the host was doing. Times in the profiler's microseconds."""
    busy = union([(a, b) for a, b, _ in device])
    kern = [(a, b) for a, b, n in device if is_kernel(n)]
    by_op: dict[str, float] = defaultdict(float)
    for a, b, n in device:
        by_op[kernel_kind(n)] += (b - a) / 1e6
    starts = [a for a, _, _ in host] + [a for a, _, _ in device]
    ends = [b for _, b, _ in host] + [b for _, b, _ in device]
    idle: dict[str, float] = defaultdict(float)
    if starts:
        lo, hi = min(starts), max(ends)
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        labels = sorted((a, b, n[len(PREFIX):]) for a, b, n in host if n.startswith(PREFIX))
        ops = sorted((a, b, n) for a, b, n in host if not n.startswith(PREFIX))
        op_starts = [a for a, _, _ in ops]
        for a, b in gaps:
            mid = (a + b) / 2
            outer = next((n for s, e, n in labels if s <= mid <= e), None)
            i = bisect.bisect_right(op_starts, mid)
            inner = [(e - s, n) for s, e, n in ops[max(0, i - 64):i] if e >= mid]
            name = outer or "no label"
            if inner:
                name += "/" + min(inner)[1]
            idle[name] += (b - a) / 1e6
    busy_s = sum(b - a for a, b in busy) / 1e6
    return {
        "busy_s": busy_s,
        "window_s": wall_s,
        "kernels": len(kern),
        "kernel_s": sum(b - a for a, b in kern) / 1e6,
        "device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda x: -x[1])[:TOP],
    }


class DeviceTrace:
    """Profile a section of the run: ``with DeviceTrace(dev) as t: ...``,
    then ``t.reduce()``. The section's wall time is taken on the host
    clock between two device synchronisations."""

    def __init__(self, device: torch.device):
        self.device = device
        self.wall_s = 0.0
        self._prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.wall_s = time.perf_counter() - self._t
        self._prof.__exit__(*exc)
        return False

    def reduce(self) -> dict:
        from torch.autograd import DeviceType

        host, device = [], []
        for e in self._prof.events():
            iv = (e.time_range.start, e.time_range.end, e.name)
            if e.device_type != DeviceType.CUDA:
                host.append(iv)
            elif not e.name.startswith(PREFIX):  # a label's range on the card's timeline
                device.append(iv)
        return reduce_events(host, device, self.wall_s)

