"""Reduction of a `torch.profiler` trace (CPU and CUDA activities) to what
the per-layer metrics read.

Every device activity (a kernel, a copy, a fill) is attributed to the host
ranges (`record_function`) that were open on the launching thread when it
was launched: its correlation id links it to the runtime call that launched
it. A layer's device time is the summed duration of the activities launched
under its ranges, whatever the kernels are called. The traced window is the
benchmark's own `bench.window` range; the device is busy where the union of
its activities covers the window.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "bench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind(e) -> str:
    """The event's kind in kineto's names, from its device, its annotation
    flag and its name (not every torch build reports the kind itself)."""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if e.is_user_annotation():
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    if name.startswith(("cuda", "cu")) and not name.startswith("cuda::"):
        return "cuda_runtime"
    return "cpu_op"


class Trace:
    """Device activities with their launch ranges, host ranges and ops."""

    def __init__(self, events, steps: int):
        self.steps = steps
        launch_at = {}        # correlation id -> (thread, host ns)
        ranges = defaultdict(list)   # thread -> [(start, end, name)]
        ops = defaultdict(list)
        device = []
        for e in events:
            kind = _kind(e)
            if kind in DEVICE_KINDS:
                device.append(e)
            elif kind in ("cuda_runtime", "cuda_driver"):
                launch_at[e.correlation_id()] = (e.start_thread_id(),
                                                 e.start_ns())
            elif kind == "user_annotation":
                ranges[e.start_thread_id()].append(
                    (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif kind == "cpu_op":
                ops[e.start_thread_id()].append(
                    (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        self.kinds = defaultdict(int)
        for e in events:
            self.kinds[_kind(e)] += 1
        win = [r for rs in ranges.values() for r in rs if r[2] == WINDOW]
        if len(win) != 1:
            raise RuntimeError(f"the trace holds {len(win)} '{WINDOW}' "
                               f"ranges, not one; events by kind "
                               f"{dict(self.kinds)}")
        self.t0, self.t1 = win[0][0], win[0][1]
        self.window_s = (self.t1 - self.t0) * 1e-9
        self.ranges = {t: sorted(r) for t, r in ranges.items()}
        self.ops = {t: sorted(r) for t, r in ops.items()}
        self.main = next(t for t, rs in ranges.items()
                         if any(r[2] == WINDOW for r in rs))
        # (start, end, kind, name, frozenset of open host ranges)
        self.device = []
        self.unlinked = 0
        launched = defaultdict(list)     # thread -> [(host ns, event)]
        for e in device:
            s = e.start_ns()
            if s + e.duration_ns() <= self.t0 or s >= self.t1:
                continue
            link = launch_at.get(e.correlation_id())
            if link is None:
                link = launch_at.get(e.linked_correlation_id())
            if link is None:
                self.unlinked += 1
                self._add(e, frozenset())
            else:
                launched[link[0]].append((link[1], e))
        for thread, items in launched.items():
            for names, e in self._sweep(self.ranges.get(thread, []), items):
                self._add(e, names)
        self.device.sort()

    def _add(self, e, names):
        s = e.start_ns()
        self.device.append((s, s + e.duration_ns(), _kind(e), e.name(),
                            names))

    @staticmethod
    def _sweep(rs, items):
        """For launches (host ns, event) of one thread, the names of that
        thread's ranges (sorted by start) open at each launch."""
        items.sort(key=lambda x: x[0])
        active, i = [], 0
        for t, e in items:
            while i < len(rs) and rs[i][0] <= t:
                active.append(rs[i])
                i += 1
            active = [r for r in active if r[1] > t]
            yield frozenset(r[2] for r in active), e

    # -- what the metrics read ------------------------------------------
    def device_ms(self, under=(), minus=(), kinds=DEVICE_KINDS,
                  name_has: str = "") -> float:
        """Summed device time (ms) of the activities of `kinds` launched
        under any of the ranges `under` (all, if empty) and under none of
        `minus`."""
        under, minus = set(under), set(minus)
        total = 0
        for s, e, kind, name, names in self.device:
            if kind not in kinds or name_has not in name:
                continue
            if under and not names & under:
                continue
            if names & minus:
                continue
            total += e - s
        return total * 1e-6

    def count(self, kinds=("kernel",)) -> int:
        return sum(1 for d in self.device if d[2] in kinds)

    def calls_per_step(self, name: str, step_range: str = "Filtering"):
        """How often the host range `name` opened in each step, a step
        being what lies between two openings of `step_range`."""
        rs = self.ranges.get(self.main, ())
        marks = [s for s, e, n in rs if n == step_range
                 and self.t0 <= s < self.t1]
        per = [0] * len(marks)
        for s, e, n in rs:
            if n == name and self.t0 <= s < self.t1 and marks:
                i = bisect.bisect_right(marks, s) - 1
                if i >= 0:
                    per[i] += 1
        return per

    def busy_intervals(self):
        """The union of device activity inside the window, merged."""
        out = []
        for s, e, *_ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def _host_at(self, t) -> str:
        """What the main thread was doing at host time t: its innermost
        open range and innermost open op."""
        def innermost(rs):
            best = None
            for s, e, name in rs:
                if s <= t < e and (best is None or s >= best[0]):
                    best = (s, name)
            return best[1] if best else None
        rng = innermost(self.ranges.get(self.main, ()))
        op = innermost(self.ops.get(self.main, ()))
        return " > ".join(x for x in (rng, op) if x) or "host (no range)"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by what the host was doing in the middle of each."""
        by_name = defaultdict(int)
        for s, e, kind, name, _ in self.device:
            by_name[name] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return {"device_ops": [[n, t * 1e-9] for n, t in ops],
                "idle_gaps": [[self._host_at(s + g // 2), g * 1e-9]
                              for g, s in gaps[:top]]}
