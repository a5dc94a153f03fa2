"""The readers of the program's spans and counters (`idle_*_ms_per_step`,
`syncs_per_step`, `features_moments_ms_per_step`,
`features_scatter_useful_share`) over hand-built traces with known gaps:
`devtrace.Trace` over fake profiler events, times in ms."""

from __future__ import annotations

import pytest
import torch

from benchmark import devtrace, harness

MS = 1_000_000          # ns
MAIN, OTHER = 1, 2


class Ev:
    """The part of a kineto event that `devtrace.Trace` reads."""

    def __init__(self, name, start, end, device=False, thread=MAIN,
                 annotation=False, corr=0):
        self._name, self._start = name, start * MS
        self._dur = (end - start) * MS
        self._device, self._thread = device, thread
        self._annotation, self._corr = annotation, corr

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._annotation

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return 0


def rng(name, start, end, thread=MAIN):
    return Ev(name, start, end, thread=thread, annotation=True)


def kernel(start, end, corr=0):
    return Ev("k", start, end, device=True, corr=corr)


def make_trace(ranges, kernels, window=(0, 100), steps=1):
    return devtrace.Trace([rng(devtrace.WINDOW, *window)] + ranges + kernels,
                          steps)


@pytest.fixture(scope="module")
def readers():
    bench = harness.Bench(harness.ROOT)
    return {name: mod for w in bench.manifest["workloads"]
            for name, _, mod in bench.metrics(w["name"], trace=True)}


def read(readers, name, tr):
    return readers[name].read(harness.Context(tr, tr.steps, None, None, None))


IDLE = ("idle_upload_ms_per_step", "idle_sync_ms_per_step",
        "idle_dispatch_ms_per_step")


def idle(readers, tr):
    return [read(readers, n, tr) for n in IDLE]


def test_the_three_idle_metrics_sum_to_the_idle_time(readers):
    # busy 10-30, 40-60, 70-90 of a 100 ms window: idle 0-10, 30-40,
    # 60-70 and 90-100
    tr = make_trace([rng("fleet.upload", 0, 8), rng("register", 35, 65),
                     rng("sync.register", 58, 66),
                     rng("fleet.readback", 92, 100)],
                    [kernel(10, 30), kernel(40, 60), kernel(70, 90)],
                    steps=2)
    up, sy, di = idle(readers, tr)
    # 0-10: 8 ms upload, the rest (8-10) dispatch; 30-40 dispatch;
    # 60-70 began inside sync.register; 90-100 began in no range
    assert (up, sy, di) == pytest.approx((8 / 2, 10 / 2, (2 + 10 + 10) / 2))
    share = read(readers, "device_idle_share", tr)
    assert up + sy + di == pytest.approx(share / 100 * 100 / 2)


def test_a_gap_that_begins_inside_sync_register_is_sync_idle(readers):
    tr = make_trace([rng("fleet.upload", 0, 5), rng("register", 20, 80),
                     rng("sync.register", 40, 45)],
                    [kernel(0, 42), kernel(60, 100)])
    # the gap 42-60 began inside sync.register and outlasts it: all sync
    assert idle(readers, tr) == pytest.approx([0.0, 18.0, 0.0])
    # the same gap opening just before the sync is dispatch idle
    tr = make_trace([rng("fleet.upload", 0, 5),
                     rng("sync.register", 43, 45)],
                    [kernel(0, 42), kernel(60, 100)])
    assert idle(readers, tr) == pytest.approx([0.0, 0.0, 18.0])


def test_a_gap_over_readback_then_upload_splits_by_overlap(readers):
    # the device runs dry during the read-back; the host then pins the next
    # chunk (upload) and the next kernel starts at 90
    tr = make_trace([rng("fleet.readback", 15, 30),
                     rng("sync.bootstrap", 31, 33),
                     rng("fleet.upload", 35, 85)],
                    [kernel(0, 20), kernel(90, 100)])
    up, sy, di = idle(readers, tr)
    assert (up, sy, di) == pytest.approx((50.0, 20.0, 0.0))
    assert up + sy + di == pytest.approx(
        read(readers, "device_idle_share", tr))


def test_only_the_main_thread_names_a_gap(readers):
    tr = make_trace([rng("fleet.upload", 0, 5),
                     rng("sync.register", 40, 60, thread=OTHER),
                     rng("fleet.upload", 40, 60, thread=OTHER)],
                    [kernel(0, 50), kernel(60, 100)])
    assert idle(readers, tr) == pytest.approx([0.0, 0.0, 10.0])


def test_syncs_per_step_counts_per_step(readers):
    # the chunk's bootstrap check before its first step, two steps of 3
    # register syncs, then 2 and the chunk's read-back; the ranges outside
    # the window and on another thread are not counted
    ranges = [rng("sync.register", -5, -4), rng("sync.bootstrap", 1, 2),
              rng("Filtering", 3, 4), rng("sync.register", 10, 11),
              rng("sync.register", 20, 21), rng("sync.register", 30, 31),
              rng("Filtering", 50, 51), rng("sync.register", 60, 61),
              rng("sync.register", 70, 71), rng("fleet.readback", 90, 99),
              rng("sync.lm", 80, 81, thread=OTHER),
              rng("register", 55, 75), rng("sync.register", 101, 102)]
    tr = make_trace(ranges, [kernel(0, 100)], window=(0, 100), steps=2)
    assert read(readers, "syncs_per_step", tr) == pytest.approx(7 / 2)
    per = [a + b for a, b in zip(tr.calls_per_step("sync.register"),
                                 tr.calls_per_step("fleet.readback"))]
    assert per == [3, 3]


def test_the_moments_range_is_read_alone(readers):
    # device time under features.moments, not under its siblings
    launches = [Ev("cudaLaunchKernel", t, t + 1, corr=c)
                for t, c in ((11, 1), (21, 2), (31, 3))]
    tr = make_trace([rng("build_normals", 10, 40),
                     rng("features.voxels", 10, 20),
                     rng("features.moments", 20, 30),
                     rng("features.cells", 30, 40)] + launches,
                    [kernel(12, 15, corr=1), kernel(22, 29, corr=2),
                     kernel(32, 33, corr=3)], steps=2)
    assert read(readers, "features_moments_ms_per_step", tr) == \
        pytest.approx(7.0 / 2)
    assert read(readers, "features_ms_per_step", tr) == \
        pytest.approx(11.0 / 2)


def test_the_scatter_share_reads_the_counters(readers):
    from cfear_radarodometry_code_public_tpu_torch.utils import trace
    tr = make_trace([], [kernel(0, 100)])
    trace.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            trace.count("features.points", 1000)
            trace.count("features.points_in_grid", torch.tensor(850.0))
            trace.count("features.points", 1000)
            trace.count("features.points_in_grid", torch.tensor(750.0))
        assert read(readers, "features_scatter_useful_share", tr) == \
            pytest.approx(80.0)
    finally:
        trace.reset_counters()
    assert read(readers, "features_scatter_useful_share", tr) is None


def test_nothing_is_read_without_the_device_or_the_spans(readers):
    from cfear_radarodometry_code_public_tpu_torch.utils import trace
    trace.reset_counters()
    # a CPU run: no device activity
    cpu = make_trace([rng("fleet.upload", 0, 5), rng("sync.register", 6, 7),
                      rng("features.moments", 8, 9)], [])
    # a program without the spans: the device ran, nothing names a cause
    bare = make_trace([rng("register", 0, 50)], [kernel(10, 40)])
    names = IDLE + ("syncs_per_step", "features_moments_ms_per_step",
                    "features_scatter_useful_share")
    for tr in (cpu, bare):
        for name in names:
            assert read(readers, name, tr) is None, name


def test_the_host_paced_rate_reads_the_untraced_window(readers):
    mod = readers["frames_per_s.host_paced"]
    tr = make_trace([], [kernel(10, 40)])
    ctx = harness.Context(tr, tr.steps, None, None, None,
                          {"frames": 5120, "seconds": 6.4})
    assert mod.WINDOW and mod.read(ctx) == 800.0
    # a traced run without the window reads nothing
    assert read(readers, "frames_per_s.host_paced", tr) is None
