"""The benchmark of the PyTorch/CUDA port of CFEAR radar odometry.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

A cell of `BENCHMARK.json` names a configuration (`configs/<config>.json`)
and a traffic mix (`traffic/<traffic>.json`); its correctness limits are in
`limits/<cell>.json` and each per-layer metric is a reader of its own in
`metrics/<metric>.py`. Nothing here names a cell, a configuration, a mix or
a metric: a new one is new files and entries.

A run renders the mix's sweeps from the seed, builds the program's
`parallel/mesh.MultiSequenceRunner` over the configuration, warms it up
until every lane's keyframe window is full (two chunks at least,
`warmup_chunks` at most), then hands it
chunk after chunk for `--seconds` (the loop is closed: the next chunk goes
in once the last one's outputs are on the host) and prints the end-to-end
metrics that `BENCHMARK.json` lists for the cell: `frames_per_s` over that
window, `setup_s`, and `memory_peak_gib`, the device's peak allocation over
the run. With `--trace 1` it traces `trace_chunks` chunks with
`torch.profiler` instead and prints the per-layer metrics; where a reader of
the cell sets `WINDOW` (it reads the untraced window's rate), the same
untraced window runs first. Afterwards the plain reference follows the drive of
every lane step by step, from the state that the program's own outputs
imply, and registers the frames of window steps drawn from the seed
itself; `correct` says whether the program's poses and shifts lie
within the limits of the reference's, and whether its keyframe decisions
are the reference's.

The plain reference is `reference.py`, or the file under `benchmark/` that
the configuration file's key `"reference"` names (`Bench.reference`). It
gives the check, the TF32 control (`readings.py`) and the work behind the
rooflines (`work.py`), and it is refused before anything is rendered where
it lacks a part of `REFERENCE_API`: `Odometry(params, lanes, device,
precision)`, with `Odometry.check(params)`, which refuses by key what the
reference does not implement and runs before rendering too, and
`.step(images, given=None, register=True)` returning the keys that
`run_reference` reads; and `points`, `compensate`, `cells`, `transform`, `rotate` and `nearest`
for `work.py` (see `reference.py`'s docstring).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

from benchmark import reference, traffic_gen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "cfear_radarodometry_code_public_tpu")
REFERENCE_API = ("Odometry", "points", "compensate", "cells",
                 "transform", "rotate", "nearest")


# ------------------------------------------------------------ the files
def load_json(path):
    with open(path) as f:
        return json.load(f)


class Bench:
    """The manifest and the files it names, under one root."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.dir = os.path.join(root, "benchmark")
        self.manifest = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload '{name}' in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                cfg = load_json(os.path.join(self.root, c["file"]))
                cfg["params"] = _numbers(cfg["params"])
                return cfg
        raise KeyError(f"no config '{name}' in BENCHMARK.json")

    def reference(self, cfg_file: dict):
        """The plain reference module of a configuration (`config`'s
        result): the file under benchmark/ that its key "reference" names,
        loaded by path, or `reference.py` without the key. Refused, by file
        and part, where the file is missing or lacks a part of
        `REFERENCE_API`, `Odometry.check` or `Odometry.step`."""
        name = cfg_file.get("reference")
        if name is None:
            mod, name = reference, "reference.py"
        else:
            path = os.path.join(self.dir, name)
            if os.path.isabs(name) or ".." in name.split("/") \
                    or not os.path.isfile(path):
                raise ValueError(f"configuration '{cfg_file['name']}' names "
                                 f"the reference {name!r}, which is no file "
                                 "under benchmark/")
            spec = importlib.util.spec_from_file_location(
                f"bench_reference_{cfg_file['name']}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        missing = [p for p in REFERENCE_API
                   if not callable(getattr(mod, p, None))]
        if "Odometry" not in missing:
            missing += [f"Odometry.{p}" for p in ("check", "step")
                        if not callable(getattr(mod.Odometry, p, None))]
        if missing:
            raise ValueError(f"the reference {name} lacks "
                             f"{', '.join(missing)} of the interface")
        return mod

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.dir, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> dict:
        return load_json(os.path.join(self.dir, "limits", f"{cell}.json"))

    def metrics(self, cell: str, trace: bool):
        """(name, entry, reader module) of the metrics a run of `cell`
        reports: its end-to-end ones, or its per-layer ones when traced."""
        out = []
        for m in self.manifest["per_layer" if trace else "end_to_end"]:
            if cell not in m.get("workloads", [cell]):
                continue
            mod = None
            if trace:
                path = os.path.join(self.dir, "metrics", f"{m['name']}.py")
                spec = importlib.util.spec_from_file_location(
                    f"bench_metric_{len(out)}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                for key in ("unit", "layer", "moves", "source"):
                    if getattr(mod, key.upper()) != m[key]:
                        raise ValueError(f"{path}: {key} is "
                                         f"{getattr(mod, key.upper())!r}, "
                                         f"BENCHMARK.json says {m[key]!r}")
            out.append((m["name"], m, mod))
        return out


def _numbers(tree):
    """JSON strings that stand for non-finite numbers -> floats."""
    if isinstance(tree, dict):
        return {k: _numbers(v) for k, v in tree.items()}
    if tree in ("inf", "-inf", "nan"):
        return float(tree)
    return tree


def _diff(a, b, path=""):
    """Keys at which two parameter trees differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b)):
            out += _diff(a.get(k), b.get(k), f"{path}.{k}" if path else k)
        return out
    same = a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))
    return [] if same else [f"{path}: file {b!r}, program {a!r}"]


def program_config(cfg_file):
    """The program's configuration: `preset(name, dataset)` with the file's
    overrides; raises where it disagrees with the file's `params`."""
    from cfear_radarodometry_code_public_tpu_torch import config as pconf
    prog = cfg_file["program"]
    c = pconf.preset(prog["preset"], dataset=prog["dataset"])
    d = c.to_dict()
    for group, values in prog.get("overrides", {}).items():
        d[group].update(values)
    c = pconf.CFEARConfig.from_dict(d)
    c = c.replace(name=d["name"])
    bad = _diff(_numbers(c.to_dict()), cfg_file["params"])
    if bad:
        raise ValueError("the program's configuration disagrees with the "
                         "file: " + "; ".join(bad))
    return c


# ----------------------------------------------------------- the check
def checked_steps(first: int, steps: int, count: int, seed: int):
    """The window steps whose frames the reference registers: `count` of
    first .. steps - 1 drawn from the seed (all of them if fewer)."""
    rng = np.random.default_rng([traffic_gen._seed(seed), 11])
    window = np.arange(first, steps)
    if count >= window.size:
        return window
    return np.sort(rng.choice(window, count, replace=False))


def run_reference(ref, params, drive, lanes, steps, device,
                  precision="float64", follow=None, rows=None, checked=()):
    """The reference module `ref` over the first `steps` frames of `lanes`:
    dict of numpy (lanes, steps, ...) frame outputs. With `follow` (another
    odometry's frame outputs, numpy (rows, steps, ...), lane i at row
    rows[i]), the reference follows it step by step (`Odometry.step`'s
    `given`) and registers only the frames of the steps `checked`; the
    other steps' outputs are NaN (poses) and 0."""
    import torch
    odo = ref.Odometry(params, len(lanes), device, precision)
    keys = ("pose", "shift", "fused", "success", "n_assoc", "n_cells",
            "n_points", "iterations")
    outs = {k: [] for k in keys}
    checked = set(int(t) for t in checked)
    for t in range(steps):
        img = torch.as_tensor(drive.frames(lanes, t)).to(device)
        given = None if follow is None else {
            k: follow[k][rows, t] for k in ("pose", "fused")}
        o = odo.step(img, given=given, register=t in checked)
        if o is None:
            o = {k: torch.full((len(lanes), 3), math.nan) if k in (
                "pose", "shift") else torch.zeros(len(lanes), dtype=torch.int64)
                for k in keys}
        for k in keys:
            outs[k].append(o[k].cpu().numpy())
    return {k: np.stack(v, 1) for k, v in outs.items()}


def gaps(ref, other, rows, checked):
    """At the steps `checked`, the gap between the reference's frame outputs
    and the followed odometry's (lane i at row rows[i]), both relative to
    the same keyframe: position (m) and heading (rad), each (lanes,
    len(checked)), the larger of the pose's gap and the shift's (the pose
    where the frame became a keyframe, else 0)."""
    checked = np.asarray(checked, dtype=np.int64)
    gap_m = gap_rad = 0.0
    for key in ("pose", "shift"):
        d = ref[key][:, checked] - np.asarray(
            other[key], np.float64)[rows][:, checked]
        bad = ~np.isfinite(d).all(-1)
        gap_m = np.maximum(gap_m, np.where(
            bad, math.inf, np.hypot(d[..., 0], d[..., 1])))
        gap_rad = np.maximum(gap_rad, np.where(bad, math.inf, np.abs(
            np.arctan2(np.sin(d[..., 2]), np.cos(d[..., 2])))))
    return gap_m, gap_rad


def compare(ref, other, rows, checked, limits):
    """The numbers compared, each with its limit: over the frames checked,
    the 90th and 99th percentiles of the position gaps between the
    reference's and the followed odometry's outputs and the 95th of their
    heading gaps, and (exact, limit 0) the frames whose keyframe decision
    differs from the one the reference takes itself."""
    checked = np.asarray(checked, dtype=np.int64)
    gap_m, gap_rad = gaps(ref, other, rows, checked)
    values = {"pose_gap_p90_m": float(np.quantile(gap_m, 0.9)),
              "pose_gap_p99_m": float(np.quantile(gap_m, 0.99)),
              "yaw_gap_p95_rad": float(np.quantile(gap_rad, 0.95))}
    out = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    differ = np.asarray(other["fused"])[rows][:, checked] \
        != ref["fused"][:, checked]
    out["fused_differ"] = {"value": int(differ.sum()), "limit": 0}
    return out


# ------------------------------------------------------------- the run
def process_start_time(fallback: float) -> float:
    """When this process started (epoch seconds), from /proc."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return fallback


def card_info() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


class Context:
    """What a per-layer metric reader is given: the trace of `steps` traced
    steps, the work behind the rooflines, and `window`, the untraced
    window's frames and seconds where a reader asked for one (`WINDOW`)."""

    def __init__(self, trace, steps, work, params, traffic, window=None):
        self.trace, self.steps, self.work = trace, steps, work
        self.params, self.traffic, self.window = params, traffic, window


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT, t_start=None,
             fault=None, log=print, keep=None):
    """One run of a cell: the result dict (without the JAX check). `fault`
    (tests only) wraps the runner's `step_chunk`; a `keep` dict receives
    the sweeps, the program's and the reference's frame outputs, the
    lanes compared, the reference module and the untraced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from cfear_radarodometry_code_public_tpu_torch.parallel.mesh import (
        MultiSequenceRunner)

    t_start = time.time() if t_start is None else t_start
    bench = Bench(root)
    cell = bench.cell(workload)
    cfg_file = bench.config(cell["config"])
    params = cfg_file["params"]
    ref_mod = bench.reference(cfg_file)
    ref_mod.Odometry.check(params)
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)
    metrics = bench.metrics(workload, trace)
    cfg = program_config(cfg_file)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    phases = {"imports": time.time() - t_start}
    t_phase = time.perf_counter()

    def phase(name):
        nonlocal t_phase
        now = time.perf_counter()
        phases[name] = now - t_phase
        t_phase = now

    drive = traffic_gen.Traffic(traffic, params, seed)
    phase("render")
    arrays = drive.chunks()
    phase("chunks")
    n_lanes, chunk = traffic["lanes"], traffic["chunk"]
    runner = MultiSequenceRunner(cfg, n_lanes, chunk=chunk,
                                 ingest=traffic["ingest"], device=device)
    phase("runner")
    if fault is not None:
        runner.step_chunk = fault(runner.step_chunk)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # warm-up: at least two chunks (every shape of the window), then on
    # until every lane's keyframe window is full, at most `warmup_chunks`
    k = 0
    while k < traffic["warmup_chunks"]:
        runner.process(arrays[drive.drive_chunk(k)])
        k += 1
        phase(f"warmup{k}")
        if k >= 2 and bool(runner.states.kf_valid.all()):
            break
    sync()
    log("setup phases (s): " + ", ".join(f"{n} {v:.3f}"
                                         for n, v in phases.items()))
    # the warm-up fills every lane's keyframe window (an exact check)
    empty = int((~runner.states.kf_valid).sum())
    log("keyframes a lane after the warm-up: " + " ".join(
        str(int(n)) for n in runner.states.kf_count.cpu()))
    first_step = k * chunk
    result = {}
    window = None
    # the untraced window: every untraced run, and a traced one (before its
    # traced chunks) where a reader of the cell asks for it
    if not trace or any(getattr(mod, "WINDOW", False)
                        for _, _, mod in metrics):
        t0 = time.perf_counter()
        setup_s = time.time() - t_start
        frames, marks = 0, []
        while True:
            runner.process(arrays[drive.drive_chunk(k)])
            k += 1
            frames += n_lanes * chunk
            window_s = time.perf_counter() - t0
            marks.append(window_s)
            if window_s >= seconds:
                break
        log("chunk ends (s): " + " ".join(f"{m:.3f}" for m in marks))
        window = {"frames": frames, "seconds": window_s}
        log(f"window {window_s:.3f} s, {frames} frames, "
            f"{k - first_step // chunk} chunks; setup {setup_s:.3f} s")
    first_traced = k * chunk
    if trace:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("bench.window"):
                for _ in range(traffic["trace_chunks"]):
                    runner.process(arrays[drive.drive_chunk(k)])
                    k += 1
                sync()
    steps_total = k * chunk
    window_steps = steps_total - first_step
    traced_steps = steps_total - first_traced
    out = runner.frame_outputs()
    prog = {"pose": out.pose, "shift": out.shift, "fused": out.fused,
            "success": out.success, "n_assoc": out.num_assoc,
            "n_cells": out.num_cells, "iterations": out.reg_iterations}
    window_success = out.success[:, first_step:]
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    del runner, arrays
    if on_card:
        torch.cuda.empty_cache()

    if not trace:
        # the end-to-end metrics the harness takes itself; the cell reports
        # those that BENCHMARK.json lists for it
        values = {"frames_per_s": window["frames"] / window["seconds"],
                  "setup_s": setup_s, "memory_peak_gib": peak / 2**30}
        values = {n: values[n] for n, _, _ in metrics}
    else:
        from benchmark import devtrace, work
        t_red = time.perf_counter()
        tr = devtrace.Trace(prof.profiler.kineto_results.events(),
                            traced_steps)
        del prof
        counts = work.counts(ref_mod, drive, first_traced, traced_steps,
                             params, dev)
        ctx = Context(tr, traced_steps, counts, params, traffic, window)
        values = {}
        for name, _, mod in metrics:
            v = mod.read(ctx)
            if v is not None:
                values[name] = float(v)
        result["breakdown"] = tr.breakdown()
        result["trace"] = {"busy_s": tr.busy_s, "window_s": tr.window_s,
                           "unlinked": tr.unlinked, "kinds": tr.kinds,
                           "reduce_s": time.perf_counter() - t_red}

    t_ref = time.perf_counter()
    lanes = list(range(n_lanes))
    checked = checked_steps(first_step, steps_total,
                            traffic["check_frames"], seed)
    ref = run_reference(ref_mod, params, drive, lanes, steps_total, dev,
                        follow=prog, rows=lanes, checked=checked)
    check = {"kf_slots_empty": {"value": empty, "limit": 0},
             **compare(ref, prog, lanes, checked, limits)}
    ref_s = time.perf_counter() - t_ref
    correct = all(v["value"] <= v["limit"] for v in check.values())
    if keep is not None:
        keep.update(drive=drive, prog=prog, ref=ref, lanes=lanes,
                    checked=checked, reference=ref_mod,
                    first_step=first_step, first_traced=first_traced,
                    window=window, params=params, traffic=traffic,
                    limits=limits, ref_s=ref_s)
    log(f"reference: {len(lanes)} lanes, {steps_total} steps, "
        f"{len(checked)} registered, in {ref_s:.3f} s")
    log("the checked frames' valid points a sweep (reference) / valid cells "
        "(program), min median max: " + " / ".join(
            " ".join(str(int(f(a))) for f in (np.min, np.median, np.max))
            for a in (ref["n_points"][:, checked],
                      np.asarray(prog["n_cells"])[:, checked])))

    units = {name: m["unit"] for name, m, _ in metrics}
    result.update({
        "correct": bool(correct),
        "attempted": int(n_lanes * window_steps),
        "failed": int((~window_success).sum()),
        "metrics": {n: {"value": v, "unit": units[n]}
                    for n, v in values.items()},
        "device": {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)},
        "check": check})
    if trace:
        result["device"].update(busy_s=result["trace"]["busy_s"],
                                window_s=result["trace"]["window_s"])
    return result


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def emit(result: dict) -> None:
    """The check's numbers on standard error, then the result line, with
    `check` as its last key."""
    check = result.pop("check")
    for name, v in check.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    result["check"] = check
    print(json.dumps(result))


def main(argv=None, t_start=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start_time(t_start or time.time())
    try:
        chips = Bench().cell(args.workload)["chips"]
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (the benchmark never falls back to the CPU)", file=sys.stderr)
        return 3
    # the program's kernel caches live in the checkout, at fixed paths (its
    # own nvcc build goes to the package's `_build/`)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    log = lambda msg: print(f"benchmark: {msg}", file=sys.stderr)  # noqa: E731
    log(f"card: {card_info()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start=t_start, log=log)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 4
    tr = result.pop("trace", None)
    if tr is not None:
        log(f"trace: {json.dumps(tr)}")
    emit(result)
    return 0
