"""Time the port's kernels F (fused LM solve) and G (feature moments) of
several source trees on one CUDA card, in turns inside one call.

    python tools/compare_torch_kernels.py [--out DIR] PARENT . . PARENT
    python tools/compare_torch_kernels.py --mode sweep [--out DIR]
    python tools/compare_torch_kernels.py --mode by-kernel

Each tree named (a checkout of the repo: `git archive <commit> | tar -x -C
<dir>`) is run in a process of its own, in the order given, so that two
versions are compared on one card under one power limit (parent, change,
change, parent). A run imports the port package of that tree, builds its
kernels, and drives them with this tree's `chip_smoke.py`, so that every
tree gets the same inputs, checks and timer: `phase_lm` and `phase_moments`
hold each kernel against its plain twin (and fail if they disagree) and
time it on the device alone (`chip_smoke._cuda_ms`: kernel F's early-exit
and masked variants at B=8 and early exit at B=1 at every width of
`chip_smoke.LM_SHAPES`, kernel G at B=8 and B=1 beside the `index_add_`
yardstick). The one timer here, `_call_ms`, times the same calls back to
back: the slower of host and card, which is what a caller waits for. The
table goes to stdout; with `--out DIR` the records also go to
`DIR/compare_torch_kernels.json` (the sweep's to
`DIR/sweep_torch_lm_clusters.json`) and everything printed is appended to
`DIR/compare_torch_kernels.log`.

`--mode sweep` times this tree's kernel F at every cluster size (1, 2, 4,
8, 16) for each width and B in (1, 8): the basis of the rule that picks a
lane's cluster size from N. `--mode by-kernel` traces this tree's wrappers
with `torch.profiler` and prints the device time of each `__global__`
function behind them (kernel G is two: fill and sum).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(root):
    """This tree's `chip_smoke` over the port package of the tree at
    `root`."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def _call_ms(fn, n: int) -> float:
    """Mean ms per call of fn() over n back-to-back calls: the slower of
    the host launching them and the card running them."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _lm_inputs(cs, dev, shape):
    import numpy as np
    return cs.lm_inputs(np.random.default_rng(1), dev, *shape)[:3]


def _g_inputs(cs, dev):
    """Kernel G's inputs on the slice's first frames: (frames, B=8 inputs,
    lane 0 alone)."""
    from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
    images, _ = synthetic.make_sequence(
        cfg=cs.slice_config(), **{**cs.SEQUENCE, "n_frames": cs.BATCH})
    inputs, one = cs.moment_inputs(images, dev)
    return images, inputs, one[0]


def worker(root) -> int:
    """Time one tree; the last line of stdout is its JSON record."""
    import torch
    cs = _load(root)
    from cfear_radarodometry_code_public_tpu_torch.ops import (
        _build, cuda_features, cuda_lm)
    dev = torch.device("cuda", 0)
    card = cs._card()
    _build.library()
    # ptxas's registers and shared memory of the two kernels' entry points
    entry = None
    for line in _build.build_info["report"].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and entry and ("lm_solve" in entry
                                           or "moment" in entry):
            print(f"{entry}: {line.split(':', 1)[1].strip()}")
    f = cs.phase_lm(dev, card)["lm_solve_fused"]
    images, inputs, one = _g_inputs(cs, dev)
    g = cs.phase_moments(images, dev, card)["moment_accumulate"]

    rec = {"root": os.path.relpath(root, HERE), "card": card, "F": {},
           "host_paced": cs.host_paced}
    for shape in cs.LM_SHAPES:
        cfg, packed, pose0 = _lm_inputs(cs, dev, shape)
        n = str(packed.shape[2])
        rec["F"][n] = {
            "call_ms": _call_ms(
                lambda: cuda_lm.lm_solve_fused(packed, pose0, cfg), 100),
            "ee_ms": f["ms_by_n"][n], "masked_ms": f["masked_ms_by_n"][n],
            "b1_ms": f["b1_ms_by_n"][n]}
    rec["G"] = {
        "call_ms": _call_ms(
            lambda: cuda_features.moment_accumulate(*inputs), 100),
        "b8_ms": g["ms"], "b1_ms": g["b1_ms"],
        # the smoke's yardstick: float atomics over ready columns
        "index_add_ms": g["library_ms"]}
    print(json.dumps(rec))
    return 0


def sweep(out_dir) -> int:
    import torch
    cs = _load(HERE)
    from cfear_radarodometry_code_public_tpu_torch.ops import cuda_lm
    dev = torch.device("cuda", 0)
    print(cs._card())
    out = {}
    for s, m, cost, loss in ((1, 1024, "P2P", "Huber"),) + cs.LM_SHAPES:
        cfg, packed, pose0 = _lm_inputs(cs, dev, (s, m, cost, loss))
        want = cuda_lm.lm_solve_fused(packed, pose0, cfg)
        for b in (1, cs.BATCH):
            row = {}
            for c in (1, 2, 4, 8, 16):
                def run():
                    return cuda_lm._launch(packed[:b], pose0[:b], cfg,
                                           cluster=c)
                try:
                    got = run()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    row[c] = str(e)[-40:]
                    continue
                close = bool((got[0] - want[0][:b]).abs().max()
                             <= cs.LM_POSE_TOL)
                row[c] = (round(cs._cuda_ms(run, 50), 5), close)
            out[f"N={s * m} B={b}"] = row
            print(f"N={s * m} B={b}: (ms, within tolerance of the chosen "
                  f"size) by cluster size {row}", flush=True)
    if out_dir:
        with open(os.path.join(out_dir, "sweep_torch_lm_clusters.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
    return 0


def by_kernel() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    cs = _load(HERE)
    from cfear_radarodometry_code_public_tpu_torch.ops import (cuda_features,
                                                                cuda_lm)
    dev = torch.device("cuda", 0)
    print(cs._card())

    def trace(name, fn, n=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_time_total > 0 and ("moment" in e.key
                                            or "lm_solve" in e.key):
                kernel = e.key.replace("(anonymous namespace)::", "")
                print(f"{name}: {kernel.split('(')[0].split()[-1]} "
                      f"{e.device_time_total / e.count:.2f} us x "
                      f"{e.count / n:g} a call")

    _, inputs, one = _g_inputs(cs, dev)
    trace("G B=8", lambda: cuda_features.moment_accumulate(*inputs))
    trace("G B=1", lambda: cuda_features.moment_accumulate(*one))
    for s, m, cost, loss in cs.LM_SHAPES:
        cfg, packed, pose0 = _lm_inputs(cs, dev, (s, m, cost, loss))
        trace(f"F N={s * m} B=8",
              lambda: cuda_lm.lm_solve_fused(packed, pose0, cfg))
    return 0


class _Tee:
    """stdout, and a copy appended to a log file (for callers that keep
    only the end of a long output)."""

    def __init__(self, path):
        self.out, self.log = sys.stdout, open(path, "a")

    def write(self, text):
        self.out.write(text)
        self.log.write(text)

    def flush(self):
        self.out.flush()
        self.log.flush()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="source trees, in running order")
    ap.add_argument("--mode", choices=("compare", "sweep", "by-kernel"),
                    default="compare")
    ap.add_argument("--out", metavar="DIR", help="also write the records "
                    "and a log of the output there")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        sys.stdout = _Tee(os.path.join(args.out, "compare_torch_kernels.log"))
    if args.mode == "sweep":
        return sweep(args.out)
    if args.mode == "by-kernel":
        return by_kernel()
    if not args.roots:
        ap.error("name at least one source tree")
    recs = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.abspath(root)],
            cwd=os.path.abspath(root), capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        recs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(recs[0]["card"])
    print("kernel F, ms (back-to-back calls B=8 | on the device: early exit "
          "B=8 / masked B=8 / early exit B=1):")
    for n in recs[0]["F"]:
        print(f"  N={n}: " + "; ".join(
            f"{r['root']} {r['F'][n]['call_ms']:.4f} | "
            f"{r['F'][n]['ee_ms']:.4f} / {r['F'][n]['masked_ms']:.4f} / "
            f"{r['F'][n]['b1_ms']:.4f}" for r in recs))
    print("kernel G, ms (back-to-back calls B=8 | on the device: B=8 / B=1 / "
          "index_add_ B=8): " + "; ".join(
              f"{r['root']} {r['G']['call_ms']:.4f} | {r['G']['b8_ms']:.4f} / "
              f"{r['G']['b1_ms']:.4f} / {r['G']['index_add_ms']:.4f}"
              for r in recs))
    if args.out:
        with open(os.path.join(args.out, "compare_torch_kernels.json"),
                  "w") as f:
            json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
