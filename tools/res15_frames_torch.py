"""Which frames of the ablation sweep's res=1.5 job fail, in the reference
and in the port, and whether cell compaction under overflow decides them.

The job is `resolution/seed_12/job_0` of `tools/run_ablation_sweep.py`
(the adversarial world of seed 12, 120 frames at 12 m/s, `feature.res`
1.5, max_cells 1024): at res 1.5 a frame has more valid cells than the
budget, and compaction (`ops/features._finalize_cells` in both packages:
a stable sort by sample count) drops the least-supported ones. Each variant
runs the job's offline CLI in-process on the CPU, in a process of its own:

- `dense`: the reference's CLI (`auto`: its dense association);
- `kernelA`: the reference's CLI with `assoc_method="pallas"` (kernel A in
  interpret mode);
- `port`: the port's CLI with `--cpu` (the dense association);

and each again with `--max_cells NO_DROP` (`*-nodrop`), a budget above
every frame's valid cells, so that no cell is dropped. Per frame it keeps
success, keyframe, cell and association counts. The port's runs also
record every call of `_finalize_cells`: the number of valid cells before
compaction, the band of cells tied at the cut's sample count, and whether
the reference's `_finalize_cells` keeps the same cells on the same inputs
(run eagerly beside it). It prints, for each variant, the failed frames and
at each the cells dropped, and the frames where the variants part.

    JAX_PLATFORMS=cpu python tools/res15_frames_torch.py [--dir DIR]

About four minutes a variant on one CPU process (two at a time).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

JOB = ["--dataset", "synthetic", "--n-frames", "120", "--speed", "12.0",
       "--n-dynamic", "40", "--dropout-prob", "0.5",
       "--speckle-burst-prob", "0.4", "--chunk", "25", "--no-save-graph",
       "--seed", "12", "--res", "1.5"]
MAX_CELLS = 1024
NO_DROP = 4096
VARIANTS = ("dense", "kernelA", "port", "dense-nodrop", "kernelA-nodrop",
            "port-nodrop")


def run_variant(variant: str, out: str) -> None:
    """One variant's CLI run; writes its per-frame record to `out`."""
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")

    import chip_smoke
    cells = NO_DROP if variant.endswith("-nodrop") else MAX_CELLS
    kind = variant.split("-")[0]
    argv = JOB + ["--max_cells", str(cells), "--cpu", "--output-dir",
                  os.path.join(os.path.dirname(out), variant)]
    calls = []
    if kind == "port":
        from cfear_radarodometry_code_public_tpu_torch import offline_odometry
        from cfear_radarodometry_code_public_tpu_torch.models.odometry import (
            OdometryRunner)
        from cfear_radarodometry_code_public_tpu_torch.ops import features
        spy_ctx = _finalize_spy(features, calls)
    else:
        from cfear_radarodometry_code_public_tpu import config, offline_odometry
        from cfear_radarodometry_code_public_tpu.models.odometry import (
            OdometryRunner)
        spy_ctx = (_kernel_a(config) if kind == "kernelA"
                   else contextlib.nullcontext())
    with spy_ctx, chip_smoke.recorded(OdometryRunner, "process") as runs:
        result = offline_odometry.main(argv)
    runner = runs[0][0]["self"]
    fo = runner.frame_outputs()
    rec = {"variant": variant, "max_cells": cells,
           "success": np.asarray(fo.success).tolist(),
           "fused": np.asarray(fo.fused).tolist(),
           "num_cells": np.asarray(fo.num_cells).tolist(),
           "num_assoc": np.asarray(fo.num_assoc).tolist(),
           "keyframes": result["keyframes"],
           "failures": result["registration_failures"],
           "drift": result["t_err_percent"], "ate": result["ate_m"]}
    if calls:
        # one call a frame after the bootstrap frame's
        rec["finalize"] = calls
    with open(out, "w") as f:
        json.dump(rec, f)


@contextlib.contextmanager
def _kernel_a(config):
    """Every preset the reference's CLI builds takes kernel A."""
    preset = config.preset

    def preset_a(*args, **kw):
        cfg = preset(*args, **kw)
        return cfg.replace(registration=dataclasses.replace(
            cfg.registration, assoc_method="pallas"))

    config.preset = preset_a
    try:
        yield
    finally:
        config.preset = preset


class _finalize_spy:
    """While the block runs, each call of the port's `_finalize_cells`
    appends {valid, dropped, tie band, same as the reference's} to
    `calls`."""

    def __init__(self, features, calls):
        self.features, self.calls = features, calls
        self.orig = features._finalize_cells

    def __enter__(self):
        import jax.numpy as jnp
        import numpy as np
        from cfear_radarodometry_code_public_tpu.config import CFEARConfig
        from cfear_radarodometry_code_public_tpu.ops import features as jfeat
        orig, calls = self.orig, self.calls

        def spy(mean, nvec, cxx, cxy, cyy, nsamp, planarity, cell_ok, ix, iy,
                cfg):
            got = orig(mean, nvec, cxx, cxy, cyy, nsamp, planarity, cell_ok,
                       ix, iy, cfg)
            m = cfg.feature.max_cells
            ok = cell_ok[0].numpy()
            ns = nsamp[0].numpy()
            valid = int(ok.sum())
            cut = np.sort(ns[ok])[::-1][m - 1] if valid > m else None
            args = [jnp.asarray(t.numpy()) for t in
                    (mean, nvec, cxx, cxy, cyy, nsamp, planarity, cell_ok,
                     ix, iy)]
            want = jfeat._finalize_cells(
                *args, CFEARConfig.from_dict(cfg.to_dict()))
            same = all(np.array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
                       for k in ("mean", "normal", "nsamples", "valid"))
            calls.append({
                "valid": valid, "dropped": max(0, valid - m),
                "cut_nsamples": None if cut is None else float(cut),
                "tied_at_cut": 0 if cut is None else int((ns[ok] == cut).sum()),
                "same_as_reference": bool(same)})
            return got

        self.features._finalize_cells = spy
        return self

    def __exit__(self, *exc):
        self.features._finalize_cells = self.orig
        return False


def report(d: str) -> dict:
    """Print each variant's failed frames and the cells dropped there."""
    recs = {}
    for v in VARIANTS:
        with open(os.path.join(d, f"{v}.json")) as f:
            recs[v] = json.load(f)
    summary = {}
    for v, r in recs.items():
        failed = [i for i, s in enumerate(r["success"]) if not s]
        summary[v] = failed
        print(f"{v}: max_cells {r['max_cells']}, {r['failures']} failed "
              f"frames {failed}, {r['keyframes']} keyframes, drift "
              f"{r['drift']:.4f}%, ATE {r['ate']:.4f} m")
        if "finalize" in r:
            fin = r["finalize"]
            # calls[0] is the bootstrap frame's
            at = {i: fin[i] for i in failed if i < len(fin)}
            print(f"  {v}: {len(fin)} compactions, {sum(c['dropped'] > 0 for c in fin)} "
                  f"with cells dropped (at most {max(c['dropped'] for c in fin)}, "
                  f"valid cells at most {max(c['valid'] for c in fin)}); "
                  f"the reference's compaction keeps the same cells on the "
                  f"same inputs in {sum(c['same_as_reference'] for c in fin)} "
                  f"of {len(fin)}")
            for i, c in at.items():
                print(f"  {v} frame {i}: valid {c['valid']}, dropped "
                      f"{c['dropped']}, cut at nsamples {c['cut_nsamples']} "
                      f"({c['tied_at_cut']} tied), cells kept "
                      f"{r['num_cells'][i]}, associations {r['num_assoc'][i]}")
    for a, b in (("dense", "kernelA"), ("dense", "port"),
                 ("kernelA", "port")):
        for sfx in ("", "-nodrop"):
            fa, fb = set(summary[a + sfx]), set(summary[b + sfx])
            print(f"{a}{sfx} vs {b}{sfx}: failed in both {sorted(fa & fb)}, "
                  f"only {a} {sorted(fa - fb)}, only {b} {sorted(fb - fa)}")
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "res15_frames"))
    ap.add_argument("--variant", choices=VARIANTS, default=None,
                    help="run one variant in this process")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--report-only", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.dir, exist_ok=True)
    if args.variant:
        run_variant(args.variant, os.path.join(args.dir,
                                               f"{args.variant}.json"))
        return
    if not args.report_only:
        env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")

        def one(v):
            return subprocess.run(
                [sys.executable, __file__, "--dir", args.dir, "--variant", v],
                env=env, check=True, stdout=subprocess.DEVNULL)

        with concurrent.futures.ThreadPoolExecutor(args.workers) as pool:
            list(pool.map(one, VARIANTS))
    report(args.dir)


if __name__ == "__main__":
    main()
