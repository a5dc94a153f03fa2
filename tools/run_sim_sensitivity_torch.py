"""The reference's simulator-sensitivity sweep, run by the PyTorch/CUDA
port.

The port's counterpart of `tools/run_sim_sensitivity.py` (which stays the
reference's tool), with its arguments and defaults: the fixed CFEAR-3
pipeline (max_cells 1024) over synthetic worlds with each simulator knob
turned away from its default, the failure regimes beyond the envelope, and
the adaptive threshold (`filter.z_min_quantile=0.98`) on the noise-floor
cliffs; each run one `models/odometry.OdometryRunner` (chunk 16) over a
sequence the port's `datasets/synthetic.py` renders. The CSV has the
reference CSV's columns and a `device` column: the card's name and power
limit as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
gives them, or "cpu". `tests/test_sim_sensitivity.py`'s assertions read
it unchanged (`tests/test_torch_trends.py`).

Runs on the card; `--cpu` asks for the CPU, and without a card and without
`--cpu` it raises. The committed artifact
`eval_results/sim_sensitivity_torch_h100.csv` (seeds 11 and 12, 128
frames) is made a seed a call and merged, seed by seed in order:

    python tools/run_sim_sensitivity_torch.py --seeds 11 \\
        --out run/sim_11.csv
    python tools/run_sim_sensitivity_torch.py --seeds 12 \\
        --out run/sim_12.csv
    python tools/run_sim_sensitivity_torch.py \\
        --merge run/sim_11.csv,run/sim_12.csv \\
        --out eval_results/sim_sensitivity_torch_h100.csv

`--knobs` keeps the reference's meaning; `--groups` runs only some of a
seed's row groups (baseline, knobs, beyond, mitigated), for a part cut
further.
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import experiments_torch  # noqa: E402


#: knob -> list of (label, make_sequence overrides); the first level of
#: each knob is the default world (the shared baseline row is run once).
#: Levels span PLAUSIBLE sensor/world variation — the engine must degrade
#: smoothly across them (asserted by tests/test_sim_sensitivity.py).
KNOBS = {
    "wall_density": [("walls_9", dict(n_walls=9)),
                     ("walls_36", dict(n_walls=36))],
    "texture_contrast": [("gamma_1.0", dict(texture_gamma=1.0)),
                         ("gamma_4.0", dict(texture_gamma=4.0))],
    "speckle_scale": [("noise_14", dict(noise_scale=14.0)),
                      ("noise_16", dict(noise_scale=16.0))],
    "scatterers": [("scat_120", dict(n_scatterers=120)),
                   ("scat_800", dict(n_scatterers=800))],
    "dynamic_objects": [("dyn_20", dict(n_dynamic=20)),
                        ("dyn_40", dict(n_dynamic=40))],
    "azimuth_jitter": [("jit_1mrad", dict(azimuth_jitter_rad=1e-3)),
                       ("jit_3mrad", dict(azimuth_jitter_rad=3e-3))],
    "saturation": [("sat_3m", dict(saturation_m=3.0)),
                   ("sat_5m", dict(saturation_m=5.0))],
    "multipath": [("mp_0.15", dict(multipath_gain=0.15)),
                  ("mp_0.3", dict(multipath_gain=0.3))],
}

#: documented FAILURE REGIMES beyond the envelope (rows are recorded with
#: knob="beyond_envelope" and excluded from the no-cliff assertions).
#: Measured cliffs (r4 calibration): a noise floor >= ~1.67x nominal
#: drowns the FIXED z_min=60 detector, seed-dependently from 20 (the
#: standard mitigation is recalibrating z_min to the sensor's floor —
#: the reference exposes the same per-dataset config);
#: receiver saturation past ~2x the min-distance gate injects
#: sensor-static false structure registration can lock onto; <=60
#: scatterers starve feature-poor worlds seed-dependently.
BEYOND = [
    ("noise_20", dict(noise_scale=20.0)),
    ("noise_24", dict(noise_scale=24.0)),
    ("sat_8m", dict(saturation_m=8.0)),
    ("scat_60", dict(n_scatterers=60)),
]

#: the adaptive-threshold mitigation (`filter.z_min_quantile=0.98`,
#: tests/test_adaptive_zmin.py) applied to the noise-floor cliffs: the
#: SAME worlds that collapse with the fixed z_min=60 detector track at
#: ordinary drift when the threshold rides the measured floor — up to
#: ~2x the nominal floor. At 3x (noise_36, SNR ~ 1) even the adaptive
#: detector fails (the threshold rides above much of the genuine signal);
#: that row stays under beyond_envelope WITH the flag on, pinning the
#: physical edge rather than the detector's.
MITIGATED = [
    ("noise_20_q98", dict(noise_scale=20.0)),
    ("noise_24_q98", dict(noise_scale=24.0)),
]
BEYOND_MITIGATED = [
    ("noise_36_q98", dict(noise_scale=36.0)),
]


GROUPS = ("baseline", "knobs", "beyond", "mitigated")


def main(argv=None):
    import numpy as np
    from cfear_radarodometry_code_public_tpu_torch.config import preset
    from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
    from cfear_radarodometry_code_public_tpu_torch.eval.kitti import kitti_drift
    from cfear_radarodometry_code_public_tpu_torch.eval.trajectory import (
        ate_rmse)
    from cfear_radarodometry_code_public_tpu_torch.models import odometry

    ap = argparse.ArgumentParser()
    ap.add_argument("--n-frames", type=int, default=128)
    ap.add_argument("--speed", type=float, default=12.0)
    ap.add_argument("--seeds", default="11,12")
    ap.add_argument("--max-cells", type=int, default=1024)
    ap.add_argument("--out", default="eval_results/sim_sensitivity_torch_h100.csv")
    ap.add_argument("--knobs", default=",".join(KNOBS))
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="the row groups of each seed to run, in this order: "
                         + ", ".join(GROUPS))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain twins)")
    ap.add_argument("--merge", default=None, metavar="CSV,CSV,...",
                    help="concatenate these part CSVs, in the order given, "
                         "into --out and run nothing")
    args = ap.parse_args(argv)
    if args.merge:
        n = experiments_torch.merge_parts(args.merge.split(","), args.out)
        print(f"wrote {args.out} ({n} rows)")
        return n
    groups = args.groups.split(",")
    if set(groups) - set(GROUPS):
        raise ValueError(f"--groups: {sorted(set(groups) - set(GROUPS))} "
                         f"not in {GROUPS}")
    device_label = experiments_torch.device_label(args.cpu)
    device = "cpu" if args.cpu else "cuda"
    seeds = [int(s) for s in args.seeds.split(",")]

    cfg = preset("CFEAR-3", dataset="synthetic")
    cfg = cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=args.max_cells))

    def run(seed, overrides, cfg_filter=None):
        c = cfg if not cfg_filter else cfg.replace(
            filter=dataclasses.replace(cfg.filter, **cfg_filter))
        images, gt = synthetic.make_sequence(
            seed=seed, n_frames=args.n_frames, cfg=c, speed=args.speed,
            **overrides)
        runner = odometry.OdometryRunner(c, chunk=16, device=device)
        t0 = time.perf_counter()
        runner.process(images)
        traj = np.asarray(runner.trajectory())
        wall = time.perf_counter() - t0
        gt = np.asarray(gt)
        path = float(np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0),
                                           axis=1)))
        lengths = tuple(L for L in (50.0, 100.0, 200.0)
                        if L < 0.6 * path)
        d = kitti_drift(traj, gt, lengths=lengths)
        fails = int((~np.asarray(runner.frame_outputs().success)).sum())
        return dict(t_err_percent=round(d["t_err_percent"], 4),
                    r_err_deg_per_m=round(d["r_err_deg_per_m"], 5),
                    ate_m=round(float(ate_rmse(traj[:, :2], gt[:, :2])), 4),
                    registration_failures=fails), len(images) / wall

    def record(rows, seed, knob, label, ov, cfg_filter=None):
        t0 = time.time()
        r, fps = run(seed, ov, cfg_filter)
        rows.append(dict(knob=knob, level=label, seed=seed, **r,
                         device=device_label))
        print(f"seed {seed} {knob}/{label}: {r} ({time.time() - t0:.0f}s, "
              f"{fps:.2f} frames/s host clock)", flush=True)

    rows = []
    for seed in seeds:
        if "baseline" in groups:
            record(rows, seed, "baseline", "default", {})
        if "knobs" in groups:
            for knob in args.knobs.split(","):
                for label, ov in KNOBS[knob]:
                    record(rows, seed, knob, label, ov)
        if "beyond" in groups:
            for label, ov in BEYOND:
                record(rows, seed, "beyond_envelope", label, ov)
        if "mitigated" in groups:
            for label, ov in MITIGATED:
                record(rows, seed, "mitigated", label, ov,
                       dict(z_min_quantile=0.98))
            for label, ov in BEYOND_MITIGATED:
                record(rows, seed, "beyond_envelope", label, ov,
                       dict(z_min_quantile=0.98))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    experiments_torch.write_rows(args.out, rows, list(rows[0]))
    print(f"wrote {args.out} ({len(rows)} rows, {device_label})")
    return rows


if __name__ == "__main__":
    main()
