"""Loop verification of the SLAM pass on the card against the same
verification on the CPU, on the same graph.

The smoke's `slam-dropout` path (`chip_smoke.py`: `slam`'s configuration
and world with azimuth dropout 0.35, 512 frames) accepts loop edges from
`LoopCloser.close_from_graph`, which on the card verifies every candidate
pair through kernels A (B=512 S=1) and F (B=512 N=1024). This tool asks
where a difference from the golden's accepted edges comes from. For two
odometry sources, the golden's own (its poses and keyframe flags) and the
port's on the card (`OdometryRunner`, host ingest), it builds the graph
with scan payloads on the CPU, closes one copy on the card and one on the
CPU (the kernels' plain twins), and prints each one's accepted edges
beside the golden's: equal card and CPU sets mean the card's verification
is its twin's on this graph, and a difference from the golden comes from
the odometry it was given.

    python tools/slam_verify_torch.py [--dropout 0.35] [--out FILE]

About five minutes on the card machine (two CPU closures of about 100 s).

With `--steps 10,20,...` it runs on the CPU instead, with the reference
beside the port: the reference's odometry (kernel A in interpret mode,
host ingest) up to each listed frame of the dropout sequence, then that
frame's cells and registration in both packages from the reference's
state, and the port's registration on the reference's cells: the
per-step deviation from which the odometry's drift apart grows.

    JAX_PLATFORMS=cpu python tools/slam_verify_torch.py --steps 10,20,27,40
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from cfear_radarodometry_code_public_tpu_torch.eval import slam_scale  # noqa: E402
from cfear_radarodometry_code_public_tpu_torch.models import (  # noqa: E402
    loopclosure, odometry, posegraph)


def close_both(cfg, outputs, traj, images) -> dict:
    """One graph with payloads (built on the CPU), closed on the card and,
    from a copy, on the CPU. Returns both accepted sets and seconds."""
    gb = posegraph.build_graph_from_odometry(outputs, traj, images=images,
                                             cfg=cfg, device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        g = copy.deepcopy(gb)
        t0 = time.perf_counter()
        acc = loopclosure.LoopCloser(cfg, device=dev).close_from_graph(g)
        out[dev] = {"accepted": sorted(map(tuple, acc)),
                    "candidates": g.n_constraints(posegraph.CANDIDATE),
                    "seconds": time.perf_counter() - t0}
    out["nodes"] = len(gb.poses)
    return out


def step_equality(frames) -> None:
    """`--steps`: the reference's and the port's registration step at each
    of `frames` on the reference's state (see the module's docstring)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from cfear_radarodometry_code_public_tpu.config import CFEARConfig
    from cfear_radarodometry_code_public_tpu.models import odometry as jo
    from cfear_radarodometry_code_public_tpu.ops import (
        filtering as jf, registration as jreg)
    from cfear_radarodometry_code_public_tpu_torch.ops import (
        features, filtering, registration)
    jax.config.update("jax_platforms", "cpu")
    cfg = chip_smoke.slam_config()
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, assoc_method="pallas"))
    cfg_j = CFEARConfig.from_dict(cfg.to_dict())
    images, _ = slam_scale.make_lap_sequence(
        cfg, **chip_smoke.SLAM_DROPOUT_SEQUENCE)
    rows = odometry.host_filter(images[:max(frames) + 1], cfg, "compact")
    runner = jo.OdometryRunner(cfg_j, chunk=1, ingest="host")
    extract = jax.jit(lambda s, i: jo._extract_cells(s, i, cfg_j, "compact"))
    register = jax.jit(lambda s, c, g: jreg.register(
        s.kf_cells, s.kf_poses, s.kf_valid, c, g, cfg=cfg_j))
    done = 0
    for fr in frames:
        runner.process(images[done:fr])
        done = fr
        st = runner.state
        cells_j = extract(st, jf.CompactCandidates(
            *(jnp.asarray(np.asarray(a)[fr]) for a in rows)))
        guess = jo.se2.compose(st.t_prev, st.tmot)
        want = register(st, cells_j, guess)
        st_t = odometry.state_from_numpy(
            [np.asarray(a)[None] for a in jax.tree.leaves(st)], "cpu")
        cells_t = odometry._extract_cells(st_t, filtering.CompactCandidates(
            *(torch.as_tensor(np.asarray(a)[fr:fr + 1]) for a in rows)),
            cfg, "compact")
        kf = features.CellMap(*st_t.kf_cells)
        g_t = torch.as_tensor(np.asarray(guess))[None]
        on_ref = registration.register(kf, st_t.kf_poses, st_t.kf_valid,
                                       features.CellMap(*(
                                           torch.as_tensor(np.asarray(x))[None]
                                           for x in cells_j)), g_t, cfg=cfg)
        own = registration.register(kf, st_t.kf_poses, st_t.kf_valid,
                                    cells_t, g_t, cfg=cfg)
        ref_pose = np.asarray(want.pose)
        print(f"frame {fr}: cells {int(cells_j.n)} / {int(cells_t.n[0])}, "
              f"max |d cell mean| "
              f"{np.abs(np.asarray(cells_j.mean) - cells_t.mean[0].numpy()).max():.2e} m; "
              f"on the reference's cells |dpose| "
              f"{np.abs(on_ref.pose[0].numpy() - ref_pose).max():.2e}, "
              f"associations {int(want.num_assoc)} / "
              f"{int(on_ref.num_assoc[0])}; on the port's own cells |dpose| "
              f"{np.abs(own.pose[0].numpy() - ref_pose).max():.2e}, "
              f"associations {int(own.num_assoc[0])}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dropout", type=float, default=0.35)
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", default=None,
                    help="frames of the dropout sequence: the CPU step "
                         "comparison with the reference")
    args = ap.parse_args()
    if args.steps:
        step_equality([int(f) for f in args.steps.split(",")])
        return 0
    if not torch.cuda.is_available():
        print("slam_verify_torch: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke._card()
    print(card, flush=True)
    cfg = chip_smoke.slam_config()
    seq, golden = ((chip_smoke.SLAM_DROPOUT_SEQUENCE,
                    chip_smoke.GOLDEN_SLAM_DROPOUT) if args.dropout else
                   (chip_smoke.SLAM_SEQUENCE, chip_smoke.GOLDEN_SLAM))
    if args.dropout and args.dropout != seq["dropout_prob"]:
        raise SystemExit("--dropout is 0 or chip_smoke's")
    images, _ = slam_scale.make_lap_sequence(cfg, **seq)
    with np.load(golden) as z:
        g = {k: z[k] for k in z.files}
    g_acc = set(map(tuple, g["accepted"].tolist()))
    runner = odometry.OdometryRunner(cfg, chunk=32, ingest="host",
                                     device="cuda")
    runner.process(images)
    sources = {"golden odometry": (chip_smoke.golden_outputs(g), g["poses"]),
               "card odometry": (runner.frame_outputs(),
                                 runner.trajectory())}
    report = {"card": card, "golden_accepted": len(g_acc),
              "golden_candidates": int(g["n_candidates"])}
    for name, (outputs, traj) in sources.items():
        r = close_both(cfg, outputs, traj, images)
        same = r["cuda"]["accepted"] == r["cpu"]["accepted"]
        line = {dev: {"accepted": len(r[dev]["accepted"]),
                      "in the golden's": len(set(r[dev]["accepted"]) & g_acc),
                      "candidates": r[dev]["candidates"],
                      "seconds": round(r[dev]["seconds"], 1)}
                for dev in ("cuda", "cpu")}
        line["nodes"] = r["nodes"]
        line["card set == cpu set"] = same
        if not same:
            a, b = set(r["cuda"]["accepted"]), set(r["cpu"]["accepted"])
            line["only card"] = sorted(a - b)
            line["only cpu"] = sorted(b - a)
        report[name] = line
        print(f"{name}: " + json.dumps(line, default=str), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
