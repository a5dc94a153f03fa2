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

Each frame's step also runs in the reference op by op. With `--states
FILE` the reference's states, cells and guesses at those frames are
written to FILE; run again under XLA_FLAGS=--xla_cpu_max_isa=AVX with the
same FILE and the reference's step runs on the same inputs under AVX,
printed against the compiled step the file holds.

The `slam-dropout` pass's own loop edges on the card's odometry, in three
steps. On the card, `--save-odometry FILE` runs the pass
(`chip_smoke.drive_slam`) and writes its odometry, its own accepted edges,
the card's name and power limit, and the runner's checkpoint before the
first frame whose keyframe flag differs from the golden's (about 80 s):

    python tools/slam_verify_torch.py --save-odometry out/card_odometry.npz

Then on the CPU, `--reference-closure FILE` builds the graph with scan
payloads from that odometry in both packages and closes it in the
reference (kernel A in interpret mode, and dense) and in the port, each
accepted set printed beside the card's and the golden's (about 7 minutes;
under XLA_FLAGS=--xla_cpu_max_isa=AVX the reference's alone), and
`--flags FILE` resumes each package from the card's checkpoint and from
the reference's own state at that frame, printing the keyframe flags each
sets over the next four frames (about 1.5 minutes):

    JAX_PLATFORMS=cpu python tools/slam_verify_torch.py --reference-closure FILE
    JAX_PLATFORMS=cpu python tools/slam_verify_torch.py --flags FILE
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
import tempfile
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


def step_equality(frames, states: str | None = None) -> list:
    """`--steps`: the reference's and the port's registration step at each
    of `frames` on the reference's state (see the module's docstring).
    Each frame's step also runs in the reference op by op
    (`jax.disable_jit()`). With `states` (an npz) the reference's states,
    cells and guesses are read from it when it exists (no odometry is run:
    run the tool again under XLA_FLAGS=--xla_cpu_max_isa=AVX for the
    reference's AVX step on the same inputs, printed against the file's
    compiled step) and written to it otherwise. Returns one record a
    frame."""
    import jax
    import jax.numpy as jnp

    from cfear_radarodometry_code_public_tpu.config import CFEARConfig
    from cfear_radarodometry_code_public_tpu.models import odometry as jo
    from cfear_radarodometry_code_public_tpu.ops import (
        features as jfeat, filtering as jf, registration as jreg)
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
    treedef = jax.tree.structure(runner.state)
    extract = jax.jit(lambda s, i: jo._extract_cells(s, i, cfg_j, "compact"))

    def reg_j(st, c, g):
        return jreg.register(st.kf_cells, st.kf_poses, st.kf_valid, c, g,
                             cfg=cfg_j)

    register = jax.jit(reg_j)
    loaded = None
    if states and os.path.exists(states):
        with np.load(states) as z:
            loaded = {k: z[k] for k in z.files}
    saved, done, recs = {}, 0, []
    for fr in frames:
        if loaded is None:
            runner.process(images[done:fr])
            done = fr
            st = runner.state
            cells_j = extract(st, jf.CompactCandidates(
                *(jnp.asarray(np.asarray(a)[fr]) for a in rows)))
            guess = jo.se2.compose(st.t_prev, st.tmot)
            for i, a in enumerate(jax.tree.leaves(st)):
                saved[f"f{fr}_state_{i}"] = np.asarray(a)
            for i, a in enumerate(cells_j):
                saved[f"f{fr}_cells_{i}"] = np.asarray(a)
            saved[f"f{fr}_guess"] = np.asarray(guess)
            with np.load(chip_smoke.GOLDEN_SLAM_DROPOUT) as z:
                saved[f"f{fr}_from_golden"] = float(np.abs(
                    np.asarray(runner.trajectory())[:, :2]
                    - z["poses"][:fr, :2]).max())
        else:
            n_st = treedef.num_leaves
            st = jax.tree.unflatten(treedef, [
                jnp.asarray(loaded[f"f{fr}_state_{i}"]) for i in range(n_st)])
            cells_j = jfeat.CellMap(*(
                jnp.asarray(loaded[f"f{fr}_cells_{i}"])
                for i in range(len(jfeat.CellMap._fields))))
            guess = jnp.asarray(loaded[f"f{fr}_guess"])
        want = register(st, cells_j, guess)
        ref_pose = np.asarray(want.pose)
        with jax.disable_jit():
            eager = np.asarray(reg_j(st, cells_j, guess).pose)
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
        rec = {"frame": fr, "variant": "reference" + _variant(),
               "cells": [int(cells_j.n), int(cells_t.n[0])],
               "max |d cell mean| m": float(np.abs(
                   np.asarray(cells_j.mean) - cells_t.mean[0].numpy()).max()),
               "associations": [int(want.num_assoc),
                                int(on_ref.num_assoc[0]),
                                int(own.num_assoc[0])],
               "reference pose": ref_pose.tolist(),
               "|dpose| op by op": float(np.abs(eager - ref_pose).max()),
               "|dpose| port on the reference's cells": float(np.abs(
                   on_ref.pose[0].numpy() - ref_pose).max()),
               "|dpose| port on its own cells": float(np.abs(
                   own.pose[0].numpy() - ref_pose).max())}
        if f"f{fr}_from_golden" in saved:
            rec["reference odometry to the frame: max |dpos| from the "
                "golden"] = saved[f"f{fr}_from_golden"]
        if loaded is not None and f"f{fr}_pose" in loaded:
            rec["|dpose| against the file's compiled step"] = float(np.abs(
                ref_pose - loaded[f"f{fr}_pose"]).max())
        saved[f"f{fr}_pose"] = ref_pose
        recs.append(rec)
        print("step: " + json.dumps(rec), flush=True)
    if states and loaded is None:
        np.savez_compressed(states, **saved)
    return recs


def save_odometry(path: str) -> None:
    """`--save-odometry`: the `slam-dropout` pass on the card
    (`chip_smoke.drive_slam` over `chip_smoke.SLAM_DROPOUT_SEQUENCE`), its
    odometry (trajectory, keyframe and success flags, covariances) and its
    own accepted loop edges written to `path` with the card's name and
    power limit; with them the card runner's checkpoint (the reference's
    npz layout, keys prefixed `ckpt_`) just before the first frame whose
    keyframe flag differs from the golden's, taken from a second run split
    there, which must repeat the first bit for bit."""
    card = chip_smoke._card()
    print(card, flush=True)
    cfg = chip_smoke.slam_config()
    seq = chip_smoke.SLAM_DROPOUT_SEQUENCE
    images, _ = slam_scale.make_lap_sequence(cfg, **seq)
    dev = torch.device("cuda")
    res = chip_smoke.drive_slam(cfg, images, dev)
    traj, out = res["traj"], res["out"]
    with np.load(chip_smoke.GOLDEN_SLAM_DROPOUT) as z:
        g_fused, g_acc = z["fused"], set(map(tuple, z["accepted"].tolist()))
    differ = np.flatnonzero(out.fused != g_fused)
    first = int(differ[0]) if len(differ) else len(traj)
    runner = odometry.OdometryRunner(cfg, chunk=32, ingest="host",
                                     device=dev)
    runner.process(images[:first])
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.npz")
        runner.save_checkpoint(ck)
        with np.load(ck) as z:
            ckpt = {f"ckpt_{k}": z[k] for k in z.files}
    runner.process(images[first:])
    split_same = bool(np.array_equal(runner.trajectory(), traj)
                      and np.array_equal(runner.frame_outputs().fused,
                                         out.fused))
    accepted = sorted(map(tuple, res["accepted"]))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path, poses=traj, fused=out.fused, success=out.success, cov=out.cov,
        accepted=np.asarray(accepted, np.int64).reshape(-1, 2),
        first_flag_frame=first, flag_frames=differ, card=card,
        config=json.dumps(cfg.to_dict()), sequence=json.dumps(seq),
        split_identical=split_same, **ckpt)
    print(json.dumps({
        "file": path, "card": card, "frames": len(traj),
        "keyframes": int(out.fused.sum()), "accepted": len(accepted),
        "in the golden's": len(set(accepted) & g_acc),
        "flags differ at": differ.tolist(), "checkpoint before": first,
        "split run bit-identical": split_same,
        "all successful": bool(out.success.all())}), flush=True)


def _card_odometry(path: str):
    """The card odometry file `--save-odometry` wrote, as a dict, with the
    slam configuration and the dropout sequence's sweeps; refuses a file
    made for another configuration or sequence."""
    with np.load(path) as z:
        c = {k: z[k] for k in z.files}
    cfg = chip_smoke.slam_config()
    seq = chip_smoke.SLAM_DROPOUT_SEQUENCE
    if json.loads(str(c["config"])) != cfg.to_dict() \
            or json.loads(str(c["sequence"])) != seq:
        raise SystemExit(f"{path} was made for another configuration or "
                         "sequence")
    images, _ = slam_scale.make_lap_sequence(cfg, **seq)
    return c, cfg, images


def _jax_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from cfear_radarodometry_code_public_tpu.config import CFEARConfig
    return CFEARConfig


def _variant() -> str:
    return "-avx" if "max_isa=AVX" in os.environ.get("XLA_FLAGS", "") else ""


def reference_closure(path: str) -> dict:
    """`--reference-closure`: on the CPU, the graph with scan payloads built
    from the card's odometry in both packages (the reference's
    `build_graph_from_odometry`, then `LoopCloser.close_from_graph`, with
    kernel A in interpret mode and with the dense association; the port's
    on the CPU), each accepted set printed beside the card's own pass's
    and the golden's, with the pairs in common."""
    from cfear_radarodometry_code_public_tpu.models import (
        loopclosure as jlc, posegraph as jpg)
    cfg_cls = _jax_cpu()
    c, cfg, images = _card_odometry(path)
    outputs = chip_smoke.golden_outputs(c)
    card_acc = set(map(tuple, c["accepted"].tolist()))
    with np.load(chip_smoke.GOLDEN_SLAM_DROPOUT) as z:
        g_acc = set(map(tuple, z["accepted"].tolist()))
    report = {"card": str(c["card"]), "card accepted": len(card_acc),
              "golden accepted": len(g_acc),
              "card pairs in the golden's": len(card_acc & g_acc)}
    print(json.dumps(report), flush=True)
    sets = {}
    t0 = time.perf_counter()
    gb_j = jpg.build_graph_from_odometry(outputs, c["poses"], images=images,
                                         cfg=cfg_cls.from_dict(cfg.to_dict()))
    payload_s = time.perf_counter() - t0
    for method, label in (("pallas", "kernel-A"), ("dense", "dense")):
        cfg_j = cfg_cls.from_dict(cfg.to_dict())
        cfg_j = cfg_j.replace(registration=dataclasses.replace(
            cfg_j.registration, assoc_method=method))
        t0 = time.perf_counter()
        acc = jlc.LoopCloser(cfg_j).close_from_graph(copy.deepcopy(gb_j))
        sets[label + _variant()] = (acc, time.perf_counter() - t0)
    if not _variant():
        t0 = time.perf_counter()
        gb = posegraph.build_graph_from_odometry(outputs, c["poses"],
                                                 images=images, cfg=cfg,
                                                 device="cpu")
        acc = loopclosure.LoopCloser(cfg, device="cpu").close_from_graph(gb)
        sets["port-cpu"] = (acc, time.perf_counter() - t0)
    for label, (acc, secs) in sets.items():
        acc = set(map(tuple, acc))
        line = {"variant": label, "accepted": len(acc),
                "in the card's": len(acc & card_acc),
                "in the golden's": len(acc & g_acc),
                "only this": sorted(acc - card_acc),
                "only the card": sorted(card_acc - acc),
                "seconds": round(secs, 1)}
        report[label] = line
        print("closure on the card's odometry: " + json.dumps(line,
                                                            default=str),
              flush=True)
    report["reference payload seconds"] = round(payload_s, 1)
    return report


def _keydist(kf_pose, pose) -> float:
    """Distance from the window's last keyframe to a frame's pose, both
    in the anchor frame: the quantity the keyframe gate compares with
    `keyframe_min_dist`."""
    a, b = np.asarray(kf_pose, np.float64), np.asarray(pose, np.float64)
    return float(np.hypot(b[0] - a[0], b[1] - a[1]))


def flag_exchange(path: str, frames: int = 4) -> dict:
    """`--flags`: the first frame whose keyframe flag the card sets
    differently from the golden's (`first_flag_frame` in the card file).
    From the card runner's checkpoint just before it, the reference (kernel
    A in interpret mode) and the port, both on the CPU, run `frames`
    frames; from the reference's own state there (its runner over the
    frames before), the reference and the port on the CPU do the same.
    Prints each side's flags and the distance from the window's last
    keyframe that the gate compares with `keyframe_min_dist`."""
    from cfear_radarodometry_code_public_tpu.models import odometry as jo
    cfg_cls = _jax_cpu()
    c, cfg, images = _card_odometry(path)
    f = int(c["first_flag_frame"])
    cfg_j = cfg_cls.from_dict(cfg.to_dict())
    cfg_j = cfg_j.replace(registration=dataclasses.replace(
        cfg_j.registration, assoc_method="pallas"))
    with np.load(chip_smoke.GOLDEN_SLAM_DROPOUT) as z:
        g_fused, g_poses = z["fused"], z["poses"]
    part = images[f:f + frames]
    gate = cfg.odometry.keyframe_min_dist

    def run(resume, ck, n_before):
        r = resume(ck)
        kf0 = np.asarray(r.state.kf_poses)[-1]
        r.process(part)
        out = r.frame_outputs()
        fused = np.asarray(out.fused)[n_before:]
        pose = np.asarray(out.pose)[n_before]
        return {"fused": np.flatnonzero(fused).tolist(),
                "keydist at the frame": _keydist(kf0, pose)}

    def ref_resume(ck):
        return jo.OdometryRunner.resume(cfg_j, ck, chunk=frames,
                                        ingest="host")

    def port_resume(ck):
        return odometry.OdometryRunner.resume(cfg, ck, device="cpu",
                                              chunk=frames, ingest="host")

    report = {"card": str(c["card"]), "frame": f, "frames": frames,
              "gate m": gate,
              "card flags": np.flatnonzero(c["fused"][f:f + frames]).tolist(),
              "golden flags": np.flatnonzero(g_fused[f:f + frames]).tolist()}
    with tempfile.TemporaryDirectory() as tmp:
        ck_card = os.path.join(tmp, "card.npz")
        np.savez(ck_card, **{k[5:]: v for k, v in c.items()
                             if k.startswith("ckpt_")})
        report["from the card's state"] = {
            "reference": run(ref_resume, ck_card, f),
            "port-cpu": run(port_resume, ck_card, f)}
        t0 = time.perf_counter()
        ref = jo.OdometryRunner(cfg_j, chunk=32, ingest="host")
        ref.process(images[:f])
        ref_traj = np.asarray(ref.trajectory())
        report["reference odometry to the frame: max |dpos| from the "
               "golden"] = float(np.abs(ref_traj[:, :2]
                                        - g_poses[:f, :2]).max())
        report["reference odometry seconds"] = round(
            time.perf_counter() - t0, 1)
        ck_ref = os.path.join(tmp, "ref.npz")
        ref.save_checkpoint(ck_ref)
        report["from the reference's state"] = {
            "reference": run(ref_resume, ck_ref, f),
            "port-cpu": run(port_resume, ck_ref, f)}
    print("flags: " + json.dumps(report), flush=True)
    return report


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dropout", type=float, default=0.35)
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", default=None,
                    help="frames of the dropout sequence: the CPU step "
                         "comparison with the reference")
    ap.add_argument("--save-odometry", default=None, metavar="FILE",
                    help="on the card: write the slam-dropout pass's "
                         "odometry, accepted edges and checkpoint to FILE")
    ap.add_argument("--states", default=None, metavar="FILE",
                    help="--steps: the reference's states at the frames, "
                         "read from FILE if it exists, else written to it")
    ap.add_argument("--reference-closure", default=None, metavar="FILE",
                    help="on the CPU: close the graph from the card "
                         "odometry FILE in both packages")
    ap.add_argument("--flags", default=None, metavar="FILE",
                    help="on the CPU: the first differing keyframe flag "
                         "from the card's and the reference's states")
    args = ap.parse_args()
    if args.reference_closure or args.flags:
        report = (reference_closure(args.reference_closure)
                  if args.reference_closure else flag_exchange(args.flags))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1, default=str)
        return 0
    if args.save_odometry:
        if not torch.cuda.is_available():
            print("slam_verify_torch: no CUDA device", file=sys.stderr)
            return 2
        save_odometry(args.save_odometry)
        return 0
    if args.steps:
        recs = step_equality([int(f) for f in args.steps.split(",")],
                             args.states)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(recs, f, indent=1)
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
