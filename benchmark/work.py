"""The work that a traced window's inputs need, for the roofline metrics.

Counted from the benchmark's own data and plain code, never from the
program: the cells of the rendered sweeps come from the configuration's
plain reference `ref` (`reference.py` unless the configuration names
another; `ref.cells` over the points compensated by the true
previous-frame motion), each lane's keyframes from the keyframe gate
replayed on its drive's true poses, and the associations that survive the
gates from `ref.nearest` at the true poses. Per lockstep step and lane
that gives the valid source cells, the valid target cells of the valid
keyframes, and the surviving associations at the first iteration's radius
(twice the configured one) and at the configured one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import traffic_gen


def frame_cells(ref, drive, keys, params, device, batch: int = 16):
    """Cells of the sweeps `keys` (`Traffic.key`s), each compensated by the
    true motion into its frame -> {key: cell dict (leaves (M, ...))}."""
    out = {}
    keys = list(keys)
    for lo in range(0, len(keys), batch):
        part = keys[lo:lo + batch]
        img = torch.as_tensor(np.stack([drive.sweep(k) for k in part])
                              ).to(device)
        xy, inten, valid = ref.points(img, params)
        if params["odometry"]["compensate"]:
            tm = torch.as_tensor(np.stack([_motion(drive, k) for k in part]),
                                 dtype=torch.float32, device=device)
            xy = ref.compensate(xy, tm, params["radar"]["ccw"])
        c = ref.cells(xy, inten, valid, params)
        out.update({k: {n: v[i] for n, v in c.items()}
                    for i, k in enumerate(part)})
    return out


def _motion(drive, key):
    """The motion the program compensates a sweep by: the previous
    frame's (the first frame of a drive has none)."""
    kind, a, b = key
    if kind == "lap":
        return drive.lap_motion()
    return drive.ramp_motion(a, b - 1) if b > 1 else np.zeros(3)


def keyframe_windows(drive, lane, steps: int, params):
    """The keyframe gate replayed on the true poses of one lane's drive:
    for each step 0..steps-1, the steps of the valid keyframes in the
    window before that step's frame is registered (none for step 0)."""
    odo = params["odometry"]
    size = odo["submap_scan_size"]
    rot = math.radians(odo["keyframe_min_rot_deg"])
    window, out, last = [], [], None
    for t in range(steps):
        out.append(list(window))
        pose = drive.pose(lane, t)
        if last is None:
            fuse = True
        else:
            d = traffic_gen._relative(last, pose)
            fuse = math.hypot(d[0], d[1]) > odo["keyframe_min_dist"] \
                or abs(math.atan2(math.sin(d[2]), math.cos(d[2]))) > rot
        if fuse:
            window = (window + [t])[-size:]
            last = pose
    return out


def counts(ref, drive, first_step: int, steps: int, params, device):
    """Per traced step (first_step .. first_step + steps - 1) and lane of a
    `Traffic` drive, from the reference module `ref`: a dict of int arrays
    (steps, lanes): n_src, n_tar, n_kf, assoc_first (associations
    surviving at twice the radius) and assoc (at the radius)."""
    reg = params["registration"]
    cos_gate = math.cos(math.radians(reg["angle_outlier_deg"]))
    r0 = reg["assoc_radius"]
    total = first_step + steps
    n_lanes = len(drive.lanes)
    windows = [keyframe_windows(drive, j, total, params)
               for j in range(n_lanes)]
    needed = {drive.key(j, t) for j in range(n_lanes)
              for t in range(first_step, total)}
    needed |= {drive.key(j, s) for j in range(n_lanes)
               for t in range(first_step, total) for s in windows[j][t]}
    cells = frame_cells(ref, drive, sorted(needed), params, device)
    res = {k: np.zeros((steps, n_lanes), np.int64)
           for k in ("n_src", "n_tar", "n_kf", "assoc_first", "assoc")}
    for j in range(n_lanes):
        for i in range(steps):
            t = first_step + i
            src = cells[drive.key(j, t)]
            kf_steps = windows[j][t]
            kfs = [cells[drive.key(j, s)] for s in kf_steps]
            res["n_src"][i, j] = int(src["valid"].sum())
            res["n_tar"][i, j] = sum(int(c["valid"].sum()) for c in kfs)
            res["n_kf"][i, j] = len(kfs)
            if not kfs:
                continue
            pose_src = torch.as_tensor(drive.pose(j, t), dtype=torch.float64,
                                       device=device)
            kf_pose = torch.as_tensor(
                np.stack([drive.pose(j, s) for s in kf_steps]),
                dtype=torch.float64, device=device)
            tar = ref.transform(kf_pose, torch.stack(
                [c["mean"] for c in kfs]).double())          # (S, M, 2)
            tar_n = ref.rotate(kf_pose, torch.stack(
                [c["normal"] for c in kfs]).double())
            tar_ok = torch.stack([c["valid"] for c in kfs])
            sw = ref.transform(pose_src, src["mean"].double())
            snw = ref.rotate(pose_src, src["normal"].double())
            nn, d2 = ref.nearest(sw[None], tar[None], tar_ok[None])
            nn, d2 = nn[0], d2[0]                            # (S, Ms)
            kfi = torch.arange(len(kfs), device=device)[:, None]
            sim = torch.clamp((snw[None] * tar_n[kfi, nn]).sum(-1), min=0.0)
            ok = src["valid"][None] & tar_ok[kfi, nn] & (sim > cos_gate)
            res["assoc_first"][i, j] = int((ok & (d2 < (2 * r0) ** 2)).sum())
            res["assoc"][i, j] = int((ok & (d2 < r0 * r0)).sum())
    return res
