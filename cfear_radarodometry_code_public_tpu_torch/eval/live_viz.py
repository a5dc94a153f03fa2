"""Live trajectory visualization (port of `eval/live_viz.py`), the
RViz-follower equivalent.

The reference publishes live markers to RViz while odometry runs: the
estimated path (`eval_trajectory.cpp:238-251`), odometry TF/pose, and
per-cell debug markers (`pointnormal.cpp:535-664`, configs `rviz/odom.rviz`).
Headless, the live surface is a FILE follower instead of a topic
subscriber: this viewer tails the TUM pose stream the online daemon appends
to (`online_odometry.py` writes each pose as soon as it is estimated), and
re-renders a PNG snapshot — path so far, heading arrow at the newest pose,
run statistics — every refresh interval. The PNG is written atomically
(tmp + rename), so any image viewer or browser polling the file sees
complete frames.

numpy and matplotlib only, matplotlib imported inside the functions; the
functions are the reference's, held equal by
`tests/test_torch_selfcontained.py`. The port imports nothing of the
reference package.

Usage (alongside the online daemon):
  python -m cfear_radarodometry_code_public_tpu_torch.online_odometry \
      --pack run.radarpack --output /tmp/poses.tum --follow &
  python -m cfear_radarodometry_code_public_tpu_torch.eval.live_viz \
      --poses /tmp/poses.tum --out /tmp/live.png --follow --interval 1.0

Without `--follow` it renders one snapshot of the poses currently in the
file and exits.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np


def parse_tum_line(line: str):
    """One TUM line -> (t, x, y, yaw) or None (yaw from qz/qw, z ignored)."""
    parts = line.split()
    if len(parts) != 8:
        return None
    try:
        t, x, y, _z, _qx, _qy, qz, qw = (float(p) for p in parts)
    except ValueError:
        return None
    return t, x, y, 2.0 * math.atan2(qz, qw)


class TumFollower:
    """Incrementally read complete TUM lines from a growing file."""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0
        self._partial = ""
        self.poses: list = []

    def poll(self) -> int:
        """Consume newly appended lines; returns the number added."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return 0
        if size <= self._offset:
            return 0
        with open(self.path, "r") as f:
            f.seek(self._offset)
            chunk = f.read()
            self._offset = f.tell()
        text = self._partial + chunk
        lines = text.split("\n")
        self._partial = lines.pop()      # possibly-incomplete trailing line
        added = 0
        for ln in lines:
            p = parse_tum_line(ln)
            if p is not None:
                self.poses.append(p)
                added += 1
        return added


def render_snapshot(path_png: str, poses, title: str = "") -> None:
    """Render the path + newest-pose heading arrow to `path_png` atomically."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    arr = np.asarray(poses, np.float64)
    fig, ax = plt.subplots(figsize=(7, 7))
    if len(arr):
        ax.plot(arr[:, 1], arr[:, 2], "-", lw=1.0, color="#2a6fb0",
                label=f"path ({len(arr)} poses)")
        t, x, y, yaw = arr[-1]
        span = max(float(np.ptp(arr[:, 1])), float(np.ptp(arr[:, 2])), 10.0)
        ax.plot([x], [y], "o", ms=6, color="#d1495b")
        ax.annotate("", xy=(x + 0.06 * span * math.cos(yaw),
                            y + 0.06 * span * math.sin(yaw)),
                    xytext=(x, y),
                    arrowprops=dict(arrowstyle="->", color="#d1495b", lw=2))
        dist = float(np.sum(np.linalg.norm(np.diff(arr[:, 1:3], axis=0),
                                           axis=1)))
        dt = arr[-1, 0] - arr[0, 0]
        speed = (np.linalg.norm(arr[-1, 1:3] - arr[-2, 1:3])
                 / max(arr[-1, 0] - arr[-2, 0], 1e-9)) if len(arr) > 1 else 0.0
        ax.set_title(f"{title} {len(arr)} poses | {dist:.0f} m | "
                     f"{speed:.1f} m/s | t={t:.1f}")
        ax.legend(loc="upper right", fontsize=8)
    else:
        ax.set_title(f"{title} waiting for poses…")
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    tmp = path_png + ".tmp.png"
    fig.savefig(tmp, dpi=110)
    plt.close(fig)
    os.replace(tmp, path_png)


def main(argv=None):
    ap = argparse.ArgumentParser(description="live TUM trajectory viewer")
    ap.add_argument("--poses", required=True, help="TUM pose file to follow")
    ap.add_argument("--out", required=True, help="output PNG (atomic)")
    ap.add_argument("--follow", action="store_true",
                    help="keep refreshing as the file grows")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--max-refreshes", type=int, default=0,
                    help="stop after N refreshes (0 = until killed)")
    args = ap.parse_args(argv)

    fol = TumFollower(args.poses)
    n_refresh = 0
    while True:
        added = fol.poll()
        if added or n_refresh == 0:
            render_snapshot(args.out, fol.poses,
                            title=os.path.basename(args.poses) + ":")
            n_refresh += 1
        if not args.follow or (args.max_refreshes
                               and n_refresh >= args.max_refreshes):
            break
        time.sleep(args.interval)
    return dict(n_poses=len(fol.poses), n_refreshes=n_refresh)


if __name__ == "__main__":
    main()
