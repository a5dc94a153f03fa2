"""Offline visualization — the RViz-marker equivalent.

The reference publishes normal-arrow markers, association arrows and paths to
RViz (`pointnormal.cpp:399-664`, `eval_trajectory.cpp:238-251`). Headless
matplotlib renderings of the same artifacts:

- `plot_scan`: polar sweep + filtered points + oriented surface points
  (cell means with normal arrows, covariance ellipses)
- `plot_associations`: source and target cells with association lines
- `plot_trajectory`: est vs GT paths with keyframe marks
- `plot_cost_surface`: a registration cost surface
  (`registration.cost_surface`)

The port's own copy of the reference's
`cfear_radarodometry_code_public_tpu/eval/viz.py`; numpy and matplotlib
only, matplotlib imported inside the functions. The port imports nothing of
the reference package.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_scan(path, image, points_xy=None, cells=None, max_range=None):
    plt = _mpl()
    fig, axes = plt.subplots(1, 2, figsize=(14, 7))
    axes[0].imshow(np.asarray(image), aspect="auto", cmap="viridis",
                   origin="lower")
    axes[0].set_title("polar sweep (azimuth x range)")
    ax = axes[1]
    if points_xy is not None:
        p = np.asarray(points_xy)
        ax.plot(p[:, 0], p[:, 1], ".", ms=1, alpha=0.4, label="points")
    if cells is not None:
        valid = np.asarray(cells.valid)
        mean = np.asarray(cells.mean)[valid]
        normal = np.asarray(cells.normal)[valid]
        ax.quiver(mean[:, 0], mean[:, 1], normal[:, 0], normal[:, 1],
                  color="r", width=2e-3, scale=40, label="normals")
        ax.plot(mean[:, 0], mean[:, 1], "r.", ms=2)
    ax.plot([0], [0], "k^", ms=10, label="sensor")
    ax.set_aspect("equal")
    ax.legend(loc="upper right")
    if max_range:
        ax.set_xlim(-max_range, max_range)
        ax.set_ylim(-max_range, max_range)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_associations(path, src_means, tar_means, tar_idx, valid):
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(9, 9))
    src = np.asarray(src_means)
    tar = np.asarray(tar_means)
    ok = np.asarray(valid)
    ax.plot(tar[:, 0], tar[:, 1], "b.", ms=3, label="target cells")
    ax.plot(src[:, 0], src[:, 1], "r.", ms=3, label="source cells")
    for i in np.where(ok)[0]:
        j = int(np.asarray(tar_idx)[i])
        ax.plot([src[i, 0], tar[j, 0]], [src[i, 1], tar[j, 1]],
                "g-", lw=0.4, alpha=0.6)
    ax.set_aspect("equal")
    ax.legend()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_trajectory(path, est_xyt, gt_xyt=None, fused=None):
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(9, 9))
    est = np.asarray(est_xyt)
    ax.plot(est[:, 0], est[:, 1], "b-", lw=1.2, label="estimate")
    if gt_xyt is not None:
        gt = np.asarray(gt_xyt)
        ax.plot(gt[:, 0], gt[:, 1], "k--", lw=1.0, label="ground truth")
    if fused is not None:
        kf = est[np.asarray(fused, bool)]
        ax.plot(kf[:, 0], kf[:, 1], "ro", ms=3, label="keyframes")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_cost_surface(path, surface, extent):
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(np.asarray(surface), origin="lower", extent=extent,
                   cmap="magma")
    fig.colorbar(im, ax=ax, label="cost")
    ax.set_xlabel("x offset [m]")
    ax.set_ylabel("y offset [m]")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
