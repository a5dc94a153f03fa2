"""Real-dataset loaders: Oxford Radar RobotCar and MulRan polar sweeps.

Replaces the reference's rosbag ingest (`radar_driver.cpp:74-111`,
`offline_odometry.cpp:64-97`): radar sweeps are read from the standard
released formats —

- Oxford: one PNG per sweep, 400 rows (azimuths) x (11 + 3768) columns; the
  first 11 columns encode timestamp/azimuth metadata and are stripped; file
  names are unix-microsecond timestamps.
- MulRan: one PNG per sweep, range-major (range rows x 400 azimuth
  columns); rotated 90 deg counter-clockwise so rows are azimuths, exactly
  like the reference's generic callback rotates its input
  (`cv::ROTATE_90_COUNTERCLOCKWISE`, `radar_driver.cpp:84`). A plain
  transpose would MIRROR the azimuth order, flipping the scan direction
  and hence the motion-compensation time convention for CCW radars.

Ground truth is read from the released CSVs. Nothing here downloads — all
loaders take local directories and raise clearly when absent.

The port's own copy of the reference's
`cfear_radarodometry_code_public_tpu/datasets/oxford.py` (framework-free;
the port imports nothing of the reference package). The two are held equal
by `tests/test_torch_selfcontained.py`: the loaders give the reference's
arrays on the same files.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np


def _require(path: str):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"dataset path '{path}' does not exist (datasets must be "
            "mounted locally; this environment has no network egress)")


def _read_png(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path))


def oxford_frames(radar_dir: str) -> Iterator[Tuple[float, np.ndarray]]:
    """Yield (timestamp_s, polar uint8 (400, 3768)) from an Oxford
    `radar` directory of <microseconds>.png sweeps."""
    _require(radar_dir)
    names = sorted(f for f in os.listdir(radar_dir) if f.endswith(".png"))
    for name in names:
        img = _read_png(os.path.join(radar_dir, name))
        if img.ndim == 3:
            img = img[..., 0]
        data = img[:, 11:] if img.shape[1] > 3768 else img
        stamp = int(name[:-4]) * 1e-6
        yield stamp, np.ascontiguousarray(data[:, :3768], np.uint8)


def rotate_90_ccw(img: np.ndarray) -> np.ndarray:
    """90 deg counter-clockwise rotation with `cv::rotate(...,
    ROTATE_90_COUNTERCLOCKWISE)` semantics (`radar_driver.cpp:84`):
    dst[i, j] = src[j, W-1-i] (transpose + reverse rows)."""
    return np.rot90(img)


def mulran_frames(radar_dir: str) -> Iterator[Tuple[float, np.ndarray]]:
    """Yield (timestamp_s, polar uint8 (400, R)) from a MulRan
    `polar` directory (<nanoseconds>.png, range-major)."""
    _require(radar_dir)
    names = sorted(f for f in os.listdir(radar_dir) if f.endswith(".png"))
    for name in names:
        img = _read_png(os.path.join(radar_dir, name))
        if img.ndim == 3:
            img = img[..., 0]
        if img.shape[0] > img.shape[1]:   # range-major -> azimuth-major
            img = rotate_90_ccw(img)
        stamp = int(name[:-4]) * 1e-9
        yield stamp, np.ascontiguousarray(img, np.uint8)


def load_gt_csv(path: str, fmt: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
    """Load ground truth as (stamps_s (T,), poses (T, 3) [x, y, yaw]).

    Supports the Oxford `gt/radar_odometry.csv` relative-pose format
    (source_timestamp, destination_timestamp, x, y, z, roll, pitch, yaw —
    integrated into absolute 2-D poses, flattened like
    `offline_odometry.cpp:80-97`) and a generic `stamp,x,y,yaw` CSV.
    """
    _require(path)
    with open(path) as f:
        header = f.readline().strip().split(",")
    data = np.genfromtxt(path, delimiter=",", skip_header=1)
    if fmt == "auto":
        fmt = "oxford_ro" if "source_radar_timestamp" in ",".join(header) \
            or data.shape[1] >= 8 else "xyyaw"
    if fmt == "oxford_ro":
        dx, dy, dyaw = data[:, 2], data[:, 3], data[:, 7]
        poses = np.zeros((len(data) + 1, 3))
        for i in range(len(data)):
            c, s = np.cos(poses[i, 2]), np.sin(poses[i, 2])
            poses[i + 1, 0] = poses[i, 0] + c * dx[i] - s * dy[i]
            poses[i + 1, 1] = poses[i, 1] + s * dx[i] + c * dy[i]
            poses[i + 1, 2] = poses[i, 2] + dyaw[i]
        # pose 0 is at the first row's source stamp; pose k at the
        # destination stamp of row k-1
        stamps = np.concatenate([[data[0, 0]], data[:, 1]]) * 1e-6
        return stamps, poses
    stamps = data[:, 0]
    poses = data[:, 1:4]
    # rebase to the first pose (reference flattens + rebases,
    # `offline_odometry.cpp:86-97`)
    c, s = np.cos(poses[0, 2]), np.sin(poses[0, 2])
    R = np.array([[c, s], [-s, c]])
    xy = (poses[:, :2] - poses[0, :2]) @ R.T
    yaw = poses[:, 2] - poses[0, 2]
    return stamps, np.concatenate([xy, yaw[:, None]], -1)
