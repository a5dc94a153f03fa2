"""Online odometry daemon (port of `online_odometry.py`), the
`cfear_radarodometry_node` equivalent.

The reference's online mode is a long-running ROS node consuming a radar
topic and publishing odometry continuously
(`cfear_radarodometry_node.cpp:24-36`, subscription wiring
`radar_driver.cpp:30-35`). Here the transport is the radar pack file
(`csrc/cfear_io.cpp` byte layout): a recorder process appends fixed-size
sweep records to a pack while this daemon FOLLOWS the file, runs the
incremental odometry pipeline on every new frame, and appends each pose to a
TUM-format output file as soon as it is estimated.

The number of complete frames on disk is `(filesize - 32) // (8 + A*R)`, so
the daemon polls the file size and never trusts the header's frame count (a
live recorder may not know it yet). `models/odometry.OdometryRunner` keeps
its scan-carry state across `process()` calls and steps frame by frame, so
the streamed trajectory is bit for bit the one an offline run of the same
frames gives, however the frames arrive.

The odometry runs on the CUDA card unless the caller asks for the CPU
(`device="cpu"`, `--cpu`); without a card and without that, it raises.
`PackFollower` and `_tum_line` have no framework dependency: they are the
reference's, held equal by `tests/test_torch_selfcontained.py`.

Usage:
  python -m cfear_radarodometry_code_public_tpu_torch.online_odometry \
      --pack /data/run.radarpack --output /tmp/poses.tum --follow

Without `--follow` the daemon drains the frames currently in the pack and
exits (the offline single-pass mode of the same transport).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np

_HDR_BYTES = 32
_MAGIC = 0x5241444152504B31


class PackFollower:
    """Tail a (possibly still growing) radar pack file.

    Reads the header once (blocking until it exists), then yields batches of
    complete frames as the file grows. Frame records are fixed-size
    (8-byte nanosecond stamp + A*R uint8 sweep), so partial trailing writes
    are simply not yet visible as complete frames.
    """

    def __init__(self, path: str, poll_s: float = 0.05,
                 header_timeout_s: float = 30.0):
        self.path = path
        self.poll_s = poll_s
        deadline = time.time() + header_timeout_s
        while True:
            try:
                if os.path.getsize(path) >= _HDR_BYTES:
                    break
            except OSError:
                pass
            if time.time() > deadline:
                raise TimeoutError(f"no pack header at '{path}'")
            time.sleep(poll_s)
        with open(path, "rb") as f:
            hdr = np.frombuffer(f.read(_HDR_BYTES), np.uint64)
        if hdr[0] != _MAGIC:
            raise ValueError(f"'{path}' is not a radar pack")
        self.n_azimuths = int(hdr[2])
        self.n_bins = int(hdr[3])
        self._frame_bytes = 8 + self.n_azimuths * self.n_bins
        self._next = 0

    def available(self) -> int:
        """Complete frames currently on disk."""
        try:
            return max(0, (os.path.getsize(self.path) - _HDR_BYTES)
                       // self._frame_bytes)
        except OSError:
            return 0

    def read_new(self, max_frames: int = 256):
        """Returns (frames (n, A, R) uint8, stamps_s (n,)) of frames not yet
        returned, or None if nothing new is available."""
        avail = self.available()
        n = min(avail - self._next, max_frames)
        if n <= 0:
            return None
        a, r = self.n_azimuths, self.n_bins
        fb = self._frame_bytes
        with open(self.path, "rb") as f:
            f.seek(_HDR_BYTES + self._next * fb)
            raw = np.frombuffer(f.read(n * fb), np.uint8)
        if len(raw) < n * fb:                    # racing a slow writer
            n = len(raw) // fb
            if n == 0:
                return None
            raw = raw[:n * fb]
        rec = raw.reshape(n, fb)
        stamps = rec[:, :8].copy().view(np.uint64)[:, 0].astype(np.float64) \
            * 1e-9
        frames = rec[:, 8:].reshape(n, a, r).copy()
        self._next += n
        return frames, stamps


def _tum_line(stamp: float, xyt) -> str:
    """TUM `t x y z qx qy qz qw` with the 2-D yaw as a z-axis quaternion
    (same convention as the trajectory writer / `eval_trajectory.cpp:185-211`)."""
    qz, qw = math.sin(xyt[2] / 2.0), math.cos(xyt[2] / 2.0)
    return (f"{stamp:.9f} {xyt[0]:.6f} {xyt[1]:.6f} 0.000000 "
            f"0.000000 0.000000 {qz:.9f} {qw:.9f}\n")


class OnlineOdometry:
    """Follow a radar pack, run incremental odometry, stream poses out.

    The output file receives one TUM line per frame, appended and flushed
    as soon as the frame's pose is estimated — a downstream consumer can
    tail it exactly like a ROS topic echo. `device`: the CUDA card by
    default, the CPU only when asked for (`OdometryRunner`'s rule).
    """

    def __init__(self, cfg, pack_path: str, output_path: str,
                 chunk: int = 8, ingest: str = "image",
                 poll_s: float = 0.05, device="cuda"):
        from cfear_radarodometry_code_public_tpu_torch.models.odometry import (
            OdometryRunner)
        self.cfg = cfg
        # the card is checked before the pack is waited for
        self.runner = OdometryRunner(cfg, chunk=chunk, ingest=ingest,
                                     device=device)
        self.follower = PackFollower(pack_path, poll_s=poll_s)
        self.output_path = output_path
        self.poll_s = poll_s
        self.stamps: list = []
        self._emitted = 0

    def _emit(self, out_f) -> int:
        """Append poses of all newly processed frames; returns #new."""
        traj = self.runner.trajectory()          # host f64 composition
        new = 0
        while self._emitted < len(traj):
            out_f.write(_tum_line(self.stamps[self._emitted],
                                  traj[self._emitted]))
            self._emitted += 1
            new += 1
        out_f.flush()
        return new

    def run(self, follow: bool = True, idle_timeout_s: float = 10.0,
            max_frames: int | None = None) -> int:
        """Process frames until the pack stops growing (follow mode) or is
        drained (single pass). Returns the number of frames processed."""
        last_data = time.time()
        with open(self.output_path, "w") as out_f:
            while True:
                got = self.follower.read_new()
                if got is None:
                    if not follow:
                        break
                    if time.time() - last_data > idle_timeout_s:
                        break
                    time.sleep(self.poll_s)
                    continue
                frames, stamps = got
                self.stamps.extend(stamps.tolist())
                self.runner.process(frames)
                self._emit(out_f)
                last_data = time.time()
                if max_frames and self._emitted >= max_frames:
                    break
        return self._emitted

    def trajectory(self) -> np.ndarray:
        return self.runner.trajectory()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pack", required=True,
                    help="radar pack file to read / follow")
    ap.add_argument("--output", required=True,
                    help="TUM-format pose output (appended + flushed live)")
    ap.add_argument("--preset", default="CFEAR-3")
    ap.add_argument("--dataset", default="oxford")
    ap.add_argument("--follow", action="store_true", default=False,
                    help="keep tailing the pack as it grows (online mode); "
                         "otherwise drain and exit")
    ap.add_argument("--idle-timeout", type=float, default=10.0,
                    help="follow mode: exit after this many seconds without "
                         "new frames")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--ingest", choices=("image", "host"), default="host")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    from cfear_radarodometry_code_public_tpu_torch.config import preset
    cfg = preset(args.preset, dataset=args.dataset)
    daemon = OnlineOdometry(cfg, args.pack, args.output, chunk=args.chunk,
                            ingest=args.ingest,
                            device="cpu" if args.cpu else "cuda")
    n = daemon.run(follow=args.follow, idle_timeout_s=args.idle_timeout)
    print(f"processed {n} frames -> {args.output}", file=sys.stderr)
    return n


if __name__ == "__main__":
    main()
