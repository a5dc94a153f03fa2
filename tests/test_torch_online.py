"""The port's online daemon (`online_odometry.py`) and live viewer
(`eval/live_viz.py`) against the reference's, on the cases of
`tests/test_online_daemon.py` with the same packs and seeds, on the CPU.

Tolerances: the port's daemon steps frame by frame whatever batches the
pack delivers, so its trajectory is bit for bit its offline runner's on the
same frames, and its TUM lines are that trajectory as `_tum_line` prints
it. Against the reference's daemon on the same pack: the reference test's
own bound, 2 cm on positions (`tests/test_online_daemon.py:77-80`), and
identical stamps and line counts. The viewer's parsed poses and its PNG
equal the reference viewer's on the same TUM file, byte for byte.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from torch_port_helpers import both_cfgs

from cfear_radarodometry_code_public_tpu.config import preset
from cfear_radarodometry_code_public_tpu.datasets import synthetic
from cfear_radarodometry_code_public_tpu.eval import live_viz as jviz
from cfear_radarodometry_code_public_tpu import online_odometry as jonl
from cfear_radarodometry_code_public_tpu_torch.eval import live_viz as tviz
from cfear_radarodometry_code_public_tpu_torch.models import odometry as todo
from cfear_radarodometry_code_public_tpu_torch import online_odometry as tonl
from cfear_radarodometry_code_public_tpu_torch.utils import native_io

POS_TOL = 2e-2   # tests/test_online_daemon.py:77-80


def _cfg():
    """`tests/test_online_daemon.py:18`."""
    cfg = preset("CFEAR-3", dataset="synthetic")
    return both_cfgs(cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=256),
        filter=dataclasses.replace(cfg.filter, k_strongest=8)))


def _write_header(path, a, r):
    hdr = np.array([0x5241444152504B31, 0, a, r], np.uint64)
    with open(path, "wb") as f:
        f.write(hdr.tobytes())


def _append_frame(path, stamp_s, img):
    with open(path, "ab") as f:
        f.write(np.uint64(int(stamp_s * 1e9)).tobytes())
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def _tum_rows(path):
    with open(path) as f:
        lines = f.read().strip().splitlines()
    return lines, np.array([[float(v) for v in ln.split()] for ln in lines])


def _offline(cfg_t, images, chunk=4):
    runner = todo.OdometryRunner(cfg_t, chunk=chunk, ingest="host",
                                 device="cpu")
    runner.process(images)
    return runner.trajectory()


def _reference_drain(cfg_j, pack, out, chunk=4):
    """The reference's daemon over the finished pack (drain mode)."""
    daemon = jonl.OnlineOdometry(cfg_j, pack, out, chunk=chunk,
                                 ingest="host")
    n = daemon.run(follow=False)
    return n, np.asarray(daemon.trajectory())


def test_follow_growing_pack_matches_offline(tmp_path):
    """`tests/test_online_daemon.py:35`: a recorder thread appends sweeps
    while the port's daemon follows. Every frame is processed and emitted
    once, with monotone stamps; the trajectory and the streamed lines are
    bit for bit the port's offline run, and within the reference test's
    bound of the reference's daemon on the same pack."""
    cfg_j, cfg_t = _cfg()
    n = 24
    images, _ = synthetic.make_sequence(seed=31, n_frames=n, cfg=cfg_j,
                                        speed=5.0)
    pack = str(tmp_path / "live.radarpack")
    out = str(tmp_path / "poses.tum")
    _write_header(pack, images.shape[1], images.shape[2])

    def recorder():
        for i in range(n):
            _append_frame(pack, i * cfg_j.radar.sensor_period, images[i])
            time.sleep(0.03)

    th = threading.Thread(target=recorder, daemon=True)
    th.start()
    daemon = tonl.OnlineOdometry(cfg_t, pack, out, chunk=4, ingest="host",
                                 poll_s=0.02, device="cpu")
    processed = daemon.run(follow=True, idle_timeout_s=8.0)
    th.join()
    assert processed == n

    lines, streamed = _tum_rows(out)
    assert len(lines) == n
    assert np.all(np.diff(streamed[:, 0]) > 0)
    traj = daemon.trajectory()
    offline = _offline(cfg_t, images)
    np.testing.assert_array_equal(traj, offline)
    assert lines == [tonl._tum_line(daemon.stamps[i], offline[i]).strip()
                     for i in range(n)]
    n_j, traj_j = _reference_drain(cfg_j, pack, str(tmp_path / "ref.tum"))
    assert n_j == n
    np.testing.assert_allclose(traj[:, :2], traj_j[:, :2], atol=POS_TOL)
    np.testing.assert_allclose(streamed[:, 1:3], traj_j[:, :2], atol=POS_TOL)


def test_drain_mode_without_follow(tmp_path):
    """`tests/test_online_daemon.py:84`: a finished pack written by the
    port's native writer is drained without waiting for the idle timeout;
    the reference's daemon reads the same pack to the same stamps."""
    cfg_j, cfg_t = _cfg()
    n = 8
    images, _ = synthetic.make_sequence(seed=32, n_frames=n, cfg=cfg_j)
    pack = str(tmp_path / "done.radarpack")
    native_io.pack_frames(
        pack, ((i * 0.25, images[i]) for i in range(n)), n)
    out, out_j = str(tmp_path / "poses.tum"), str(tmp_path / "ref.tum")
    t0 = time.time()
    daemon = tonl.OnlineOdometry(cfg_t, pack, out, chunk=4, ingest="host",
                                 device="cpu")
    assert daemon.run(follow=False) == n
    assert time.time() - t0 < 60.0
    lines, rows = _tum_rows(out)
    assert len(lines) == n
    np.testing.assert_array_equal(daemon.trajectory(),
                                  _offline(cfg_t, images))
    n_j, traj_j = _reference_drain(cfg_j, pack, out_j)
    lines_j, rows_j = _tum_rows(out_j)
    assert n_j == n
    assert [ln.split()[0] for ln in lines] == [ln.split()[0] for ln in lines_j]
    np.testing.assert_allclose(rows[:, 1:3], rows_j[:, 1:3], atol=POS_TOL)


def test_pack_follower_ignores_partial_records(tmp_path):
    """`tests/test_online_daemon.py:104`: a partially written trailing
    record does not surface as a frame; both followers return the same
    frames and stamps."""
    a, r = 16, 32
    pack = str(tmp_path / "partial.radarpack")
    _write_header(pack, a, r)
    img = np.arange(a * r, dtype=np.uint8).reshape(a, r)
    _append_frame(pack, 1.0, img)
    with open(pack, "ab") as f:          # half a record
        f.write(b"\x00" * ((8 + a * r) // 2))
    got, want = tonl.PackFollower(pack), jonl.PackFollower(pack)
    assert got.available() == want.available() == 1
    (frames, stamps), (frames_j, stamps_j) = got.read_new(), want.read_new()
    assert len(frames) == 1
    np.testing.assert_array_equal(frames[0], img)
    np.testing.assert_array_equal(frames, frames_j)
    np.testing.assert_array_equal(stamps, stamps_j)
    assert got.read_new() is None and want.read_new() is None


def test_live_viz_follows_daemon_output(tmp_path):
    """`tests/test_online_daemon.py:122`: a recorder grows the pack, the
    port's daemon follows it appending TUM poses, and the port's live
    viewer picks them up and renders a snapshot: the poses it parses and
    the PNG it writes are the reference viewer's on the same file."""
    cfg_j, cfg_t = _cfg()
    images, _ = synthetic.make_sequence(seed=13, n_frames=14, cfg=cfg_j,
                                        speed=6.0)
    pack = str(tmp_path / "run.radarpack")
    tum = str(tmp_path / "poses.tum")
    a, r = images.shape[1], images.shape[2]
    _write_header(pack, a, r)
    for i in range(6):
        _append_frame(pack, i * 0.25, images[i])

    def recorder():
        for i in range(6, len(images)):
            time.sleep(0.15)
            _append_frame(pack, i * 0.25, images[i])

    th = threading.Thread(target=recorder, daemon=True)
    th.start()
    daemon = tonl.OnlineOdometry(cfg_t, pack, tum, chunk=4, ingest="host",
                                 device="cpu")
    daemon.run(follow=True, idle_timeout_s=3.0)
    th.join()

    fol, fol_j = tviz.TumFollower(tum), jviz.TumFollower(tum)
    assert fol.poll() == fol_j.poll() == len(images)
    assert fol.poses == fol_j.poses
    png, png_j = str(tmp_path / "live.png"), str(tmp_path / "ref.png")
    tviz.render_snapshot(png, fol.poses, title="run:")
    jviz.render_snapshot(png_j, fol_j.poses, title="run:")
    with open(png, "rb") as f, open(png_j, "rb") as g:
        data = f.read()
        assert len(data) > 0 and data == g.read()
    # the viewer's CLI: one snapshot of the file, then exit
    res = tviz.main(["--poses", tum, "--out", str(tmp_path / "cli.png")])
    assert res == {"n_poses": len(images), "n_refreshes": 1}


def test_online_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """Without a card, `OnlineOdometry` and the CLI raise unless the CPU
    is asked for (`device="cpu"`, `--cpu`); with `--cpu` the CLI drains a
    pack of the synthetic preset to the offline runner's poses, bit for
    bit."""
    cfg_j, cfg_t = _cfg()
    images, _ = synthetic.make_sequence(seed=5, n_frames=3, cfg=cfg_j)
    pack = str(tmp_path / "p.radarpack")
    native_io.pack_frames(pack, ((i * 0.25, images[i]) for i in range(3)), 3)
    out = str(tmp_path / "poses.tum")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tonl.OnlineOdometry(cfg_t, pack, out)
    args = ["--pack", pack, "--output", out, "--dataset", "synthetic"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tonl.main(args)
    assert tonl.main(args + ["--cpu"]) == 3
    runner = todo.OdometryRunner(
        both_cfgs(preset("CFEAR-3", dataset="synthetic"))[1], ingest="host",
        device="cpu")
    runner.process(images)
    lines, _ = _tum_rows(out)
    want = runner.trajectory()
    assert [ln.split()[1:3] for ln in lines] == \
        [[f"{x:.6f}", f"{y:.6f}"] for x, y in want[:, :2]]
