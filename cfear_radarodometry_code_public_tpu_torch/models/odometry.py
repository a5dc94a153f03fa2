"""Keyframe odometry pipeline (port of `models/odometry.py`).

The per-frame pipeline is a pure function of (state, frame) written over
a leading lane axis: `make_batched_step` runs B sequences in lockstep (the
throughput path), `make_step` is the same function at B = 1
on unbatched tensors. Device poses are ANCHOR-RELATIVE: fusing a keyframe
rebases the anchor to it, so f32 coordinates stay within the submap; the
host composes the global f64 trajectory (`compose_trajectory`).

Keyframe window: a FIFO ring of S cell maps (`AddToReference`,
`odometrykeyframefuser.cpp:470-476`); keyframe gate 1.5 m / 5 deg
(`:62-73`); constant-velocity guess (`:164-168`); motion compensation with
the previous frame motion (`:146-150`); velocity/acceleration sanity
fallback (`:76-94,197-199`).

Optional branches of the reference's `_fuse_frame`, all ported: the
reverse-registration health check (`odometry.health_check_every`), the
cost-sampling covariance (`odometry.estimate_cov_by_sampling`) and
time-continuous registration (`registration.time_continuous`: the velocity
warp at cell level instead of the cloud-level compensation).

Ingest kinds: "image" (raw uint8 sweeps, filtered on the device by
`filtering.filter_polar_image`), "compact"
(`native_io.filter_frames_host_compact` rows, the host ingest when
`feature.point_budget` is set and the filter is k-strongest) and
"candidates" (`native_io.filter_frames_host`, or
`native_io.cfar_filter_frames_host` with `filter.method="cacfar"`). With
`feature.use_raw_pointcloud` each filtered point is a cell
(`features.compute_raw_cells`). `make_chunk_runner` is the reference's
chunk scan of the step, a plain loop here.

`OdometryRunner` runs on the CUDA card unless it is given `device="cpu"`;
without a card it raises. Like the reference's, it takes raw sweeps to the
device by default (`ingest="image"`); `ingest="host"` filters them on host
threads first.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
from typing import NamedTuple

import numpy as np
import torch

from cfear_radarodometry_code_public_tpu_torch.utils import native_io
from cfear_radarodometry_code_public_tpu_torch.ops import (
    features, filtering, registration)
from cfear_radarodometry_code_public_tpu_torch.ops.features import CellMap
from cfear_radarodometry_code_public_tpu_torch.utils import se2, trace


class OdometryState(NamedTuple):
    """Scan-carry state (anchor-relative poses). Leaves carry a leading
    lane axis in the batched step. The field order is the reference's, so
    the flattened leaves (`state_leaves`) match its checkpoint layout."""

    kf_cells: CellMap          # (S, M, ...) keyframe cells, local frames
    kf_poses: torch.Tensor     # (S, 3) keyframe poses in the anchor frame
    kf_valid: torch.Tensor     # (S,) bool
    t_prev: torch.Tensor       # (3,) previous frame pose in the anchor frame
    tmot: torch.Tensor         # (3,) previous frame-to-frame motion
    initialized: torch.Tensor  # bool
    distance: torch.Tensor     # accumulated keyframe distance (m)
    frame_nr: torch.Tensor     # int32
    kf_count: torch.Tensor     # int32


class FrameOutput(NamedTuple):
    pose: torch.Tensor         # (3,) frame pose in the PRE-rebase anchor frame
    shift: torch.Tensor        # (3,) anchor rebase applied this frame
    fused: torch.Tensor        # bool — became a keyframe
    cov: torch.Tensor          # (3, 3)
    success: torch.Tensor      # bool
    score: torch.Tensor
    num_assoc: torch.Tensor
    num_cells: torch.Tensor
    reg_iterations: torch.Tensor
    # reverse-registration health signal (odometry.health_check_every):
    # unchecked frames carry (checked=False, healthy=True, 0, 0)
    health_checked: torch.Tensor   # bool
    healthy: torch.Tensor          # bool
    health_dist: torch.Tensor      # m — forward/backward discrepancy
    health_rot: torch.Tensor       # rad


INGEST_KINDS = ("image", "compact", "candidates")


def check_supported(cfg, ingest: str) -> None:
    """Raise for an unknown ingest kind and for settings the port does not
    run (`registration.check_supported`)."""
    if ingest not in INGEST_KINDS:
        raise ValueError(f"unknown ingest kind '{ingest}'; one of "
                         f"{INGEST_KINDS}")
    registration.check_supported(cfg)


def resolve_device(device, who: str = "OdometryRunner") -> torch.device:
    """The device an entry point runs on: the CUDA card by default, the CPU
    only when the caller asks for it; raises when asked for a card and
    there is none (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on a CUDA card by default and found none; pass "
            "device='cpu' to run on the CPU")
    return device


def _rebuild(like, items):
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def _map(fn, tree):
    """Apply fn to every tensor leaf of nested (Named)tuples."""
    if isinstance(tree, tuple):
        return _rebuild(tree, [_map(fn, t) for t in tree])
    return fn(tree)


def _map2(fn, a, b):
    if isinstance(a, tuple):
        return _rebuild(a, [_map2(fn, x, y) for x, y in zip(a, b)])
    return fn(a, b)


def _lane_select(pred, a, b):
    """Per-lane where over matching trees; pred (B,)."""
    return _map2(lambda x, y: torch.where(
        pred.reshape(pred.shape + (1,) * (x.dim() - 1)), x, y), a, b)


def state_leaves(state: OdometryState) -> list:
    """Flattened leaves in the reference's pytree order."""
    return [*state.kf_cells, *state[1:]]


def state_from_numpy(leaves, device) -> OdometryState:
    """An `OdometryState` from flattened leaves in the reference's order
    (a JAX `OdometryState`'s `jax.tree.flatten` leaves, or the `state_*`
    arrays of a checkpoint), as tensors on `device`."""
    ts = [torch.as_tensor(np.array(a)).to(device) for a in leaves]
    n = len(CellMap._fields)
    return OdometryState(CellMap(*ts[:n]), *ts[n:])


def init_state(cfg, device, batch: int | None = None,
               dtype=torch.float32) -> OdometryState:
    """Empty state; with `batch`, every leaf gets a leading lane axis."""
    s = cfg.odometry.submap_scan_size
    m = cfg.feature.max_cells_raw if cfg.feature.use_raw_pointcloud \
        else cfg.feature.max_cells
    lead = () if batch is None else (batch,)

    def z(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    return OdometryState(
        kf_cells=CellMap(mean=z(s, m, 2), normal=z(s, m, 2), cov=z(s, m, 2, 2),
                         nsamples=z(s, m), planarity=z(s, m),
                         valid=z(s, m, dt=torch.bool)),
        kf_poses=z(s, 3), kf_valid=z(s, dt=torch.bool), t_prev=z(3),
        tmot=z(3), initialized=z(dt=torch.bool), distance=z(),
        frame_nr=z(dt=torch.int32), kf_count=z(dt=torch.int32))


def _push_keyframe(state: OdometryState, cells: CellMap, pose):
    """FIFO-push a keyframe per lane and rebase the anchor to its pose."""
    def push(buf, c):
        return torch.cat([buf[:, 1:], c[:, None]], 1)

    new_cells = CellMap(*(push(a, c) for a, c in zip(state.kf_cells, cells)))
    poses = push(state.kf_poses, pose)
    poses = se2.compose(se2.inverse(pose)[:, None], poses)  # new kf at identity
    valid = push(state.kf_valid, torch.ones_like(state.kf_valid[:, 0]))
    return new_cells, poses, valid


def _extract_cells(states: OdometryState, inputs, cfg, ingest: str):
    """Front half of the batched step: raw sweeps (B, A, R) or host-filtered
    rows -> points -> motion compensation -> oriented surface points
    (B, M, ...). The profiler ranges carry the reference's stage names."""
    with trace.span("Filtering"):
        if ingest == "compact":
            pts = filtering.points_from_compact(inputs, cfg)
        elif ingest == "candidates":
            pts = filtering.points_from_candidates(inputs, cfg)
        else:
            pts = filtering.filter_polar_image(inputs, cfg)
    # with time-continuous registration the velocity warp moves to the
    # cells (`_fuse_frame`); both would compensate the distortion twice
    if cfg.odometry.compensate and not cfg.registration.time_continuous:
        with trace.span("compensate"):
            pts = pts._replace(xy=se2.compensate_points(pts.xy, states.tmot,
                                                        cfg.radar.ccw))
    with trace.span("build_normals"):
        if cfg.feature.use_raw_pointcloud:
            return features.compute_raw_cells(pts, cfg)
        return features.compute_cells_batched(pts, cfg)


def _fuse_frame(state: OdometryState, cells: CellMap, cfg):
    """Back half of the batched step: register against the keyframe window,
    sanity gates, keyframe fusion."""
    odo = cfg.odometry
    rot_gate = math.radians(odo.keyframe_min_rot_deg)
    dt = cfg.radar.sensor_period
    guess = se2.compose(state.t_prev, state.tmot) if odo.use_guess \
        else state.t_prev
    if cfg.registration.time_continuous:
        # `RegisterTimeContinuous` (`n_scan_normal.cpp:67-80`): the cells
        # are warped by the previous frame motion before the solve, and the
        # warped cells enter the keyframe window
        with trace.span("compensate"):
            cells = features.compensate_cells(cells, state.tmot,
                                              cfg.radar.ccw)
    with trace.span("register"):
        res = registration.register(state.kf_cells, state.kf_poses,
                                    state.kf_valid, cells, guess, cfg=cfg)
    t_cur = torch.where(res.success[:, None], res.pose, guess)
    tmot_cur = se2.relative(state.t_prev, t_cur)
    vel = _norm2(tmot_cur[:, 0], tmot_cur[:, 1]) / dt
    acc = _norm2(tmot_cur[:, 0] - state.tmot[:, 0],
                 tmot_cur[:, 1] - state.tmot[:, 1]) / (dt * dt)
    sane = (vel <= odo.vel_limit) & (acc <= odo.acc_limit)
    t_cur = torch.where(sane[:, None], t_cur, guess)
    tmot = se2.relative(state.t_prev, t_cur)

    cov = res.cov
    if odo.estimate_cov_by_sampling:
        # (`odometrykeyframefuser.cpp:203-208`): the sampled covariance
        # where the fitted quadratic is convex
        with trace.span("sample_covariance"):
            cov_s, convex = registration.sample_covariance(
                state.kf_cells, state.kf_poses, state.kf_valid, cells, t_cur,
                cfg)
        cov = torch.where(convex[:, None, None], cov_s, cov)
    checked, healthy, h_dist, h_rot = _health_check(state, cells, t_cur, cfg)

    keydiff = se2.relative(state.kf_poses[:, -1], t_cur)
    keydist = _norm2(keydiff[:, 0], keydiff[:, 1])
    fuse = (keydist > odo.keyframe_min_dist) \
        | (se2.normalize_angle(keydiff[:, 2]).abs() > rot_gate)
    if not odo.use_keyframe:
        fuse = torch.ones_like(fuse)
    fuse = fuse & res.success

    kfc, kfp, kfv = _push_keyframe(state, cells, t_cur)
    fused_state = state._replace(
        kf_cells=kfc, kf_poses=kfp, kf_valid=kfv,
        t_prev=torch.zeros_like(guess), tmot=tmot,
        distance=state.distance + keydist,
        frame_nr=state.frame_nr + 1, kf_count=state.kf_count + 1)
    plain_state = state._replace(t_prev=t_cur, tmot=tmot,
                                 frame_nr=state.frame_nr + 1)
    new_state = _lane_select(fuse, fused_state, plain_state)
    out = FrameOutput(
        pose=t_cur, shift=torch.where(fuse[:, None], t_cur,
                                      torch.zeros_like(t_cur)),
        fused=fuse, cov=cov, success=res.success, score=res.score,
        num_assoc=res.num_assoc, num_cells=cells.n,
        reg_iterations=res.iterations, health_checked=checked,
        healthy=healthy, health_dist=h_dist, health_rot=h_rot)
    return new_state, out


def _health_check(state: OdometryState, cells: CellMap, t_cur, cfg):
    """Reverse-registration health check (`health_check_every`): on a
    checked frame, the last keyframe's cells are registered against the
    current cells placed at t_cur (the reverse problem, guess = the stored
    keyframe pose), and the discrepancy from the stored pose is the health
    signal. A checked frame is healthy only if the reverse solve succeeded
    and the discrepancy is within both limits. The reference branches with
    `lax.cond`, which under vmap runs both sides; here the reverse solve
    runs only on steps where some lane is checked, over all lanes, and the
    lanes that are not checked are masked. Returns (checked, healthy,
    dist, rot), each (B,)."""
    odo = cfg.odometry
    b = t_cur.shape[0]
    zero = t_cur.new_zeros(b)
    no = torch.zeros(b, dtype=torch.bool, device=t_cur.device)
    if not odo.health_check_every:
        return no, ~no, zero, zero
    checked = (torch.remainder(state.frame_nr, odo.health_check_every) == 0) \
        & state.kf_valid[:, -1]
    if not trace.item("sync.health_check", checked.any()):
        return checked, ~no, zero, zero
    # the reverse solve always registers (a disable_registration ablation
    # would otherwise echo its guess and report healthy)
    cfg_rev = cfg.replace(registration=dataclasses.replace(
        cfg.registration, disable_registration=False))
    with trace.span("health_check"):
        res = registration.register(
            CellMap(*(a[:, None] for a in cells)), t_cur[:, None],
            torch.ones((b, 1), dtype=torch.bool, device=t_cur.device),
            CellMap(*(a[:, -1] for a in state.kf_cells)),
            state.kf_poses[:, -1], cfg=cfg_rev)
    d = se2.relative(state.kf_poses[:, -1], res.pose)
    h_dist = torch.where(checked, _norm2(d[:, 0], d[:, 1]), zero)
    h_rot = torch.where(checked, se2.normalize_angle(d[:, 2]).abs(), zero)
    # a failed reverse solve echoes its guess (d == 0): only its success
    # flag tells it from an agreeing one
    healthy = ~checked | (res.success & (h_dist <= odo.health_max_dist)
                          & (h_rot <= math.radians(odo.health_max_rot_deg)))
    return checked, healthy, h_dist, h_rot


def _norm2(x, y):
    return torch.sqrt(x * x + y * y)


def _unbatched(fn):
    """fn over lane-batched (state, input) -> the same over one lane."""
    def one(state, inp):
        out = fn(_map(lambda a: a[None], state), _map(lambda a: a[None], inp))
        return _map(lambda a: a[0], out)
    return one


def make_bootstrap(cfg, ingest: str = "compact", batched: bool = False):
    """First-frame initialisation (`odometrykeyframefuser.cpp:171-177`):
    the frame's cells become the first keyframe at the identity."""
    check_supported(cfg, ingest)

    def bootstrap(states: OdometryState, inputs):
        cells = _extract_cells(states, inputs, cfg, ingest)
        b = states.t_prev.shape[0]
        ident = torch.zeros_like(states.t_prev)
        kfc, kfp, kfv = _push_keyframe(states, cells, ident)
        ones = torch.ones(b, dtype=torch.bool, device=ident.device)
        izero = torch.zeros(b, dtype=torch.int32, device=ident.device)
        zero = ident[:, 0]
        new_states = states._replace(
            kf_cells=kfc, kf_poses=kfp, kf_valid=kfv, t_prev=ident,
            initialized=ones, frame_nr=states.frame_nr + 1,
            kf_count=torch.ones_like(states.kf_count))
        out = FrameOutput(
            pose=ident, shift=ident, fused=ones,
            cov=torch.eye(3, dtype=ident.dtype, device=ident.device
                          ).expand(b, 3, 3).clone(),
            success=ones, score=zero, num_assoc=izero, num_cells=cells.n,
            reg_iterations=izero, health_checked=~ones, healthy=ones,
            health_dist=zero, health_rot=zero)
        return new_states, out

    return bootstrap if batched else _unbatched(bootstrap)


def make_batched_step(cfg, ingest: str = "compact"):
    """Per-frame step over B sequences in lockstep: (states, inputs) with a
    leading lane axis on every leaf -> (states, FrameOutput). The states
    must be initialised (`make_bootstrap(..., batched=True)`)."""
    check_supported(cfg, ingest)

    def stepb(states: OdometryState, inputs):
        cells = _extract_cells(states, inputs, cfg, ingest)
        return _fuse_frame(states, cells, cfg)

    return stepb


def make_step(cfg, ingest: str = "compact"):
    """Per-frame step of one sequence (unbatched state and input)."""
    return _unbatched(make_batched_step(cfg, ingest))


def make_chunk_runner(cfg, ingest: str = "image"):
    """The reference's jitted `lax.scan` of `make_step` over a chunk of
    frames: `run_chunk(state, inputs)` with a leading T axis on the inputs
    ((T, A, R) sweeps for "image", stacked host rows otherwise) returns
    (state, FrameOutput with every leaf stacked over T). A plain loop of
    the step, so it is bit for bit stepping frame by frame. The state must
    be initialised (`make_bootstrap`)."""
    step = make_step(cfg, ingest)

    def run_chunk(state: OdometryState, inputs):
        n = inputs.shape[0] if ingest == "image" else inputs.bins.shape[0]
        outs = []
        for i in range(n):
            state, out = step(state, _map(lambda a: a[i], inputs))
            outs.append(out)
        return state, FrameOutput(*(torch.stack(xs) for xs in zip(*outs)))

    return run_chunk


def compose_trajectory(outputs: FrameOutput) -> np.ndarray:
    """Host-side f64 reconstruction of global poses from anchor-relative
    frame outputs (T, ...). Returns (T, 3) [x, y, theta]."""
    pose = np.asarray(outputs.pose, np.float64)
    shift = np.asarray(outputs.shift, np.float64)
    fused = np.asarray(outputs.fused)
    world = np.zeros((pose.shape[0], 3))
    anchor = np.zeros(3)

    def comp(a, b):
        c, s = math.cos(a[2]), math.sin(a[2])
        return np.array([a[0] + c * b[0] - s * b[1],
                         a[1] + s * b[0] + c * b[1],
                         a[2] + b[2]])

    for i in range(pose.shape[0]):
        world[i] = comp(anchor, pose[i])
        if fused[i]:
            anchor = comp(anchor, shift[i])
    return world


def host_filter(images: np.ndarray, cfg, ingest: str):
    """Native host filter: (T, A, R) uint8 sweeps -> numpy candidate rows
    (`CompactCandidates` or `Candidates` of arrays; CA-CFAR detections with
    `filter.method="cacfar"`, as the reference's `_prepare`)."""
    f = cfg.filter
    if f.method == "cacfar":
        b, i, p = native_io.cfar_filter_frames_host(images, cfg)
        return filtering.Candidates(bins=b, intensity=i, peak=p)
    if ingest == "compact":
        min_bin = int(math.ceil(cfg.radar.min_distance / cfg.radar.range_res))
        b, a, i, p = native_io.filter_frames_host_compact(
            images, f.k_strongest, f.z_min, f.nms_window,
            cfg.feature.point_budget, min_bin, z_quantile=f.z_min_quantile)
        return filtering.CompactCandidates(bins=b, azimuth=a, intensity=i,
                                           peak=p)
    b, i, p = native_io.filter_frames_host(
        images, f.k_strongest, f.z_min, f.nms_window,
        z_quantile=f.z_min_quantile)
    return filtering.Candidates(bins=b, intensity=i, peak=p)


def to_device(tree, device):
    """numpy leaves -> tensors on `device`."""
    return _map(lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(
        device, non_blocking=True), tree)


def upload_images(images: np.ndarray, device) -> torch.Tensor:
    """Raw uint8 sweeps -> a tensor on `device`; to a card through pinned
    host memory without blocking (torch's caching host allocator reuses a
    pinned block once the copy recorded on it has completed;
    `tools/profile_torch_ingest.py` times it against a pageable copy)."""
    t = torch.as_tensor(np.ascontiguousarray(images))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _ingest_kind(cfg, ingest: str) -> str:
    """The step's ingest kind for a runner's `ingest` ("image" or "host"):
    host ingest hands compact rows to the k-strongest path with a point
    budget and (A, K) candidate sets otherwise (`odometry.py:396-402` of the
    reference)."""
    if ingest == "image":
        return "image"
    if ingest != "host":
        raise ValueError(f"unknown ingest '{ingest}': 'image' or 'host'")
    if cfg.filter.method != "cacfar" and cfg.feature.point_budget:
        return "compact"
    return "candidates"


class OdometryRunner:
    """Host-side sequence driver: feed uint8 polar frames, get a global f64
    trajectory (the offline loop of `offline_odometry.cpp:98-126`). A
    feeder thread prepares chunk i+1 while the device runs chunk i: with
    `ingest="image"` (the default, as in the reference) it uploads the raw
    sweeps, which the device filters; with `ingest="host"` it runs the
    native host filter and uploads its rows."""

    def __init__(self, cfg, ingest: str = "image", device="cuda",
                 chunk: int = 16, dtype=torch.float32):
        """`device`: the CUDA card by default; the CPU (the kernels' plain
        twins) only when asked for with `device="cpu"`."""
        device = resolve_device(device)
        self.cfg = cfg
        self.chunk = chunk
        self.device = device
        self.dtype = dtype
        self.kind = _ingest_kind(cfg, ingest)
        self.step = make_step(cfg, self.kind)
        self.bootstrap = make_bootstrap(cfg, self.kind)
        self.state = init_state(cfg, self.device, dtype=dtype)
        self.outputs: list = []   # per-frame FrameOutputs still on the device
        self._host: list = []     # stacked numpy FrameOutputs

    def process(self, images: np.ndarray) -> None:
        """Process (T, A, R) uint8 frames."""
        t = images.shape[0]
        q: queue.Queue = queue.Queue(maxsize=2)
        failure: list = []

        def feeder():
            try:
                for lo in range(0, t, self.chunk):
                    part = images[lo:lo + self.chunk]
                    if self.kind == "image":
                        q.put(upload_images(part, self.device))
                    else:
                        q.put(to_device(host_filter(part, self.cfg,
                                                    self.kind), self.device))
            except BaseException as e:   # re-raised on the caller's thread
                failure.append(e)
            finally:
                q.put(None)

        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        try:
            while (part := q.get()) is not None:
                n = part.shape[0] if self.kind == "image" \
                    else part.bins.shape[0]
                for i in range(n):
                    frame = _map(lambda a: a[i], part)
                    if not trace.item("sync.bootstrap",
                                      self.state.initialized):
                        self.state, out = self.bootstrap(self.state, frame)
                    else:
                        self.state, out = self.step(self.state, frame)
                    self.outputs.append(out)
        finally:
            while th.is_alive():         # unblock a feeder stuck on put()
                try:
                    q.get_nowait()
                except queue.Empty:
                    th.join(0.01)
        if failure:
            raise failure[0]

    def frame_outputs(self) -> FrameOutput:
        """All frame outputs so far, stacked on the host (numpy, (T, ...))."""
        if self.outputs:   # per-frame device outputs -> one host transfer
            with trace.span("sync.readback"):
                self._host.append(FrameOutput(*(
                    torch.stack(xs).cpu().numpy()
                    for xs in zip(*self.outputs))))
            self.outputs = []
        return FrameOutput(*(np.concatenate(xs) for xs in zip(*self._host)))

    def trajectory(self) -> np.ndarray:
        return compose_trajectory(self.frame_outputs())

    def reset(self) -> None:
        """Empty state, no outputs (for timed re-passes)."""
        self.state = init_state(self.cfg, self.device, dtype=self.dtype)
        self.outputs, self._host = [], []

    # -- checkpoint / resume, in the reference's npz layout ----------------
    def save_checkpoint(self, path: str) -> None:
        payload = {f"state_{i}": a.cpu().numpy()
                   for i, a in enumerate(state_leaves(self.state))}
        if self.outputs or self._host:
            out = self.frame_outputs()
            payload.update({f"out_{k}": np.asarray(v)
                            for k, v in out._asdict().items()})
        np.savez_compressed(path, **payload)

    @classmethod
    def resume(cls, cfg, path: str, device="cuda", chunk: int = 16,
               ingest: str = "image") -> "OdometryRunner":
        runner = cls(cfg, ingest=ingest, device=device, chunk=chunk)
        with np.load(path) as z:
            ref = runner.state
            loaded = state_from_numpy(
                [z[f"state_{i}"] for i in range(len(state_leaves(ref)))],
                runner.device)
            runner.state = _map2(lambda new, old: new.to(old.dtype),
                                 loaded, ref)
            if "out_pose" in z.files:
                t = z["out_pose"].shape[0]
                defaults = {"health_checked": np.zeros((t,), bool),
                            "healthy": np.ones((t,), bool),
                            "health_dist": np.zeros((t,), np.float32),
                            "health_rot": np.zeros((t,), np.float32)}
                runner._host = [FrameOutput(**{
                    k: (z[f"out_{k}"] if f"out_{k}" in z.files
                        else defaults[k]) for k in FrameOutput._fields})]
        return runner
