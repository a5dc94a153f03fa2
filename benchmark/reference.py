"""Plain reference of keyframe radar odometry (CFEAR), for the benchmark's
check of what the program produced.

Written from the method's description (Adolfsson et al., "Lidar-level
localization with radar? The CFEAR approach to accurate, fast and robust
large-scale radar odometry in diverse environments", IEEE T-RO 2023) and the
parameters in a configuration file of `benchmark/configs/`, never from the
program: it imports numpy and torch only, and reads every parameter from the
file's `params`. It runs L sequences side by side, each lane its own drive,
in plain tensor operations (no kernel, no cache):

1. k-strongest returns per azimuth above z_min -> Cartesian points;
2. motion compensation by the previous frame motion;
3. oriented surface points: per occupied voxel of side r, the points within
   r of its centroid from the 3x3 voxels around it, weighted by intensity
   above the floor -> weighted mean, covariance, normal, validity gates;
   the cells with most support kept up to the budget;
4. registration of the frame to the keyframe window: per outer iteration an
   exact nearest neighbour in every keyframe (radius 2r0 on the first
   iteration, r0 after), gated by radius and normal angle and weighted
   (`Combined`), then a trust-region Levenberg-Marquardt solve of the robust
   point-to-point cost;
5. the velocity sanity gate, the keyframe gate (distance or rotation) and the
   keyframe ring, with the anchor rebased to each new keyframe.

Precision: the points and cells in float32, as the configuration states;
nearest-neighbour distances and the solve in float64. `precision="tf32"`
is the control: the distances are computed as one matrix product
(|s|^2 + |t|^2 - 2 s.t) whose operands are rounded to TF32's 10-bit
mantissa and whose products are summed in float32, as a tensor core does.

`Odometry.check(params)` refuses, by key, every value of `PARAMS` that
this file does not implement, and every key it does not know.

The interface of a plain reference. A configuration file may name another
file under `benchmark/` as its reference (its key `"reference"`); the
harness then runs that file for the check, the control and the work counts
in place of this one. Such a file has:

- `Odometry(params, lanes, device, precision)`, whose `check(params)`
  raises ValueError, naming the key, for a parameter value it does not
  implement (the harness calls it before rendering, and `__init__` calls
  it), and whose `.step(images, given=None, register=True)` returns the
  keys that `harness.run_reference` reads (see `Odometry.step`);
- `points`, `compensate`, `cells`, `transform`, `rotate` and `nearest` as
  here, for `work.py`.

It may import this module and replace only what differs: a subclass of
`Registration`, and a subclass of `Odometry` whose class attributes
`registration` and `PARAMS` name that class and the table of what it
implements.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi

# Every key of a configuration's `params`: the values that the reference
# takes (None: any), and why the value changes nothing that the check
# compares ("": the reference computes what it says). Any other value, and
# any key not listed here, is refused.
_CFAR = "CA-CFAR only, and filter.method is held to kstrong"
_NO_COV = "the covariance only, which the check does not compare"
PARAMS = {
    "name": (None, "a label"),
    "radar.n_azimuths": (None, ""),
    "radar.n_bins": (None, ""),
    "radar.range_res": (None, ""),
    "radar.ccw": (None, ""),
    "radar.sensor_period": (None, ""),
    "radar.min_distance": (None, ""),
    "radar.max_distance": (None, ""),
    "radar.dataset": (None, "a label: the geometry is the other radar keys"),
    "filter.method": (("kstrong",), ""),
    "filter.k_strongest": (None, ""),
    "filter.z_min": (None, ""),
    "filter.z_min_quantile": ((0.0,), ""),
    "filter.nms_window": (None, "the NMS peaks feed the pose graph only"),
    "filter.cfar_window": (None, _CFAR),
    "filter.cfar_guard": (None, _CFAR),
    "filter.false_alarm_rate": (None, _CFAR),
    "filter.cfar_static_threshold": (None, _CFAR),
    "filter.cfar_max_distance": (None, _CFAR),
    "filter.cfar_max_per_azimuth": (None, _CFAR),
    "feature.res": (None, ""),
    "feature.downsample_factor": (None, ""),
    "feature.weight_intensity": (None, ""),
    "feature.intensity_floor": (None, ""),
    "feature.min_samples": (None, ""),
    "feature.cond_max": (None, ""),
    "feature.det_min": (None, ""),
    "feature.max_cells": (None, ""),
    "feature.use_raw_pointcloud": ((False,), ""),
    "feature.max_cells_raw": (None, "raw cells only, which are held off"),
    "feature.point_budget": ((0,), ""),
    "feature.backend": (("auto", "xla"), "the program's kernel for the same "
                        "sums ('pallas' drops voxels past pre_cells)"),
    "feature.pre_cells": (None, "feature.backend 'pallas' only"),
    "feature.spatial_sort": (None, ""),
    "registration.cost": (("P2P",), ""),
    "registration.loss": (("Huber", "Cauchy", "None"), ""),
    "registration.loss_limit": (None, ""),
    "registration.weight_opt": (("Combined",), ""),
    "registration.assoc_radius": (None, ""),
    "registration.assoc_method": (
        ("auto", "dense", "pallas", "pallas_sparse"),
        "the exact nearest neighbour, whichever kernel finds it"),
    "registration.bucket_capacity": (None, "assoc_method 'grid' only"),
    "registration.angle_outlier_deg": (None, ""),
    "registration.max_itr_association": (None, ""),
    "registration.max_active_keyframes": ((0,), ""),
    "registration.min_itr": (None, ""),
    "registration.max_itr_solver": (None, ""),
    "registration.score_tolerance": (None, ""),
    "registration.function_tolerance": (None, ""),
    "registration.cov_scale": (None, "the point-to-distribution cost only"),
    "registration.regularization": (None,
                                    "the point-to-distribution cost only"),
    "registration.soft_constraint": ((False,), ""),
    "registration.covariance_scaler": (None, _NO_COV),
    "registration.disable_registration": ((False,), ""),
    "registration.min_assoc_fraction": (None, ""),
    "registration.max_score": ((math.inf,), ""),
    "registration.time_continuous": ((False,), ""),
    "registration.unroll_solver": (None, "unrolled loops, the same poses"),
    "odometry.submap_scan_size": (None, ""),
    "odometry.keyframe_min_dist": (None, ""),
    "odometry.keyframe_min_rot_deg": (None, ""),
    "odometry.use_keyframe": ((True,), ""),
    "odometry.use_guess": ((True,), ""),
    "odometry.compensate": (None, ""),
    "odometry.vel_limit": (None, ""),
    "odometry.acc_limit": (None, ""),
    "odometry.estimate_cov_by_sampling": ((False,), ""),
    "odometry.cov_sampling_xy_range": (None, _NO_COV),
    "odometry.cov_sampling_yaw_range": (None, _NO_COV),
    "odometry.cov_sampling_samples_per_axis": (None, _NO_COV),
    "odometry.cov_sampling_covariance_scaler": (None, _NO_COV),
    "odometry.store_graph": (None, "keeps the pose graph's payloads"),
    "odometry.health_check_every": ((0,), ""),
    "odometry.health_max_dist": (None, "the health check only, held off"),
    "odometry.health_max_rot_deg": (None, "the health check only, held off"),
}


def refuse(params, table):
    """Raise ValueError, naming each key, where `params` holds a key that
    `table` does not list, lacks one that it lists, or holds a value that
    it does not take."""
    flat = {}
    for group, value in params.items():
        if isinstance(value, dict):
            flat.update({f"{group}.{k}": v for k, v in value.items()})
        else:
            flat[group] = value
    bad = [f"{k} (not a parameter it knows)" for k in flat if k not in table]
    bad += [f"{k} (missing)" for k in table if k not in flat]
    for key, (values, _) in table.items():
        if key in flat and values is not None and flat[key] not in values:
            bad.append(f"{key} = {flat[key]!r} (it implements "
                       f"{' or '.join(repr(v) for v in values)})")
    if bad:
        raise ValueError("the reference refuses " + "; ".join(bad))


# --------------------------------------------------------------- geometry
def compose(a, b):
    """T_a T_b for [x, y, theta] poses (..., 3)."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([a[..., 0] + ca * b[..., 0] - sa * b[..., 1],
                        a[..., 1] + sa * b[..., 0] + ca * b[..., 1],
                        a[..., 2] + b[..., 2]], -1)


def inverse(a):
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([-(ca * a[..., 0] + sa * a[..., 1]),
                        sa * a[..., 0] - ca * a[..., 1], -a[..., 2]], -1)


def relative(a, b):
    return compose(inverse(a), b)


def wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def transform(pose, pts):
    """pose (..., 3) applied to points (..., N, 2)."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([c * x - s * y + pose[..., 0, None],
                        s * x + c * y + pose[..., 1, None]], -1)


def rotate(pose, v):
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    return torch.stack([c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1]], -1)


def tf32(x):
    """Round float32 values to TF32 (10 explicit mantissa bits), to
    nearest, ties to even."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


# ----------------------------------------------------------------- filter
def points(images, p):
    """uint8 sweeps (L, A, R) -> xy (L, N, 2) f32, intensity (L, N) f32,
    valid (L, N) bool: the k strongest bins of each azimuth at or above
    z_min (on equal intensity the farther bin), range (bin + 0.5) dr, kept
    beyond the minimum distance; bearing (a + 1) / A * 2 pi."""
    radar, flt = p["radar"], p["filter"]
    n_az, n_bins = images.shape[-2], images.shape[-1]
    dev = images.device
    inten = images.to(torch.int64)
    bins = torch.arange(n_bins, device=dev)
    key = torch.where(inten >= flt["z_min"], inten * n_bins + bins,
                      torch.full_like(inten, -1))
    top = torch.topk(key, flt["k_strongest"], dim=-1).values    # (L, A, k)
    valid = top >= 0
    b = torch.where(valid, top % n_bins, torch.zeros_like(top))
    value = torch.where(valid, top // n_bins, torch.zeros_like(top))
    min_bin = math.ceil(radar["min_distance"] / radar["range_res"])
    valid = valid & (b > min_bin)
    rng = (b.to(torch.float32) + 0.5) * radar["range_res"]
    az = torch.arange(n_az, device=dev, dtype=torch.float32)[:, None]
    theta = (az + 1.0) / n_az * TWO_PI
    xy = torch.stack([rng * torch.cos(theta), rng * torch.sin(theta)], -1)
    lead = images.shape[0]
    return (xy.reshape(lead, -1, 2), value.to(torch.float32).reshape(lead, -1),
            valid.reshape(lead, -1))


def compensate(xy, tmot, ccw: bool):
    """Each point moved by the fraction of the previous frame motion tmot
    (L, 3) at its relative scan time in [-0.5, 0.5]."""
    a = torch.atan2(xy[..., 1], xy[..., 0])
    d = torch.where(a > 1e-5, a, TWO_PI + a) / TWO_PI - 0.5
    if ccw:
        d = -d
    ang = d * tmot[:, None, 2]
    c, s = torch.cos(ang), torch.sin(ang)
    x, y = xy[..., 0], xy[..., 1]
    return torch.stack([c * x - s * y + d * tmot[:, None, 0],
                        s * x + c * y + d * tmot[:, None, 1]], -1)


# ---------------------------------------------------------------- features
def grid_geometry(p):
    radar, feat = p["radar"], p["feature"]
    leaf = feat["res"] / feat["downsample_factor"]
    usable = min(radar["max_distance"], (radar["n_bins"] + 0.5)
                 * radar["range_res"])
    dim = 2 * (math.ceil(usable / leaf) + 2)
    return leaf, dim, math.ceil(feat["res"] / leaf)


def _morton(ix, iy):
    code = torch.zeros_like(ix)
    for bit in range(15):
        code |= ((ix >> bit) & 1) << (2 * bit)
        code |= ((iy >> bit) & 1) << (2 * bit + 1)
    return code


def _scatter_sum(values, index, keep, size):
    """The rows of values (K, C) where keep (K,), summed into (size, C) by
    index (K,), in a fixed order on every device."""
    out = values.new_zeros((size, values.shape[1]))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out.index_add_(0, index[keep], values[keep])
    finally:
        torch.use_deterministic_algorithms(was)
    return out


def cells(xy, inten, valid, p):
    """Oriented surface points of each lane: dict of mean (L, M, 2), normal
    (L, M, 2), nsamples (L, M), planarity (L, M), valid (L, M), with M the
    cell budget; valid cells first, by support, in Morton order of their
    voxel when the configuration sorts them."""
    feat = p["feature"]
    leaf, dim, noff = grid_geometry(p)
    n_lanes, n_pts = xy.shape[:2]
    dev = xy.device
    ncell = dim * dim
    leaf_t = torch.tensor(leaf, dtype=torch.float32, device=dev)
    vox = torch.floor(xy / leaf_t).to(torch.int64) + dim // 2    # (L, N, 2)
    inside = valid & (vox >= 0).all(-1) & (vox < dim).all(-1)
    lane = torch.arange(n_lanes, device=dev)[:, None]
    vid = lane * ncell + vox[..., 0] * dim + vox[..., 1]
    ones = torch.ones_like(xy[..., 0])
    s = _scatter_sum(torch.stack([ones, xy[..., 0], xy[..., 1]], -1
                                 ).reshape(-1, 3), vid.reshape(-1),
                     inside.reshape(-1), n_lanes * ncell)
    count = s[:, 0]
    centroid = s[:, 1:] / torch.clamp(count, min=1.0)[:, None]
    occupied = count >= 1.0
    w = torch.clamp(inten - feat["intensity_floor"], min=0.0) \
        if feat["weight_intensity"] else torch.ones_like(inten)

    # each point joins the cell of every neighbour voxel whose centroid lies
    # within r of it; moments about that voxel's centre
    mom = xy.new_zeros((n_lanes * ncell, 7))
    for dx in range(-noff, noff + 1):
        for dy in range(-noff, noff + 1):
            tx, ty = vox[..., 0] + dx, vox[..., 1] + dy
            ok = inside & (tx >= 0) & (tx < dim) & (ty >= 0) & (ty < dim)
            tid = torch.where(ok, lane * ncell + tx * dim + ty,
                              torch.zeros_like(tx))
            c = centroid[tid]
            d2 = ((xy - c) ** 2).sum(-1)
            member = ok & occupied[tid] & (d2 <= feat["res"] ** 2)
            cx = (tx.to(torch.float32) - dim // 2 + 0.5) * leaf
            cy = (ty.to(torch.float32) - dim // 2 + 0.5) * leaf
            rx, ry = xy[..., 0] - cx, xy[..., 1] - cy
            m = member.to(torch.float32)
            wm = w * m
            rows = torch.stack([m, wm, wm * rx, wm * ry, wm * rx * rx,
                                wm * rx * ry, wm * ry * ry], -1)
            mom += _scatter_sum(rows.reshape(-1, 7), tid.reshape(-1),
                                member.reshape(-1), n_lanes * ncell)
    cnt, s0, s1x, s1y, sxx, sxy, syy = mom.unbind(-1)
    s0c = torch.clamp(s0, min=1e-12)
    mx, my = s1x / s0c, s1y / s0c
    a, b, c = sxx / s0c - mx * mx, sxy / s0c - mx * my, syy / s0c - my * my
    half = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    lmin, lmax = half - disc, half + disc
    v1 = torch.stack([lmin - c, b], -1)
    v2 = torch.stack([b, lmin - a], -1)
    v = torch.where(((v1 * v1).sum(-1) >= (v2 * v2).sum(-1))[:, None], v1, v2)
    vn = (v * v).sum(-1, keepdim=True)
    normal = torch.where(vn > 1e-20, v / torch.sqrt(torch.clamp(vn, min=1e-20)),
                         torch.tensor([1.0, 0.0], device=dev))
    cond = torch.abs(lmax / torch.where(lmin == 0.0, torch.full_like(lmin,
                                                                     1e-30),
                                        lmin))
    ok = (occupied & (cnt >= feat["min_samples"]) & (s0 > 0.0)
          & (cond <= feat["cond_max"]) & (lmax * lmin > feat["det_min"])
          & (lmin > 0.0) & (lmax > 0.0))
    ii = torch.arange(ncell, device=dev)
    ix, iy = ii // dim, ii % dim
    centre = torch.stack([(ix.to(torch.float32) - dim // 2 + 0.5) * leaf,
                          (iy.to(torch.float32) - dim // 2 + 0.5) * leaf], -1)
    mean = torch.stack([mx, my], -1).reshape(n_lanes, ncell, 2) + centre
    normal = normal.reshape(n_lanes, ncell, 2)
    flip = (normal * -mean).sum(-1) < 0.0
    normal = torch.where(flip[..., None], -normal, normal)
    cnt = cnt.reshape(n_lanes, ncell)
    ok = ok.reshape(n_lanes, ncell)
    planarity = torch.log1p(cond / 2.0).reshape(n_lanes, ncell)

    # the budget: valid cells first, the best supported first
    m_cells = feat["max_cells"]
    rank = torch.where(ok, cnt + 1.0, torch.zeros_like(cnt))
    take = torch.argsort(-rank, dim=-1, stable=True)[:, :m_cells]
    kept = torch.gather(ok, 1, take)
    if feat["spatial_sort"]:
        code = _morton(ix[take], iy[take])
        code = torch.where(kept, code, torch.full_like(code, 1 << 30))
        take = torch.gather(take, 1, torch.argsort(code, dim=-1, stable=True))
        kept = torch.gather(ok, 1, take)

    def g(x):
        if x.dim() == 3:
            return torch.gather(x, 1, take[..., None].expand(-1, -1, 2))
        return torch.gather(x, 1, take)

    zero = torch.zeros((), device=dev)
    return {"mean": torch.where(kept[..., None], g(mean), zero),
            "normal": torch.where(kept[..., None], g(normal), zero),
            "nsamples": torch.where(kept, g(cnt), zero),
            "planarity": torch.where(kept, g(planarity), zero),
            "valid": kept}


# ------------------------------------------------------------ registration
def _robust(s, loss: str, a: float):
    """(rho(s), rho'(s)) of the squared residual norm s."""
    if loss == "Huber":
        big = s > a * a
        r = torch.sqrt(torch.clamp(s, min=1e-30))
        return (torch.where(big, 2.0 * a * r - a * a, s),
                torch.where(big, a / r, torch.ones_like(s)))
    if loss == "Cauchy":
        return a * a * torch.log1p(s / (a * a)), 1.0 / (1.0 + s / (a * a))
    if loss == "None":
        return s, torch.ones_like(s)
    raise ValueError(f"the reference has no loss '{loss}'")


def _similarity(x, y):
    return 2.0 * torch.minimum(x, y) / torch.clamp(x + y, min=1e-12)


def nearest(src, tar, tar_valid, precision: str = "float64",
            budget: int = 1 << 27):
    """For each source point (L, Ms, 2) the nearest valid target of each
    keyframe (L, S, M, 2): (index (L, S, Ms), squared distance). The
    distance is |s|^2 + |t|^2 - 2 s.t, with |s|^2 added after the minimum
    (it is the same for every target of a source point) and invalid targets
    at |t|^2 = inf: in float64, or, as the TF32 control, with every operand
    rounded to TF32 and summed in float32 (see the module docstring). In
    blocks of source points of at most `budget` distances."""
    n_lanes, n_kf, m_tar = tar.shape[:3]
    rows = max(1, budget // (n_lanes * n_kf * m_tar))
    dt = torch.float32 if precision == "tf32" else torch.float64
    rnd = tf32 if precision == "tf32" else (lambda x: x)
    t = tar.reshape(n_lanes, n_kf * m_tar, 2).to(dt)
    t2 = rnd((t * t).sum(-1))
    t2 = torch.where(tar_valid.reshape(n_lanes, -1), t2,
                     torch.full_like(t2, math.inf))[:, None, :]
    t = rnd(t).transpose(1, 2)
    idx_out, d2_out = [], []
    for lo in range(0, src.shape[1], rows):
        s = src[:, lo:lo + rows].to(dt)
        s2 = rnd((s * s).sum(-1))
        d2 = torch.baddbmm(t2, rnd(s), t, alpha=-2.0)
        best, arg = d2.reshape(n_lanes, -1, n_kf, m_tar).min(-1)
        idx_out.append(arg.transpose(1, 2))
        d2_out.append((best + s2[..., None]).double().transpose(1, 2))
    return torch.cat(idx_out, 2), torch.cat(d2_out, 2)


class Registration:
    """Registration of each lane's frame cells to its keyframe window."""

    def __init__(self, p, precision: str = "float64"):
        self.reg = p["registration"]
        self.precision = precision

    def _lm(self, sx, sy, tx, ty, w, pose):
        """Trust-region LM over rows (L, N) from pose (L, 3), float64.
        Returns (pose, cost, accepted steps, last relative decrease)."""
        reg = self.reg
        loss, lim = reg["loss"], reg["loss_limit"]

        def residual(p):
            c = torch.cos(p[:, 2])[:, None]
            s = torch.sin(p[:, 2])[:, None]
            ex = c * sx - s * sy + p[:, 0, None] - tx
            ey = s * sx + c * sy + p[:, 1, None] - ty
            return c, s, ex, ey

        def cost_only(p):
            _, _, ex, ey = residual(p)
            return 0.5 * (w * _robust(ex * ex + ey * ey, loss, lim)[0]).sum(-1)

        def cgh(p):
            c, s, ex, ey = residual(p)
            rho, drho = _robust(ex * ex + ey * ey, loss, lim)
            wd = w * drho
            jt_x = -s * sx - c * sy
            jt_y = c * sx - s * sy
            jac = torch.stack([torch.stack([torch.ones_like(ex),
                                            torch.zeros_like(ex), jt_x], -1),
                               torch.stack([torch.zeros_like(ex),
                                            torch.ones_like(ex), jt_y], -1)],
                              -2)                                # (L, N, 2, 3)
            r = torch.stack([ex, ey], -1)
            g = torch.einsum("ln,lnd,lndp->lp", wd, r, jac)
            h = torch.einsum("ln,lndp,lndq->lpq", wd, jac, jac)
            return 0.5 * (w * rho).sum(-1), g, h

        n_lanes = pose.shape[0]
        dev = pose.device
        cost, g, h = cgh(pose)
        radius = torch.full((n_lanes,), 1e4, dtype=torch.float64, device=dev)
        dec = torch.full_like(radius, 2.0)
        steps = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
        last = torch.full_like(radius, math.inf)
        done = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
        ftol = reg["function_tolerance"]
        for _ in range(reg["max_itr_solver"]):
            if bool(done.all()):
                break
            diag = torch.clamp(torch.diagonal(h, dim1=1, dim2=2), 1e-6, 1e32)
            step = -torch.linalg.solve(h + torch.diag_embed(diag
                                                             / radius[:, None]),
                                       g)
            new = pose + step
            new_cost = cost_only(new)
            model = -((g * step).sum(-1)
                      + 0.5 * (step * (h @ step[..., None])[..., 0]).sum(-1))
            rel = (cost - new_cost) / torch.clamp(model, min=1e-30)
            accept = (rel > 1e-3) & torch.isfinite(new_cost)
            t = 2.0 * rel - 1.0
            r_ok = radius / torch.clamp(torch.clamp(1.0 - t * t * t,
                                                    min=1.0 / 3.0), min=1e-3)
            r_bad = radius / dec
            finished = ((accept & ((cost - new_cost).abs() <= ftol * cost))
                        | (model <= ftol * cost)
                        | (step.norm(dim=-1) <= 1e-8 * (pose.norm(dim=-1)
                                                         + 1e-8))
                        | (r_bad < 1e-32))
            c2, g2, h2 = cgh(new)
            live = ~done
            take = live & accept
            pose = torch.where(take[:, None], new, pose)
            cost = torch.where(take, c2, cost)
            g = torch.where(take[:, None], g2, g)
            h = torch.where(take[:, None, None], h2, h)
            radius = torch.where(live, torch.where(
                accept, torch.clamp(r_ok, max=1e16), r_bad), radius)
            dec = torch.where(live, torch.where(accept, torch.full_like(dec,
                                                                        2.0),
                                                dec * 2.0), dec)
            steps = steps + take.to(torch.int64)
            last = torch.where(live, rel, last)
            done = done | finished
        return pose, cost, steps, last

    def __call__(self, kf, kf_pose, kf_valid, src, guess):
        """kf: cell dict (L, S, M, ...), kf_pose (L, S, 3) f64 in the
        anchor frame, kf_valid (L, S), src: cell dict (L, Ms, ...), guess
        (L, 3) f64. Returns (pose, success, n_assoc, iterations)."""
        reg = self.reg
        n_lanes = guess.shape[0]
        dev = guess.device
        tar = transform(kf_pose, kf["mean"].double())         # (L, S, M, 2)
        tar_n = rotate(kf_pose, kf["normal"].double())
        tar_ok = kf["valid"] & kf_valid[..., None]
        cos_gate = math.cos(math.radians(reg["angle_outlier_deg"]))
        s_mean = src["mean"].double()
        pose = prev_pose = guess
        prev_score = torch.full((n_lanes,), 3.4028234663852886e38,
                                dtype=torch.float64, device=dev)
        done = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
        failed = torch.zeros_like(done)
        n_assoc = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
        iters = torch.zeros_like(n_assoc)
        for it in range(reg["max_itr_association"]):
            if it and bool(done.all()):
                break
            r0 = reg["assoc_radius"] * (2.0 if it == 0 else 1.0)
            sw = transform(pose, s_mean)                      # (L, Ms, 2)
            snw = rotate(pose, src["normal"].double())
            nn, d2 = nearest(sw, tar, tar_ok, self.precision)
            lane = torch.arange(n_lanes, device=dev)[:, None, None]
            kfi = torch.arange(tar.shape[1], device=dev)[None, :, None]
            t_mean = tar[lane, kfi, nn]                        # (L, S, Ms, 2)
            t_norm = tar_n[lane, kfi, nn]
            sim = torch.clamp((snw[:, None] * t_norm).sum(-1), min=0.0)
            ok = (src["valid"][:, None] & tar_ok[lane, kfi, nn]
                  & (d2 < r0 * r0) & (sim > cos_gate))
            w = (_similarity(src["nsamples"][:, None].double(),
                             kf["nsamples"][lane, kfi, nn].double())
                 + sim + _similarity(src["planarity"][:, None].double(),
                                     kf["planarity"][lane, kfi, nn].double()))
            w = torch.where(ok, w, torch.zeros_like(w))
            count = ok.sum((1, 2))
            sx = s_mean[:, None, :, 0].expand_as(w).reshape(n_lanes, -1)
            sy = s_mean[:, None, :, 1].expand_as(w).reshape(n_lanes, -1)
            lm_pose, lm_cost, lm_steps, lm_rel = self._lm(
                sx, sy, t_mean[..., 0].reshape(n_lanes, -1),
                t_mean[..., 1].reshape(n_lanes, -1), w.reshape(n_lanes, -1),
                pose)
            check = it + 1 > reg["min_itr"]
            worse = check & (prev_score < lm_cost)
            conv = check & (((prev_score - lm_cost) / prev_score
                             < reg["score_tolerance"])
                            | (lm_rel < reg["score_tolerance"])
                            | (lm_steps == 0))
            live = ~done
            keep_going = live & ~(worse | conv)
            pose = torch.where(live[:, None], torch.where(
                worse[:, None], prev_pose, lm_pose), pose)
            prev_pose = torch.where(keep_going[:, None], lm_pose, prev_pose)
            prev_score = torch.where(keep_going, lm_cost, prev_score)
            n_assoc = torch.where(live, count, n_assoc)
            iters = iters + live.to(torch.int64)
            failed = torch.where(live, count * 2 <= 1, failed)
            done = done | worse | conv | (count * 2 <= 1)
        possible = torch.clamp(src["valid"].sum(-1) * kf_valid.sum(-1), min=1)
        collapsed = n_assoc.double() / possible.double() \
            < reg["min_assoc_fraction"]
        return pose, ~failed & ~collapsed, n_assoc, iters


# --------------------------------------------------------------- odometry
class Odometry:
    """L independent drives, stepped side by side. Poses are kept relative
    to each lane's newest keyframe (the anchor), as frame outputs are."""

    registration = Registration
    PARAMS = PARAMS

    @classmethod
    def check(cls, params):
        """Refuse, by key, what this reference does not implement."""
        refuse(params, cls.PARAMS)

    def __init__(self, params, lanes: int, device, precision="float64"):
        self.check(params)
        self.p = params
        self.lanes = lanes
        self.dev = torch.device(device)
        self.reg = self.registration(params, precision)
        odo = params["odometry"]
        s = odo["submap_scan_size"]
        m = params["feature"]["max_cells"]
        z = lambda *shape, dt=torch.float32: torch.zeros(  # noqa: E731
            (lanes,) + shape, dtype=dt, device=self.dev)
        self.kf = {"mean": z(s, m, 2), "normal": z(s, m, 2),
                   "nsamples": z(s, m), "planarity": z(s, m),
                   "valid": z(s, m, dt=torch.bool)}
        self.kf_pose = z(s, 3, dt=torch.float64)
        self.kf_valid = z(s, dt=torch.bool)
        self.t_prev = z(3, dt=torch.float64)
        self.tmot = z(3, dt=torch.float64)
        self.started = False

    def _cells(self, images):
        """The frame's cells, and its valid points (L,) in `n_points`."""
        p = self.p
        xy, inten, valid = points(images, p)
        if p["odometry"]["compensate"]:
            xy = compensate(xy, self.tmot.to(torch.float32),
                            p["radar"]["ccw"])
        c = cells(xy, inten, valid, p)
        c["n_points"] = valid.sum(-1)
        return c

    def _push(self, c, fuse, pose):
        """Append each fusing lane's cells and pose to its ring, the anchor
        rebased to the new keyframe."""
        f = fuse[:, None]

        def push(buf, new):
            rolled = torch.cat([buf[:, 1:], new[:, None]], 1)
            return torch.where(f.reshape(f.shape + (1,) * (buf.dim() - 2)),
                               rolled, buf)

        for k in self.kf:
            self.kf[k] = push(self.kf[k], c[k])
        poses = torch.cat([self.kf_pose[:, 1:], pose[:, None]], 1)
        rebased = compose(inverse(pose)[:, None], poses)
        self.kf_pose = torch.where(f[..., None], rebased, self.kf_pose)
        self.kf_valid = push(self.kf_valid, torch.ones_like(fuse))

    def step(self, images, given=None, register: bool = True):
        """One frame of every lane, uint8 (L, A, R) on the device -> dict
        of pose, shift (L, 3) f64, fused, success (L,) bool, n_cells,
        n_points, n_assoc, iterations (L,).

        With `given` (a dict of another odometry's outputs of this frame:
        pose (L, 3), fused (L,)), the reference follows that odometry: it
        registers the frame itself (unless `register` is False) and
        reports its own result, but then moves its state on by the given
        pose and keyframe decision instead of its own, so that its next
        frame starts from the state those outputs imply. A frame that it
        neither registers nor keeps returns None."""
        if given is not None and self.started:
            return self._follow(images, given, register)
        c = self._cells(images)
        n_cells = c["valid"].sum(-1)
        if not self.started:
            self.started = True
            fuse = torch.ones(self.lanes, dtype=torch.bool, device=self.dev)
            zero = torch.zeros((self.lanes, 3), dtype=torch.float64,
                               device=self.dev)
            self._push(c, fuse, zero)
            zi = torch.zeros_like(n_cells)
            return {"pose": zero, "shift": zero, "fused": fuse,
                    "success": fuse, "n_cells": n_cells,
                    "n_points": c["n_points"], "n_assoc": zi,
                    "iterations": zi}
        t_cur, ok, fuse, n_assoc, iters = self._solve(c)
        self.tmot = relative(self.t_prev, t_cur)
        self._push(c, fuse, t_cur)
        self.t_prev = torch.where(fuse[:, None], torch.zeros_like(t_cur),
                                  t_cur)
        return {"pose": t_cur, "shift": torch.where(
                    fuse[:, None], t_cur, torch.zeros_like(t_cur)),
                "fused": fuse, "success": ok, "n_cells": n_cells,
                "n_points": c["n_points"], "n_assoc": n_assoc,
                "iterations": iters}

    def _follow(self, images, given, register):
        g_fuse = torch.as_tensor(given["fused"], dtype=torch.bool,
                                 device=self.dev)
        pose = torch.as_tensor(given["pose"], dtype=torch.float64,
                               device=self.dev)
        if not register and not bool(g_fuse.any()):
            # a frame that is neither registered nor kept as a keyframe
            # moves the state by its pose alone
            self.tmot = relative(self.t_prev, pose)
            self.t_prev = pose
            return None
        c = self._cells(images)
        n_cells = c["valid"].sum(-1)
        if register:
            t_cur, ok, fuse, n_assoc, iters = self._solve(c)
        else:
            t_cur = torch.full((self.lanes, 3), math.nan, dtype=torch.float64,
                               device=self.dev)
            ok = fuse = torch.zeros(self.lanes, dtype=torch.bool,
                                    device=self.dev)
            n_assoc = iters = torch.zeros_like(n_cells)
        out = {"pose": t_cur, "shift": torch.where(
                   fuse[:, None], t_cur, torch.zeros_like(t_cur)),
               "fused": fuse, "success": ok, "n_cells": n_cells,
               "n_points": c["n_points"], "n_assoc": n_assoc,
               "iterations": iters}
        self.tmot = relative(self.t_prev, pose)
        self._push(c, g_fuse, pose)
        self.t_prev = torch.where(g_fuse[:, None], torch.zeros_like(pose),
                                  pose)
        return out

    def _solve(self, c):
        """Registration, sanity and keyframe gates of a frame's cells from
        the current state: (pose, success, fuse, n_assoc, iterations)."""
        odo = self.p["odometry"]
        dt = self.p["radar"]["sensor_period"]
        guess = compose(self.t_prev, self.tmot)
        pose, ok, n_assoc, iters = self.reg(self.kf, self.kf_pose,
                                            self.kf_valid, c, guess)
        t_cur = torch.where(ok[:, None], pose, guess)
        m = relative(self.t_prev, t_cur)
        vel = torch.hypot(m[:, 0], m[:, 1]) / dt
        acc = torch.hypot(m[:, 0] - self.tmot[:, 0],
                          m[:, 1] - self.tmot[:, 1]) / (dt * dt)
        sane = (vel <= odo["vel_limit"]) & (acc <= odo["acc_limit"])
        t_cur = torch.where(sane[:, None], t_cur, guess)
        key = relative(self.kf_pose[:, -1], t_cur)
        fuse = ((torch.hypot(key[:, 0], key[:, 1]) > odo["keyframe_min_dist"])
                | (wrap(key[:, 2]).abs()
                   > math.radians(odo["keyframe_min_rot_deg"]))) & ok
        return t_cur, ok, fuse, n_assoc, iters
