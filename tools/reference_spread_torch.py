"""The reference's own spread on the CPU test problems of
`tests/test_torch_loopclosure.py` and `tests/test_torch_multisession.py`,
beside the port's deviation from the reference.

Those tests hold the port's loop closure and multi-session merge against the
JAX reference on the CPU. Both sides register candidate pairs in float32,
and a registration can part on a decision that lies within float32
rounding: an association whose two nearest targets are one rounding step
apart in the |s|^2 + |t|^2 - 2 s.t form, or an LM step. Which way the
reference goes there depends on its own arithmetic, which XLA's CPU backend
compiles for the machine's instruction set: with FMA it contracts
`c*x - s*y + t` in `se2.transform` into a fused multiply-add, without it
rounds each product as the port does. This tool measures how far the
reference moves between its own arithmetic variants on the same inputs,
which is the spread the tests' bounds rest on.

Step 1, in this process (XLA's default instruction set): the inputs, built
as the tests build them: the reference's odometry and graph of the 56-frame
loop (seed 51) and of the sessions A (48 frames), B (A's frames 16-44),
C (A's frames 8-36) and the yaw-seed pair of
`test_cross_session_yaw_seed_convention`, saved under `--dir`.
Step 2, each variant in a process of its own (`--variant`):
- `ref`: the reference as the tests run it (dense association on the CPU);
- `ref-kernelA`: the reference with `assoc_method="pallas"`, kernel A in
  interpret mode, which computes each distance as dx*dx + dy*dy;
- `ref-avx`: the reference with XLA limited to AVX
  (`XLA_FLAGS=--xla_cpu_max_isa=AVX`: no FMA, so no contraction);
- `port`: the port on the CPU;
- `port-kernelA`: the port with `assoc_method="pallas"`, kernel A's plain
  twin on the CPU (dx*dx + dy*dy, as the reference's kernel A).
Each runs `close_from_graph`, `add_mini_loops` and `close_and_optimize` on
the loop, and `cross_session_matches` + `align_from_matches` (A-B and the
yaw-seed pair), `merge_sessions(A, B)` and `merge_many([A, B, C])`.
Step 3 prints, quantity by quantity, each variant's deviation from `ref`,
the port's from `ref-avx`, and `port-kernelA`'s from `ref-kernelA`.

    JAX_PLATFORMS=cpu python tools/reference_spread_torch.py --dir /tmp/spread

About four minutes on one CPU process a variant (the variants run one
after another).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"ref": "", "ref-kernelA": "", "ref-avx": "--xla_cpu_max_isa=AVX",
            "port": "", "port-kernelA": ""}
# (variant, the variant it is held against)
PAIRS = (("ref-kernelA", "ref"), ("ref-avx", "ref"), ("port", "ref"),
         ("port", "ref-avx"), ("port-kernelA", "ref-kernelA"))


def _cfg():
    """`tests/test_loopclosure.py:11` and `tests/test_multisession.py:25`."""
    from cfear_radarodometry_code_public_tpu.config import preset
    cfg = preset("CFEAR-3", dataset="synthetic")
    return cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=256),
        filter=dataclasses.replace(cfg.filter, k_strongest=8))


def _render_route(world, route, cfg, seed):
    """`tests/test_multisession.py:32`."""
    import numpy as np
    from cfear_radarodometry_code_public_tpu.datasets import synthetic
    imgs = []
    for i in range(len(route)):
        prev = route[i - 1] if i > 0 else route[i]
        c, s = np.cos(prev[2]), np.sin(prev[2])
        dx, dy = route[i, 0] - prev[0], route[i, 1] - prev[1]
        motion = np.array([c * dx + s * dy, -s * dx + c * dy,
                           route[i, 2] - prev[2]])
        imgs.append(synthetic.render_polar(
            world, route[i], cfg, np.random.default_rng(seed + i),
            motion=motion))
    return np.stack(imgs)


def make_inputs(d: str) -> None:
    """Step 1: the tests' inputs, made by the reference, saved under d."""
    import numpy as np
    from cfear_radarodometry_code_public_tpu.datasets import synthetic
    from cfear_radarodometry_code_public_tpu.models import odometry, posegraph
    cfg = _cfg()

    def session(images, name):
        runner = odometry.OdometryRunner(cfg, chunk=8)
        runner.process(images)
        out = runner.frame_outputs()
        traj = np.asarray(runner.trajectory())
        gb = posegraph.build_graph_from_odometry(out, traj, images=images,
                                                 cfg=cfg)
        gb.save(os.path.join(d, f"{name}.npz"))
        return out, traj

    images, _ = synthetic.make_sequence(seed=51, n_frames=56, cfg=cfg,
                                        speed=5.0, trajectory="loop")
    out, traj = session(images, "loop")
    np.savez(os.path.join(d, "loop_run.npz"), images=images, traj=traj,
             **{f"out_{k}": np.asarray(v) for k, v in out._asdict().items()})
    world = synthetic.make_world(np.random.default_rng(42))
    traj_a = synthetic.make_trajectory(np.random.default_rng(43), 48,
                                       dt=cfg.radar.sensor_period, speed=8.0)
    routes = {"a": traj_a, "b": traj_a[16:44], "c": traj_a[8:36]}
    for k, seed in (("a", 100), ("b", 900), ("c", 1700)):
        session(_render_route(world, routes[k], cfg, seed), k)
    world = synthetic.make_world(np.random.default_rng(77))
    traj_a = synthetic.make_trajectory(np.random.default_rng(78), 24,
                                       dt=cfg.radar.sensor_period, speed=8.0)
    route_b = traj_a[20:4:-1].copy()
    route_b[:, 2] += np.pi / 2
    session(_render_route(world, traj_a, cfg, 500), "ya")
    session(_render_route(world, route_b, cfg, 700), "yb")


def _edges(gb):
    import numpy as np
    return [(int(e[0]), int(e[1]), int(e[4]), np.asarray(e[2], np.float64),
             dict(gb.quality.get(i, {}))) for i, e in enumerate(gb.edges)]


def _matches(ms):
    import numpy as np
    return [(int(m["i_a"]), int(m["j_b"]), int(m["num_assoc"]),
             np.asarray(m["t_ij"], np.float64), float(m["score"]))
            for m in ms]


def run_variant(name: str, d: str) -> None:
    """Step 2: one variant's results, pickled to d/<name>.pkl."""
    import numpy as np
    cfg_j = _cfg()
    if name.endswith("kernelA"):
        cfg_j = cfg_j.replace(registration=dataclasses.replace(
            cfg_j.registration, assoc_method="pallas"))
    if name.startswith("port"):
        import torch
        torch.set_num_threads(1)
        import cfear_radarodometry_code_public_tpu_torch as port
        from cfear_radarodometry_code_public_tpu_torch.models import (
            loopclosure as lc, multisession as ms, odometry, posegraph as pg)
        cfg = port.CFEARConfig.from_dict(cfg_j.to_dict())
        kw = {"device": "cpu"}
        closer = lc.LoopCloser(cfg, device="cpu")
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        from cfear_radarodometry_code_public_tpu.models import (
            loopclosure as lc, multisession as ms, odometry, posegraph as pg)
        cfg, kw = cfg_j, {}
        closer = lc.LoopCloser(cfg)

    def load(k):
        return pg.GraphBuilder.load(os.path.join(d, f"{k}.npz"))

    res = {}
    g = load("loop")
    res["lc_pairs"] = closer.close_from_graph(g)
    res["lc_edges"] = _edges(g)
    g = load("loop")
    res["mini_pairs"] = closer.add_mini_loops(g)
    res["mini_edges"] = _edges(g)
    with np.load(os.path.join(d, "loop_run.npz")) as z:
        out = odometry.FrameOutput(**{k: z[f"out_{k}"]
                                      for k in odometry.FrameOutput._fields})
        opt, _, acc = lc.close_and_optimize(z["images"], out, z["traj"], cfg,
                                            iters=15, **kw)
    res["opt_pairs"], res["opt"] = acc, np.asarray(opt, np.float64)
    for key, (a, b) in (("ab", ("a", "b")), ("yaw", ("ya", "yb"))):
        ga, gb = load(a), load(b)
        m = ms.cross_session_matches(ga, gb, cfg, **kw)
        t_ab, inl = ms.align_from_matches(ga, gb, m)
        res[f"{key}_matches"] = _matches(m)
        res[f"{key}_t_ab"] = np.asarray(t_ab, np.float64)
        res[f"{key}_inliers"] = [(x["i_a"], x["j_b"]) for x in inl]
    opt, joint, inl, t_ab = ms.merge_sessions(load("a"), load("b"), cfg, **kw)
    res["merge_opt"] = np.asarray(opt, np.float64)
    res["merge_t_ab"] = np.asarray(t_ab, np.float64)
    res["merge_inliers"] = [(x["i_a"], x["j_b"]) for x in inl]
    res["merge_types"] = [(int(e[0]), int(e[1]), int(e[4]))
                          for e in joint.edges]
    three = ms.merge_many([load(k) for k in "abc"], cfg, **kw)
    res["three_t_ab"] = [np.asarray(x["t_ab"], np.float64) for x in three[2]]
    with open(os.path.join(d, f"{name}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _edge_spread(got, want, loop_type):
    same = [(e[0], e[1], e[2]) for e in got] == \
        [(e[0], e[1], e[2]) for e in want]
    if not same:
        return "constraints differ"
    loop = [float(abs(e[3] - f[3]).max()) for e, f in zip(got, want)
            if e[2] == loop_type]
    other = [float(abs(e[3] - f[3]).max()) for e, f in zip(got, want)
             if e[2] != loop_type]
    na = [(e[0], e[1], e[4]["num_assoc"], f[4]["num_assoc"])
          for e, f in zip(got, want)
          if e[2] == loop_type and e[4].get("num_assoc")
          != f[4].get("num_assoc")]
    return (f"constraints equal; loop edges max {max(loop, default=0):.3e}, "
            f"others max {max(other, default=0):.3e}; loop num_assoc "
            f"differ {na}")


def _match_spread(got, want):
    if [m[:2] for m in got] != [m[:2] for m in want]:
        return "matched pairs differ"
    na = [(m[0], m[1], m[2], w[2]) for m, w in zip(got, want) if m[2] != w[2]]
    tij = max(float(abs(m[3] - w[3]).max()) for m, w in zip(got, want))
    tij_same = max((float(abs(m[3] - w[3]).max()) for m, w in
                    zip(got, want) if m[2] == w[2]), default=0.0)
    score = max(abs(m[4] - w[4]) / abs(w[4]) for m, w in zip(got, want))
    return (f"{len(got)} pairs equal; num_assoc differ {na}; t_ij max "
            f"{tij:.3e} ({tij_same:.3e} where num_assoc is equal); score "
            f"rel max {score:.3e}")


def compare(d: str) -> None:
    """Step 3: each pair of PAIRS."""
    import numpy as np
    res = {}
    for name in VARIANTS:
        with open(os.path.join(d, f"{name}.pkl"), "rb") as f:
            res[name] = pickle.load(f)
    loop_type = 1        # posegraph.LOOP_APPEARANCE
    for name, base in PAIRS:
        got, want = res[name], res[base]
        print(f"== {name} against {base}")
        print(f"  close_from_graph: pairs equal "
              f"{got['lc_pairs'] == want['lc_pairs']}; "
              + _edge_spread(got["lc_edges"], want["lc_edges"], loop_type))
        print(f"  add_mini_loops: pairs equal "
              f"{got['mini_pairs'] == want['mini_pairs']}; "
              + _edge_spread(got["mini_edges"], want["mini_edges"],
                             loop_type))
        o, w = got["opt"], want["opt"]
        print(f"  close_and_optimize: pairs equal "
              f"{got['opt_pairs'] == want['opt_pairs']}; poses max "
              f"{np.abs(o[:, :2] - w[:, :2]).max():.3e} m, "
              f"{np.abs(o[:, 2] - w[:, 2]).max():.3e} rad")
        for key in ("ab", "yaw"):
            print(f"  cross_session_matches {key}: "
                  + _match_spread(got[f"{key}_matches"],
                                  want[f"{key}_matches"])
                  + f"; t_ab max {np.abs(got[f'{key}_t_ab'] - want[f'{key}_t_ab']).max():.3e}"
                  f"; inliers equal "
                  f"{got[f'{key}_inliers'] == want[f'{key}_inliers']}")
        o, w = got["merge_opt"], want["merge_opt"]
        print(f"  merge_sessions(A, B): constraints equal "
              f"{got['merge_types'] == want['merge_types']}; inliers equal "
              f"{got['merge_inliers'] == want['merge_inliers']}; t_ab max "
              f"{np.abs(got['merge_t_ab'] - want['merge_t_ab']).max():.3e}; "
              f"poses max {np.abs(o[:, :2] - w[:, :2]).max():.3e} m, "
              f"{np.abs(o[:, 2] - w[:, 2]).max():.3e} rad")
        print("  merge_many([A, B, C]): t_ab max "
              + ", ".join(f"{np.abs(a - b).max():.3e}" for a, b in
                          zip(got["three_t_ab"], want["three_t_ab"])))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="/tmp/reference_spread")
    ap.add_argument("--variant", choices=tuple(VARIANTS), default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.variant:
        run_variant(args.variant, args.dir)
        return
    os.makedirs(args.dir, exist_ok=True)
    import jax
    jax.config.update("jax_platforms", "cpu")
    make_inputs(args.dir)
    for name, flags in VARIANTS.items():
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
                   XLA_FLAGS=flags)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--variant", name, "--dir", args.dir], env=env,
                       check=True)
    compare(args.dir)


if __name__ == "__main__":
    main()
