"""The reference's own spread on the CPU problems of
`tests/test_torch_eval_tools.py` and on kernel F's cost/loss cases of
`chip_smoke.py` and `tests/test_torch_cuda.py`, beside the port's
deviation from the reference.

That test holds the port's evaluation tools (`run_ablation_sweep_torch.py`,
`run_sim_sensitivity_torch.py`) to the reference's (`run_ablation_sweep.py`,
`run_sim_sensitivity.py`) on two small problems, both on the CPU:

- ABLATION: the Tukey-0.1 and None-0.1 jobs of the `loss_function` grid
  (`parallel/sweep.py:ABLATIONS`) as one grid, seed 11, 36 frames of the
  sweep's adversarial world (the first length at which the CLI's KITTI
  drift has a 100 m subsequence);
- SIM: the baseline and the `saturation` knob's two levels, seed 11, 40
  frames;
- AB: the time-continuous A/B (`run_time_continuous_ab.py`), seed 11, 40
  frames at 12 m/s;
- AB256: the same at its defaults (256 frames), the run of the reference's
  artifact, which `tests/test_torch_trends.py` sets the port's card run
  beside: there the port runs kernel A (`auto` on a card), so the spread
  that bounds it is `kernelA`'s (the port does not run AB256 here);
- PRESETS: the paper's CFEAR-1 and CFEAR-2 presets and CFEAR-3 with
  `--filter_type cacfar`, with the bucket-grid association (`grid`) and
  with `--use_raw_pointcloud` (`raw`) through the offline CLI
  (`run_preset_cli`), at `bench.py --quick`'s sensor geometry (128
  azimuths x 256 bins of 0.6 m, max_cells 256, 1024 raw cells), seed 3,
  12 frames; and CFEAR-3 at 1024 cells on 6 sweeps of the Kvarntorp and
  Volvo geometries (400 x 832,
  `--dataset kvarntorp|volvo` over a directory that
  `chip_smoke.write_dataset` writes): each variant's poses, keyframe and
  success flags, and the spread of each from `dense`
  (`tests/test_torch_cli.py::test_preset_cli_matches_the_reference`),
  with a fifth variant, `eager`: the reference run op by op
  (`jax.disable_jit()`, about a minute a preset); `--presets` picks some;
- RES15: the job of the ablation sweep that fails frames on the card,
  `resolution/seed_12/job_0` (res 1.5, 120 frames), as
  `run_ablation_sweep.py` runs it (`--n-workers 5 --worker-index 0`):
  each variant's keyframes and failed frames, drift and ATE (ROADMAP.md,
  queue 3).

Both sides run the dense association on the CPU (`auto`). The rows can
part within float32 rounding, so the test's bounds on drift and ATE are
the reference's own spread on the same problems, about 3x: each variant's
largest deviation from the reference as the test runs it (`dense`):
- `kernelA`: the reference with `assoc_method="pallas"`, kernel A in
  interpret mode (the distance as dx*dx + dy*dy);
- `avx`: the reference with XLA limited to AVX
  (`XLA_FLAGS=--xla_cpu_max_isa=AVX`: no FMA contraction).
The port's own deviation from `dense` is printed beside them.

The LM cases (`--problems lm`, in this process, about a minute): each pair
of `chip_smoke.LM_CASES` on `chip_smoke.lm_problem` at the slice's width
(B=8, N=4,096), as `chip_smoke.phase_lm` draws them (one generator of seed
1 in order) and as `test_kernel_f_matches_plain` does (seed 2): the
largest |dpose| between the reference's fused LM kernel (interpret mode)
and its packed-XLA loop over the lanes, the lanes where their accepted
steps differ, and the port's twin's |dpose| from the XLA loop. Kernel F
is held to its twin at `chip_smoke.LM_POSE_TOL`, or at the loss's own
bound where the reference's spread is wider.

    JAX_PLATFORMS=cpu python tools/tool_spread_torch.py [--dir DIR]
    JAX_PLATFORMS=cpu python tools/tool_spread_torch.py --problems ab256
    JAX_PLATFORMS=cpu python tools/tool_spread_torch.py --problems lm
    JAX_PLATFORMS=cpu python tools/tool_spread_torch.py --problems presets --presets grid,raw

About three minutes on the CPU for ABLATION, SIM and AB, and five more for
AB256 (each variant in a process of its own).
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import importlib.util
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
sys.path.insert(0, ROOT)

ABLATION = {"grid": "loss_tukey_none",
            "jobs": {"loss_type": ["Tukey", "None"], "loss_limit": [0.1]},
            "seeds": "11", "frames": 36}
SIM = {"knobs": "saturation", "seeds": "11", "frames": 40,
       "groups": ("baseline", "knobs")}
AB_FRAMES = {"ab": 40, "ab256": 256}
RES15 = ["--grids", "resolution", "--seeds", "12", "--n-frames", "120",
         "--n-workers", "5", "--worker-index", "0"]
PRESETS = {"CFEAR-1": ("CFEAR-1", ()), "CFEAR-2": ("CFEAR-2", ()),
           "cacfar": ("CFEAR-3", ("--filter_type", "cacfar")),
           "grid": ("CFEAR-3", ()),
           "raw": ("CFEAR-3", ("--use_raw_pointcloud",)),
           "kvarntorp": ("CFEAR-3", ()), "volvo": ("CFEAR-3", ())}
PRESET_FRAMES = 12
# PRESETS read from a dataset directory instead of rendered in the CLI: a
# few sweeps at the sensor's own geometry (400 x 832), written by
# `chip_smoke.write_dataset` in MulRan's layout
PRESET_DATASETS = {"kvarntorp": 6, "volvo": 6}
# the cell budgets of the CPU problems that would otherwise take the
# presets' 3072 cells (the 832-bin datasets) or 4096 raw cells, which the
# CPU's dense association spends most of a test's time on
PRESET_CELLS = 1024
# the PRESETS a run takes (`--presets`; all by default)
SELECTED = list(PRESETS)
VARIANTS = ("dense", "kernelA", "avx", "port")
# ...and for PRESETS only, the reference op by op (`jax.disable_jit()`):
# its compiled form fuses the image filter with the motion compensation,
# which rounds a point to the other side of a cell's gate where the port
# and the reference run op by op do not (CFEAR-2, frames 2-4 and 7)
EAGER = "eager"
# the rows' columns each test compares: exactly, and within a bound
EXACT = ("keyframes", "registration_failures")
BOUNDED = ("t_err_percent", "ate_m")


def load_tool(name: str):
    """A tool of `tools/` as a module (the tools are scripts)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def ablation_grid(sweep_mod):
    """ABLATION's grid added to `sweep_mod.ABLATIONS` while the block
    runs."""
    sweep_mod.ABLATIONS[ABLATION["grid"]] = ABLATION["jobs"]
    try:
        yield
    finally:
        del sweep_mod.ABLATIONS[ABLATION["grid"]]


@contextlib.contextmanager
def sim_rows(tool):
    """The sim tool `tool` (a module) without its rows beyond SIM's groups:
    the reference's tool has no `--groups`, so its lists of the other
    groups are emptied while the block runs."""
    saved = {k: getattr(tool, k) for k in
             ("BEYOND", "MITIGATED", "BEYOND_MITIGATED")}
    for k in saved:
        setattr(tool, k, [])
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(tool, k, v)


def ablation_argv(d: str) -> list:
    return ["--grids", ABLATION["grid"], "--seeds", ABLATION["seeds"],
            "--n-frames", str(ABLATION["frames"]),
            "--output-root", os.path.join(d, "sweep"),
            "--csv", os.path.join(d, "ablation.csv")]


def sim_argv(d: str) -> list:
    return ["--knobs", SIM["knobs"], "--seeds", SIM["seeds"],
            "--n-frames", str(SIM["frames"]),
            "--out", os.path.join(d, "sim.csv")]


def res15_argv(d: str) -> list:
    return RES15 + ["--output-root", os.path.join(d, "res15"),
                    "--csv", os.path.join(d, "res15.csv")]


def preset_cfg(name: str) -> dict:
    """PRESETS[name]'s configuration as a dict: the reference's preset at
    `bench.py --quick`'s sensor geometry (`bench.py:113-119`), max_cells
    256 and max_cells_raw PRESET_CELLS (`grid`: with the bucket-grid
    association); for PRESET_DATASETS the dataset's own preset at
    PRESET_CELLS cells. Built through `config.preset` at call
    time, so `run_reference`'s kernel-A variant gives it
    `assoc_method="pallas"` (but `grid`)."""
    from cfear_radarodometry_code_public_tpu import config
    if name in PRESET_DATASETS:
        cfg = config.preset(PRESETS[name][0], dataset=name)
        return cfg.replace(feature=dataclasses.replace(
            cfg.feature, max_cells=PRESET_CELLS)).to_dict()
    cfg = config.preset(PRESETS[name][0], dataset="synthetic")
    cfg = cfg.replace(
        radar=dataclasses.replace(cfg.radar, n_azimuths=128, n_bins=256,
                                  range_res=0.6, max_distance=100.0),
        feature=dataclasses.replace(cfg.feature, max_cells=256,
                                    max_cells_raw=PRESET_CELLS))
    if name == "grid":
        cfg = cfg.replace(registration=dataclasses.replace(
            cfg.registration, assoc_method="grid"))
    return cfg.to_dict()


def run_preset_cli(cli_mod, runner_cls, d: str, name: str, cfg: dict) -> dict:
    """The offline CLI `cli_mod` (the reference's or the port's) on
    PRESETS[name] with the configuration `cfg` as --config-file, on the
    CPU, under `d`: {"poses" (T, 3) of est/00.txt, "fused", "success",
    "result", "cfg" (the runner's)}; all but "cfg" also saved as
    `d/presets_<name>.npz`."""
    import json

    import numpy as np

    import chip_smoke
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    if name in PRESET_DATASETS:
        root = os.path.join(d, f"{name}_in")
        chip_smoke.write_dataset(name, root, PRESET_DATASETS[name])
        source = ["--dataset", name, "--radar-dir",
                  chip_smoke.radar_dir(name, root), "--gt-csv",
                  os.path.join(root, "gt.csv")]
    else:
        source = ["--dataset", "synthetic", "--seed", "3", "--n-frames",
                  str(PRESET_FRAMES)]
    run = chip_smoke.run_cli(cli_mod, runner_cls, [
        "--config-file", path, *source, "--chunk", "4", "--output-dir",
        os.path.join(d, name), "--cpu", *PRESETS[name][1]])
    out = {k: run[k] for k in ("poses", "fused", "success")}
    np.savez(os.path.join(d, f"presets_{name}.npz"), **out,
             result=json.dumps(run["result"]))
    return {**out, "result": run["result"], "cfg": run["cfg"]}


def ab_argv(d: str, problem: str) -> list:
    return ["--n-frames", str(AB_FRAMES[problem]),
            "--out", os.path.join(d, f"{problem}.txt")]


def run_reference(d: str, problems, kernel_a: bool = False) -> None:
    """The reference's tools on `problems`, into `d` (ablation.csv,
    sim.csv, ab.txt); with `kernel_a`, every preset they build takes
    `assoc_method="pallas"`."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from cfear_radarodometry_code_public_tpu import config
    from cfear_radarodometry_code_public_tpu.parallel import sweep

    preset = config.preset

    def preset_a(*args, **kw):
        cfg = preset(*args, **kw)
        return cfg.replace(registration=dataclasses.replace(
            cfg.registration, assoc_method="pallas"))

    if kernel_a:
        config.preset = preset_a
    try:
        if "ablation" in problems:
            with ablation_grid(sweep):
                load_tool("run_ablation_sweep").main(ablation_argv(d))
        if "sim" in problems:
            tool = load_tool("run_sim_sensitivity")
            with sim_rows(tool):
                tool.main(sim_argv(d))
        for problem in AB_FRAMES:
            if problem in problems:
                load_tool("run_time_continuous_ab").main(ab_argv(d, problem))
        if "res15" in problems:
            load_tool("run_ablation_sweep").main(res15_argv(d))
        if "presets" in problems:
            from cfear_radarodometry_code_public_tpu import offline_odometry
            from cfear_radarodometry_code_public_tpu.models.odometry import (
                OdometryRunner)
            for name in SELECTED:
                run_preset_cli(offline_odometry, OdometryRunner, d, name,
                               preset_cfg(name))
    finally:
        config.preset = preset


def run_port(d: str, problems) -> None:
    """The port's tools on `problems` but AB256, on the CPU, into `d`."""
    from cfear_radarodometry_code_public_tpu_torch.parallel import sweep
    if "ablation" in problems:
        with ablation_grid(sweep):
            load_tool("run_ablation_sweep_torch").main(ablation_argv(d)
                                                       + ["--cpu"])
    if "sim" in problems:
        load_tool("run_sim_sensitivity_torch").main(
            sim_argv(d) + ["--cpu", "--groups", ",".join(SIM["groups"])])
    if "ab" in problems:
        load_tool("run_time_continuous_ab_torch").main(ab_argv(d, "ab")
                                                       + ["--cpu"])
    if "res15" in problems:
        load_tool("run_ablation_sweep_torch").main(res15_argv(d) + ["--cpu"])
    if "presets" in problems:
        from cfear_radarodometry_code_public_tpu_torch import offline_odometry
        from cfear_radarodometry_code_public_tpu_torch.models.odometry import (
            OdometryRunner)
        for name in SELECTED:
            run_preset_cli(offline_odometry, OdometryRunner, d, name,
                           preset_cfg(name))


def read_ab(path: str) -> dict:
    """{mode: (t_err %, ATE m, all_success)} of an A/B artifact, the
    reference's layout ("tc=off  t_err  r_err  ATE  all_success")."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("tc="):
                mode, t_err, _, ate, ok = line.split()
                out[mode] = (float(t_err), float(ate), ok == "True")
    return out


def read(path: str, key: str) -> dict:
    with open(path, newline="") as f:
        return {tuple(r[k] for k in key.split(",")): r
                for r in csv.DictReader(f)}


def deviation(got: dict, want: dict) -> dict:
    """Per column of BOUNDED, the largest |got - want| over the rows (nan
    equal to nan); per column of EXACT, the rows that differ."""
    out = {}
    for col in BOUNDED:
        devs = []
        for k, r in want.items():
            a, b = float(got[k][col]), float(r[col])
            devs.append(0.0 if (a != a and b != b) else abs(a - b))
        out[col] = max(devs)
    for col in EXACT:
        out[col] = sorted(k for k, r in want.items()
                          if col in r and got[k][col] != r[col])
    return out


def compare(d: str, problems) -> None:
    files = (("ablation", "ablation.csv", "job"),
             ("sim", "sim.csv", "knob,level,seed"))
    for problem, name, key in files:
        if problem not in problems:
            continue
        want = read(os.path.join(d, "dense", name), key)
        for v in VARIANTS[1:]:
            got = read(os.path.join(d, v, name), key)
            print(f"{name}: {v} vs dense: {deviation(got, want)}")
    if "res15" in problems:
        for v in VARIANTS:
            for r in read(os.path.join(d, v, "res15.csv"), "job").values():
                print(f"res15.csv: {v}: {r['job']}: keyframes "
                      f"{r['keyframes']}, failed frames "
                      f"{r['registration_failures']}, drift "
                      f"{float(r['t_err_percent']):.4f} %, ATE "
                      f"{float(r['ate_m']):.4f} m")
    if "presets" in problems:
        import numpy as np

        import chip_smoke
        for name in SELECTED:
            with np.load(os.path.join(d, "dense",
                                      f"presets_{name}.npz")) as z:
                want = dict(z)
            for v in VARIANTS[1:] + (EAGER,):
                with np.load(os.path.join(d, v, f"presets_{name}.npz")) as z:
                    got = dict(z)
                dpos, dyaw, dmot = chip_smoke.traj_spread(got["poses"],
                                                          want["poses"])
                print(f"presets {name}: {v} vs dense: max |dpos| {dpos:.6f} "
                      f"m, |dyaw| {dyaw:.3e} rad, |dmotion| {dmot:.6f} m; "
                      f"keyframes equal "
                      f"{bool(np.array_equal(got['fused'], want['fused']))}"
                      f" ({int(got['fused'].sum())}); failed frames "
                      f"{np.flatnonzero(~got['success']).tolist()} (dense "
                      f"{np.flatnonzero(~want['success']).tolist()})")
    for problem in AB_FRAMES:
        if problem not in problems:
            continue
        name = f"{problem}.txt"
        want = read_ab(os.path.join(d, "dense", name))
        for v in VARIANTS[1:] if problem == "ab" else ("kernelA", "avx"):
            got = read_ab(os.path.join(d, v, name))
            print(f"{name}: {v} vs dense: " + ", ".join(
                f"{m}: |d t_err| {abs(got[m][0] - w[0]):.3f} %, |d ATE| "
                f"{abs(got[m][1] - w[1]):.3f} m, all_success {got[m][2]}"
                for m, w in want.items()))


def lm_spread() -> None:
    """`--problems lm`: the reference's own LM spread on kernel F's cases
    (see the module's docstring), printed."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke
    from cfear_radarodometry_code_public_tpu.config import CFEARConfig
    from cfear_radarodometry_code_public_tpu.ops import pallas_lm
    from cfear_radarodometry_code_public_tpu_torch.ops import cuda_lm

    jax.config.update("jax_platforms", "cpu")
    rng = np.random.default_rng(1)
    cases = [("chip_smoke", c, l, chip_smoke.lm_problem(rng, 8, 4, 1024, c, l))
             for c, l in chip_smoke.LM_CASES]
    cases += [("test_kernel_f_matches_plain", c, l, chip_smoke.lm_problem(
        np.random.default_rng(2), 8, 4, 1024, c, l))
        for c, l in chip_smoke.LM_CASES]
    for where, cost, loss, (cfg, packed, pose0, _) in cases:
        jcfg = CFEARConfig.from_dict(cfg.to_dict())
        twin = cuda_lm.lm_solve_fused_plain(torch.as_tensor(packed),
                                            torch.as_tensor(pose0), cfg)
        spread, port, lanes = 0.0, 0.0, []
        for i in range(packed.shape[0]):
            args = (jnp.asarray(packed[i]), jnp.asarray(pose0[i]), jcfg)
            x = pallas_lm.lm_solve_packed_xla(*args)
            k = pallas_lm.lm_solve_fused(*args, interpret=True,
                                         early_exit=True)
            spread = max(spread, float(np.abs(np.asarray(k[0])
                                              - np.asarray(x[0])).max()))
            port = max(port, float(np.abs(twin[0][i].numpy()
                                          - np.asarray(x[0])).max()))
            if int(k[2]) != int(x[2]):
                lanes.append((i, int(k[2]), int(x[2])))
        print(f"lm {where} {cost}/{loss}: reference kernel vs XLA max "
              f"|dpose| {spread:.3e}, lanes whose steps differ (lane, "
              f"kernel, XLA) {lanes}; port twin vs XLA {port:.3e}; twin "
              f"steps {twin[2].tolist()}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "tool_spread"))
    ap.add_argument("--variant", choices=VARIANTS + (EAGER,), default=None,
                    help="run one variant in this process")
    ap.add_argument("--problems", default="ablation,sim,ab",
                    help="of ablation, sim, ab, ab256, res15, presets; or "
                         "lm alone")
    ap.add_argument("--presets", default=",".join(PRESETS),
                    help="presets: which of PRESETS to run")
    args = ap.parse_args()
    problems = args.problems.split(",")
    SELECTED[:] = args.presets.split(",")
    if problems == ["lm"]:
        lm_spread()
        return
    if args.variant:
        d = os.path.join(args.dir, args.variant)
        os.makedirs(d, exist_ok=True)
        if args.variant == "port":
            run_port(d, problems)
        elif args.variant == EAGER:
            import jax
            with jax.disable_jit():
                run_reference(d, problems)
        else:
            run_reference(d, problems, kernel_a=args.variant == "kernelA")
        return
    for v in VARIANTS + (EAGER,):
        if v == "port" and problems == ["ab256"] \
                or v == EAGER and problems != ["presets"]:
            continue
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        if v == "avx":
            env["XLA_FLAGS"] = "--xla_cpu_max_isa=AVX"
        subprocess.run([sys.executable, __file__, "--dir", args.dir,
                        "--variant", v, "--problems", args.problems,
                        "--presets", args.presets],
                       env=env, check=True, stdout=subprocess.DEVNULL)
    compare(args.dir, problems)


if __name__ == "__main__":
    main()
