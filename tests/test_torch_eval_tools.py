"""The port's evaluation tools against the reference's, on the CPU.

`tools/run_ablation_sweep_torch.py`, `run_sim_sensitivity_torch.py` and
`run_time_continuous_ab_torch.py` (the port, `--cpu`) and the reference's
`run_ablation_sweep.py`, `run_sim_sensitivity.py` and
`run_time_continuous_ab.py` run the small problems of
`tools/tool_spread_torch.py` on the same seed: one grid of the ablation
sweep (Tukey-0.1 and None-0.1, 36 frames), the simulator sweep's baseline
and one knob (40 frames), and the time-continuous A/B (40 frames). The
CSVs must have the same columns (the port's also `device`, "cpu" here),
the same keyframe counts and failed frames (the Tukey-0.1 job failing
some through the divergence gate), and drift and ATE within bounds from
the reference's own spread on the same problems.

Tolerance: both sides run the dense association on the CPU in float32,
and a registration can part on a decision within float32 rounding. The
bounds are about 3x the largest deviation of the reference's own
variants from the reference as run here (kernel A in interpret mode, and
XLA limited to AVX: no FMA), `tools/tool_spread_torch.py
--problems ablation,sim,ab`: over the ablation rows drift 0.0107 / 0.284
percentage points (kernel A / AVX; the AVX run's on the Tukey row, whose
drift is 100%) and ATE 1.14 / 1.24 mm, over the sim rows drift 0.0096 /
0.0066 points and ATE 0.8 / 0.1 mm (the port there: 0.0065 points and
0.85 mm, 0.0093 points and 0.2 mm); over the A/B modes (40 frames,
`--problems ab`) drift 0.009 / 0.006 points and ATE 0 / 0 at the file's
three decimals (the port: 0.009 points, 0): AB_TOL is 3x the drift and
one and a half units of the ATE's last printed digit.
"""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "tool_spread_torch", os.path.join(REPO, "tools", "tool_spread_torch.py"))
spread = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(spread)

ABLATION_TOL = {"t_err_percent": 0.85, "ate_m": 0.0037}
SIM_TOL = {"t_err_percent": 0.029, "ate_m": 0.0024}
AB_TOL = (0.027, 0.0015)


def _both(tmp_path, problem):
    """Run `problem` through the reference's tool and the port's into
    tmp_path/ref and tmp_path/port."""
    dirs = {k: str(tmp_path / k) for k in ("ref", "port")}
    for d in dirs.values():
        os.makedirs(d)
    spread.run_reference(dirs["ref"], (problem,))
    spread.run_port(dirs["port"], (problem,))
    return dirs


def _columns(path):
    with open(path) as f:
        return f.readline().strip().split(",")


@pytest.mark.parametrize("problem,name,key,tol", [
    ("ablation", "ablation.csv", "job", ABLATION_TOL),
    ("sim", "sim.csv", "knob,level,seed", SIM_TOL)])
def test_tool_equals_the_reference(tmp_path, problem, name, key, tol):
    dirs = _both(tmp_path, problem)
    paths = {k: os.path.join(d, name) for k, d in dirs.items()}
    ref_cols, port_cols = _columns(paths["ref"]), _columns(paths["port"])
    if problem == "ablation":     # sweep.merge sorts the columns
        assert port_cols == sorted(ref_cols + ["device"])
    else:
        assert port_cols == ref_cols + ["device"]
    want = spread.read(paths["ref"], key)
    got = spread.read(paths["port"], key)
    assert list(got) == list(want) and len(want) >= 2
    assert {r["device"] for r in got.values()} == {"cpu"}
    dev = spread.deviation(got, want)
    for col in spread.EXACT:
        assert dev[col] == [], (col, dev)
    for col, bound in tol.items():
        assert dev[col] <= bound, (col, dev)
    if problem == "ablation":
        tukey = [r for r in got.values() if r["registration.loss"] == "Tukey"]
        assert tukey and int(tukey[0]["registration_failures"]) > 0
        assert all(int(r["registration_failures"]) == 0
                   for r in got.values() if r is not tukey[0])


def test_time_continuous_ab_tool_equals_the_reference(tmp_path):
    dirs = _both(tmp_path, "ab")
    got, want = (spread.read_ab(os.path.join(d, "ab.txt"))
                 for d in (dirs["port"], dirs["ref"]))
    with open(os.path.join(dirs["port"], "ab.txt")) as f:
        port_lines = f.read().splitlines()
    with open(os.path.join(dirs["ref"], "ab.txt")) as f:
        ref_lines = f.read().splitlines()
    assert len(port_lines) == len(ref_lines)
    assert port_lines[1].split(" device=")[0] == \
        ref_lines[1].split(" backend=")[0]
    assert " device=cpu " in port_lines[1]
    assert set(got) == set(want) == {"tc=off", "tc=on"}
    for mode, (t_err, ate, ok) in got.items():
        assert ok == want[mode][2], mode
        assert abs(t_err - want[mode][0]) <= AB_TOL[0], (mode, got, want)
        assert abs(ate - want[mode][1]) <= AB_TOL[1], (mode, got, want)


def test_tools_need_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """Without a card and without --cpu each tool raises before any work;
    nothing is written."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    for name, argv in (
            ("run_ablation_sweep_torch",
             ["--grids", "baseline", "--seeds", "11", "--n-frames", "4",
              "--output-root", out, "--csv", out + ".csv"]),
            ("run_sim_sensitivity_torch",
             ["--seeds", "11", "--n-frames", "4", "--out", out + ".csv"]),
            ("run_time_continuous_ab_torch",
             ["--n-frames", "4", "--out", out + ".txt"])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            spread.load_tool(name).main(argv)
    assert not os.listdir(tmp_path)


def test_merge_parts_replaces_a_job_run_again(tmp_path):
    """Parts of a run split over calls merge into one CSV: the ablation
    tool's by job, sorted, a job run again in a later part replacing its
    earlier row; the sim tool's in the order given; parts with other
    columns are refused."""
    exp = spread.load_tool("experiments_torch")
    parts = []
    for i, rows in enumerate(([("b/seed_11/job_0", "1"), ("a/seed_11/job_1",
                                                          "2")],
                              [("a/seed_11/job_1", "3")])):
        parts.append(str(tmp_path / f"part{i}.csv"))
        exp.write_rows(parts[-1], [{"job": j, "t_err_percent": v,
                                    "device": "cpu"} for j, v in rows],
                       ["job", "t_err_percent", "device"])
    out = str(tmp_path / "merged.csv")
    assert exp.merge_parts(parts, out, key=lambda r: r["job"]) == 2
    assert [(r["job"], r["t_err_percent"]) for r in exp.read_rows(out)] == \
        [("a/seed_11/job_1", "3"), ("b/seed_11/job_0", "1")]
    assert exp.merge_parts(parts[::-1], out) == 3
    assert [r["t_err_percent"] for r in exp.read_rows(out)] == ["3", "1", "2"]
    exp.write_rows(parts[1], [{"job": "x", "fps": "1"}], ["job", "fps"])
    with pytest.raises(ValueError, match="columns differ"):
        exp.merge_parts(parts, out)
