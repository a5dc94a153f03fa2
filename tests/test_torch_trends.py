"""The reference's evaluation experiments, run by the port on the card.

`eval_results/ablation_sweep_torch_h100.csv`
(`tools/run_ablation_sweep_torch.py`), `sim_sensitivity_torch_h100.csv`
(`tools/run_sim_sensitivity_torch.py`) and
`TIME_CONTINUOUS_AB_torch_h100.txt` (`tools/run_time_continuous_ab_torch.py`)
are the port's runs on an NVIDIA H100 of the reference's three
experiments, at the parameters of the reference's own artifacts beside
them. Every assertion of `tests/test_ablation_trends.py` and
`tests/test_sim_sensitivity.py` is applied to the port's CSVs unchanged:
each of their `test_*` functions is called, as a case of one parametrised
test here, with the rows of the port's CSV in place of the reference's.
The A/B is held to the reference's artifact: both modes successful on
every frame, each mode's drift and ATE within a bound from the
reference's own spread on that run (`tools/tool_spread_torch.py
--problems ab256`). The artifacts are committed, so these tests are
deterministic and need no card.
"""

import csv
import os

import pytest

import test_ablation_trends as ablation
import test_sim_sensitivity as sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "eval_results")
ABLATION_CSV = os.path.join(RESULTS, "ablation_sweep_torch_h100.csv")
SIM_CSV = os.path.join(RESULTS, "sim_sensitivity_torch_h100.csv")
AB_TXT = os.path.join(RESULTS, "TIME_CONTINUOUS_AB_torch_h100.txt")
REF_AB_TXT = os.path.join(RESULTS, "TIME_CONTINUOUS_AB.txt")
SIM_TESTS = [n for n in vars(sim) if n.startswith("test_")]
# `test_sweep_complete` requires no failed frame outside the Tukey rows.
# The port fails 6 frames of `resolution/seed_12/job_0` (res 1.5) where
# the reference's CSV, made by an earlier version of the reference, has
# none; the reference as it stands fails 15 (dense, as its CSV was made)
# and 7 (kernel A, as the port runs on a card) frames of the same job on
# the CPU. Every failed frame of every run lies in frames 98-119, where the
# vehicle has left the world's structure (4-36 valid cells, 0-6
# associations a frame); compaction drops no cell in any frame (at most 357
# valid cells of 1024). Closed as a finding, not a port fault
# (`tools/res15_frames_torch.py`): ROADMAP.md, queue 3, the closed entry
# "the res=1.5 ablation job fails frames".
ABLATION_TESTS = [
    pytest.param(n, marks=pytest.mark.xfail(strict=True, reason=(
        "ROADMAP.md queue 3, the closed entry 'the res=1.5 ablation job "
        "fails frames': resolution/seed_12/job_0 fails 6 frames on the "
        "card, the reference as it stands 15 (dense) and 7 (kernel A), all "
        "in frames 98-119 with 0-6 associations a frame")))
    if n == "test_sweep_complete" else n
    for n in vars(ablation) if n.startswith("test_")]


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _ab(path):
    """{mode: (t_err %, ATE m, all_success)} and the header line of an A/B
    artifact in the reference's layout."""
    with open(path) as f:
        lines = f.read().splitlines()
    rows = {}
    for line in lines:
        if line.startswith("tc="):
            mode, t_err, _, ate, ok = line.split()
            rows[mode] = (float(t_err), float(ate), ok == "True")
    return rows, lines[1]


@pytest.mark.parametrize("name", ABLATION_TESTS)
def test_ablation_trend_on_the_port(name):
    """`tests/test_ablation_trends.py::<name>` on the port's CSV."""
    getattr(ablation, name)(_rows(ABLATION_CSV))


@pytest.mark.parametrize("name", SIM_TESTS)
def test_sim_sensitivity_on_the_port(name):
    """`tests/test_sim_sensitivity.py::<name>` on the port's CSV."""
    getattr(sim, name)(_rows(SIM_CSV))


def test_artifacts_name_the_card_and_the_reference_parameters():
    """Every row of both CSVs names one card and its power limit; the
    ablation CSV has the reference CSV's columns and jobs, seeds and
    frames, plus `device`; the sim CSV the reference's rows."""
    rows = _rows(ABLATION_CSV)
    ref = _rows(os.path.join(RESULTS, "ablation_sweep.csv"))
    assert {r["job"]: (r["seed"], r["frames"]) for r in rows} == \
        {r["job"]: (r["seed"], r["frames"]) for r in ref}
    sims = _rows(SIM_CSV)
    ref_sims = _rows(os.path.join(RESULTS, "sim_sensitivity.csv"))
    key = ("knob", "level", "seed")
    assert [tuple(r[k] for k in key) for r in sims] == \
        [tuple(r[k] for k in key) for r in ref_sims]
    assert list(sims[0]) == list(ref_sims[0]) + ["device"]
    devices = {r["device"] for r in rows + sims}
    assert len(devices) == 1
    device = devices.pop()
    assert device.startswith("NVIDIA") and device.endswith(" W"), device
    _, header = _ab(AB_TXT)
    assert f"device={device} " in header and "backend=" not in header


# The A/B's bounds (drift percentage points, ATE m): the reference's own
# spread on this run, about 3x. Its dense association (as its artifact was
# made, which the reference as it stands reproduces to the digit) against
# kernel A in interpret mode (what the port runs on a card) and against XLA
# limited to AVX (`tools/tool_spread_torch.py --problems ab256`): drift
# 0.004 / 0.004 points and ATE 0.018 / 0.015 m with time-continuous
# registration off, 0.001 / 0.008 points and 0.006 / 0.037 m on.
AB_TOL = (0.024, 0.11)


def test_time_continuous_ab_on_the_port():
    """Both modes successful on every frame, as in the reference's
    artifact; each mode's drift and ATE beside the reference's, within
    AB_TOL (drift percentage points, ATE m); the same run as the
    reference's (seed, frames, speed, cells)."""
    got, header = _ab(AB_TXT)
    want, ref_header = _ab(REF_AB_TXT)
    assert header.split(" device=")[0] == ref_header.split(" backend=")[0]
    assert set(got) == set(want) == {"tc=off", "tc=on"}
    for mode, (t_err, ate, ok) in got.items():
        assert ok and want[mode][2], mode
        assert abs(t_err - want[mode][0]) <= AB_TOL[0], (mode, t_err, want)
        assert abs(ate - want[mode][1]) <= AB_TOL[1], (mode, ate, want)


def test_tukey_rows_fail_frames_on_the_port():
    """The half of `test_sweep_complete` that its queue-3 entry leaves
    standing: the divergent Tukey-0.1 configuration fails frames through
    the divergence gate (`min_assoc_fraction`) on the card, in the row
    of every seed where the reference's CSV does."""
    rows = _rows(ABLATION_CSV)
    ref = {r["job"]: r for r in _rows(os.path.join(RESULTS,
                                                   "ablation_sweep.csv"))}
    tukey = [r for r in rows if r["registration.loss"] == "Tukey"
             and r["registration.loss_limit"] == "0.1"]
    assert len(tukey) == 2 and max(int(r["registration_failures"])
                                   for r in tukey) > 0
    for r in tukey:
        if int(ref[r["job"]]["registration_failures"]):
            assert int(r["registration_failures"]) > 0, r["job"]
