"""The control: the reference computed in TF32, put in the program's place,
is told apart from the program by the check. At the cells' own size this
runs on the card (`readings.py --control tf32`); here at a tiny size on the
CPU, where TF32 is the reference's own rounding of the distance product's
operands."""

from __future__ import annotations

import pytest

from benchmark import harness


@pytest.mark.parametrize("seed", [2**31 + 9, 4])
def test_the_tf32_control_is_not_correct(tiny_root, seed):
    keep = {}
    sound = harness.run_cell("tiny4", seed, 1.0, False, "cpu",
                             root=tiny_root, keep=keep, log=lambda m: None)
    steps = keep["prog"]["pose"].shape[1]
    args = (keep["reference"], keep["params"], keep["drive"], keep["lanes"],
            steps, "cpu")
    ctl = harness.run_reference(*args, precision="tf32")
    rows = list(range(len(keep["lanes"])))
    ref = harness.run_reference(*args, follow=ctl, rows=rows,
                                checked=keep["checked"])
    check = harness.compare(ref, ctl, rows, keep["checked"], keep["limits"])
    assert sound["correct"]
    assert any(v["value"] > v["limit"] for v in check.values()), check
    for k in ("pose_gap_p90_m", "pose_gap_p99_m"):
        assert check[k]["value"] >= 3 * sound["check"][k]["value"], k
