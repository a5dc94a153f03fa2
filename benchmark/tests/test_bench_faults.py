"""The check fails a run whose timed path is broken underneath: the harness
is driven as in a run (on the CPU, past its look for a card), with the
runner's chunk step wrapped by each fault this cell can have. (The cells run
on one chip: no exchange between chips can be left out.)"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import harness
from cfear_radarodometry_code_public_tpu_torch.models import odometry


def state_unchanged(step_chunk):
    """Every step hands back the state it was given."""
    def run(states, inputs):
        _, out = step_chunk(states, inputs)
        return states, out
    return run


def half_batch_mean(step_chunk):
    """Only the first half of the lanes is stepped; the other half's
    outputs are the mean of the first half's."""
    def run(states, inputs):
        b = states.t_prev.shape[0]
        h = b // 2
        first = type(states)(*_rows(states, slice(0, h)))
        new_first, out = step_chunk(first, inputs[:h])
        new = type(states)(*(_cat(a, n, h) for a, n in zip(states,
                                                            new_first)))
        filled = [torch.cat([o, _mean(o).expand((b - h,) + o.shape[1:])])
                  for o in out]
        return new, type(out)(*filled)
    return run


def answer_altered(step_chunk):
    """The pose of one frame of every chunk is moved by 0.5 m where it is
    produced."""
    def run(states, inputs):
        new, out = step_chunk(states, inputs)
        pose = out.pose.clone()
        pose[:, inputs.shape[1] // 2, 0] += 0.5
        return new, out._replace(pose=pose)
    return run


def gate_always_fuses(step_chunk):
    """The keyframe gate fuses every registered frame: each step's back
    half runs with the configuration's keyframe switch off."""
    def run(states, inputs):
        fuse_frame = odometry._fuse_frame

        def fuse_all(state, cells, cfg):
            return fuse_frame(state, cells, cfg.replace(
                odometry=dataclasses.replace(cfg.odometry,
                                             use_keyframe=False)))
        odometry._fuse_frame = fuse_all
        try:
            return step_chunk(states, inputs)
        finally:
            odometry._fuse_frame = fuse_frame
    return run


def _rows(tree, rows):
    if isinstance(tree, tuple):
        return type(tree)(*(_rows(t, rows) for t in tree)) \
            if hasattr(tree, "_fields") else tuple(_rows(t, rows)
                                                   for t in tree)
    return tree[rows]


def _cat(old, new, h):
    if isinstance(old, tuple):
        return type(old)(*(_cat(o, n, h) for o, n in zip(old, new)))
    return torch.cat([new, old[h:]])


def _mean(t):
    if t.dtype == torch.bool:
        return t.float().mean(0, keepdim=True) > 0.5
    if not t.is_floating_point():
        return t.float().mean(0, keepdim=True).round().to(t.dtype)
    return t.mean(0, keepdim=True)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch_mean,
                                   answer_altered, gate_always_fuses])
def test_a_broken_step_is_not_correct(tiny_root, fault):
    res = harness.run_cell("tiny4", 2**31 + 9, 1.0, False, "cpu",
                           root=tiny_root, fault=fault, log=lambda m: None)
    assert not res["correct"], res["check"]
    assert any(v["value"] > v["limit"] for v in res["check"].values())
