"""Time the port's kernels F (fused LM solve), G (feature moments), C
(block-sparse 1-NN), A (dense 1-NN), B1 and B2 (A's function, the keyframe
loop in the kernel), D1 and D2 (C's function, the keyframe loop in the
kernel), E (C plus the winner's attributes) and the segment sum of several
source trees on one CUDA card, in turns inside one call.

    python tools/compare_torch_kernels.py [--out DIR] PARENT . . PARENT
    python tools/compare_torch_kernels.py --mode sweep [--out DIR]
    python tools/compare_torch_kernels.py --mode a-sweep [--out DIR]
    python tools/compare_torch_kernels.py --mode b-sweep [--out DIR]
    python tools/compare_torch_kernels.py --mode d-sweep [--out DIR]
    python tools/compare_torch_kernels.py --mode e-sweep [--out DIR]
    python tools/compare_torch_kernels.py --mode by-kernel

Each tree named (a checkout of the repo: `git archive <commit> | tar -x -C
<dir>`) is run in a process of its own, in the order given, so that two
versions are compared on one card under one power limit (parent, change,
change, parent). A run imports the port package of that tree, builds its
kernels, and drives them with this tree's `chip_smoke.py`, so that every
tree gets the same inputs, checks and timer: `phase_lm` and `phase_moments`
hold each kernel against its plain twin (and fail if they disagree) and
time it on the device alone (`chip_smoke._cuda_ms`: kernel F's early-exit
and masked variants at B=8 and early exit at B=1 at every width of
`chip_smoke.LM_SHAPES`, and early exit at the fleet shapes of
`chip_smoke.LM_FLEET`, kernel G at B=8 and B=1 beside the `index_add_`
yardstick); `phase_c_shapes` does the same for kernel C at every shape of
`chip_smoke.C_SHAPES` beside its bound and `cdist + min`, and the inner
loop of kernel C's split form, where the tree has one, is read from the
built library with `cuobjdump -sass` (instructions a distance, hence the
issue-slot floor: live distances x slots over SMs x 128 lanes at the
card's top SM clock); `phase_a_shapes` and the same SASS reading do it
for kernel A at every timed shape of `chip_smoke.A_SHAPES` (all
distances count: A has no live set); `_b_block` for B1 and B2 at every
shape of `chip_smoke.A_SHAPES` they take, each held bit for bit against A,
and `_d_block` for D1 and D2 at every shape of `chip_smoke.C_SHAPES`, each
held bit for bit against C, both with the SASS of whichever form the tree
has (`chip_smoke.sass_loop`); `_e_block` for E at every shape of
`chip_smoke.C_SHAPES` with 8 random attribute rows, held bit for bit
against its twin and its (nn, d2) against C's, with the SASS of
whichever form the tree has (the split kernel's E instance, or the first
form); `_s_block` times the feature stage's segment sums at the cells'
shapes (`chip_smoke.SEGMENT_SUM_SHAPES`): the tree's kernel, where it has
one, held bit for bit against torch's deterministic `index_add_` into
n + 1 rows cut to n, and that `index_add_`, the route the kernel replaced.
The one timer here, `_call_ms`, times the same calls back to
back: the slower of host and card, which is what a caller waits for. The
table goes to stdout; with `--out DIR` the records also go to
`DIR/compare_torch_kernels.json` (the sweep's to
`DIR/sweep_torch_lm_clusters.json`) and everything printed is appended to
`DIR/compare_torch_kernels.log`.

`--mode sweep` times this tree's kernel F at every cluster size (1, 2, 4,
8, 16) for each width and B in (1, 8): the basis of the rule that picks a
lane's cluster size from N. `--mode a-sweep` times this tree's kernel A
at every cluster size (1, 2, 4, 8) the kernel takes at each timed shape of
`chip_smoke.A_SHAPES`, each held bit for bit against the size
`dense_split` picks: the basis of `cuda_assoc.DENSE_MIN_CTAS`.
`--mode b-sweep` times this tree's B1 and B2 at every (keyframe groups,
cluster size) they take (groups up to S at one rank; at S groups, each
cluster size up to the keyframe's chunks) at each shape of
`chip_smoke.A_SHAPES` they take, each held bit for bit against A, beside
A: the basis of `cuda_assoc.MULTI_MIN_CTAS`.
`--mode d-sweep` times this tree's D1 and D2 at each keyframe-group count
of `D_SWEEP_GROUPS` up to S at every shape of `chip_smoke.C_SHAPES`, each
held bit for bit against C, beside C: the basis of
`cuda_assoc.WALK_MIN_CTAS`.
`--mode e-sweep` times this tree's C and E at every cluster size they take
(0, the first form, where a CTA of the first form holds every tile; 1, 2,
4 and 8 up to the target tiles and within `SPLIT_MAX_TILES` tiles a CTA)
at every shape of `chip_smoke.C_SHAPES`, each held bit for bit against
the twin: whether C's rule, `cuda_assoc.sparse_split`, also serves E.
`--mode by-kernel` traces this tree's wrappers
with `torch.profiler` and prints the device time of each `__global__`
function behind them (kernel G is two: fill and sum).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(root):
    """This tree's `chip_smoke` over the port package of the tree at
    `root`."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def _call_ms(fn, n: int) -> float:
    """Mean ms per call of fn() over n back-to-back calls: the slower of
    the host launching them and the card running them."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _lm_inputs(cs, dev, shape, b=None):
    import numpy as np
    return cs.lm_inputs(np.random.default_rng(1), dev, *shape,
                        b=b or cs.BATCH)[:3]


def _g_inputs(cs, dev):
    """Kernel G's inputs on the slice's first frames: (frames, B=8 inputs,
    lane 0 alone)."""
    from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
    images, _ = synthetic.make_sequence(
        cfg=cs.slice_config(), **{**cs.SEQUENCE, "n_frames": cs.BATCH})
    inputs, one = cs.moment_inputs(images, dev)
    return images, inputs, one[0]


# kernel C's __global__ functions: the split kernel (C's instance of the
# template; in trees before E shared it, the plain function) and the
# one-block form
C_FUNCTIONS = ("nn_min_sparse_split_kernelILb0EE",
               "nn_min_sparse_split_kernel", "nn_min_sparse_kernel")
# kernel A's: the split kernel and, in trees before it, the first form
A_FUNCTIONS = ("nn_min_dense_kernel", "nn_min_kernel")
# kernels D1's and D2's (D2 at M = 1024): the walk kernel and, in trees
# before it, the first form; and their wrappers
D_FUNCTIONS = {"D1": ("nn_min_sparse_walk_kernelILi0EE",
                      "nn_min_sparse_multi_kernelILi0EE"),
               "D2": ("nn_min_sparse_walk_kernelILi2EE",
                      "nn_min_sparse_multi_kernelILi2EE")}
D_WRAPPERS = {"D1": "nn_min_sparse_multi", "D2": "nn_min_sparse_unrolled"}
# kernels B1's and B2's (B2 at S = 4): the dense walk and, in trees before
# it, the first form; and their wrappers
B_FUNCTIONS = {"B1": ("nn_min_dense_walk_kernelILi0EE",
                      "nn_min_multi_kernelILi0EE"),
               "B2": ("nn_min_dense_walk_kernelILi4EE",
                      "nn_min_multi_kernelILi4EE")}
B_WRAPPERS = {"B1": "nn_min_multi", "B2": "nn_min_multi_unrolled"}
# kernel E's: the split kernel's E instance and the first form, which
# runs at split 0 (and is all of E in trees before the split kernel took it)
E_FUNCTIONS = ("nn_min_sparse_split_kernelILb1EE", "nn_min_sparse_attrs_kernel")
# keyframe-group counts `--mode d-sweep` tries (those up to S)
D_SWEEP_GROUPS = (1, 2, 4, 5, 8, 10, 13, 17, 25, 50)


def _sass(cs, lib_path, functions) -> dict | None:
    """The inner loop of the first of `functions` the library has."""
    for function in functions:
        sass = cs.sass_loop(lib_path, function)
        if sass:
            sass["function"] = function
            print(f"{function} inner loop (cuobjdump -sass): "
                  f"{sass['instructions']} instructions, {sass['fmul']} FMUL, "
                  f"{sass['fmnmx']} FMNMX: {sass['slots_per_distance']:.3f} "
                  "issue slots a distance")
            return sass
    return None


def _c_block(cs, dev, lib_path) -> dict:
    """Kernel C at every shape of `chip_smoke.C_SHAPES`: the device records
    of `phase_c_shapes` (checks included), back-to-back calls, and, where
    the split kernel runs, the issue-slot floor from its SASS."""
    import torch
    from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc
    sass = _sass(cs, lib_path, C_FUNCTIONS[:2])
    lanes_hz = (torch.cuda.get_device_properties(dev).multi_processor_count
                * 128 * cs.max_sm_hz())
    split = getattr(cuda_assoc, "sparse_split", None)
    recs = cs.phase_c_shapes(dev, cs._card())
    for shape in cs.C_SHAPES:
        rec = recs[cs.shape_key(*shape)]
        args = cs.c_inputs(dev, *shape)
        rec["call_ms"] = _call_ms(lambda: cuda_assoc.nn_min_sparse(*args), 100)
        rec["split"] = split(*shape) if split else None
        if sass and rec["split"]:
            b, s, m_src, m = shape
            rec["floor_ms"] = (b * s * m_src * m * rec["live_pairs"]
                               * sass["slots_per_distance"] / lanes_hz * 1e3)
    return {"shapes": recs, "sass": sass}


def _a_block(cs, dev, lib_path) -> dict:
    """Kernel A at every timed shape of `chip_smoke.A_SHAPES`: the device
    records of `phase_a_shapes` (checks included), back-to-back calls, and
    the issue-slot floor from the SASS of whichever form the tree has (the
    first form's loop holds a branch, so its block may be only a part of
    the loop)."""
    import torch
    from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc
    sass = _sass(cs, lib_path, A_FUNCTIONS)
    lanes_hz = (torch.cuda.get_device_properties(dev).multi_processor_count
                * 128 * cs.max_sm_hz())
    split = getattr(cuda_assoc, "dense_split", None)
    recs = cs.phase_a_shapes(dev, cs._card())
    for shape in cs.A_SHAPES:
        if shape == cs.A_RAGGED:
            continue
        rec = recs[cs.shape_key(*shape)]
        args = cs.a_inputs(dev, *shape)
        rec["call_ms"] = _call_ms(lambda: cuda_assoc.nn_min(*args), 100)
        rec["split"] = split(*shape) if split else None
        if sass:
            b, s, m_src, m = shape
            rec["floor_ms"] = (b * s * m_src * m * sass["slots_per_distance"]
                               / lanes_hz * 1e3)
    return {"shapes": recs, "sass": sass}


def _b_block(cs, dev, lib_path) -> dict:
    """Kernels B1 and B2 at every shape of `chip_smoke.A_SHAPES` they take,
    the counterpart of `_d_block`: each bit for bit against kernel A and its
    twin (a difference fails the run), on the device
    (`chip_smoke._cuda_ms`) and back to back, with the keyframe groups and
    cluster size where the tree picks them and the issue-slot floor of
    whichever form's loop the tree has (the first form's loop holds a
    branch, so its block may be only a part of the loop)."""
    import torch
    from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc
    sass = {k: _sass(cs, lib_path, f) for k, f in B_FUNCTIONS.items()}
    lanes_hz = (torch.cuda.get_device_properties(dev).multi_processor_count
                * 128 * cs.max_sm_hz())
    split = getattr(cuda_assoc, "multi_split", None)
    recs = {}
    for shape in cs.b_shapes():
        args = cs.a_inputs(dev, *shape)
        key = cs.shape_key(*shape)
        want = cuda_assoc.nn_min(*args)
        plain = cuda_assoc.nn_min_plain(*args)
        torch.cuda.synchronize()
        if not all(map(torch.equal, want, plain)):
            raise AssertionError(f"kernel A at {key} differs from its twin")
        rec = recs[key] = {
            "split": split(*shape) if split else None,
            "a_ms": cs._cuda_ms(lambda: cuda_assoc.nn_min(*args), 100)}
        for k, wrapper in B_WRAPPERS.items():
            fn = getattr(cuda_assoc, wrapper)
            got = fn(*args)
            torch.cuda.synchronize()
            if not all(map(torch.equal, got, want)):
                raise AssertionError(f"kernel {k} at {key} differs from A")
            r = rec[k] = {"ms": cs._cuda_ms(lambda: fn(*args), 100),
                          "call_ms": _call_ms(lambda: fn(*args), 100)}
            if sass[k]:
                b, s, m_src, m = shape
                r["floor_ms"] = (b * s * m_src * m
                                 * sass[k]["slots_per_distance"] / lanes_hz
                                 * 1e3)
    return {"shapes": recs, "sass": sass}


def _e_inputs(cs, dev, shape):
    """Kernel C's inputs at `shape` and 8 random attribute rows (D_pad 8),
    in E's argument order."""
    import torch
    args = cs.c_inputs(dev, *shape)
    b, s, _, m = shape
    gen = torch.Generator(device="cpu").manual_seed(5)
    attrs_t = torch.rand((b, s, 8, m), generator=gen).to(dev)
    return (*args[:5], attrs_t, args[5])


def _e_block(cs, dev, lib_path) -> dict:
    """Kernel E at every shape of `chip_smoke.C_SHAPES`: g bit for bit
    against its twin and (nn, d2) against kernel C's, on the device and
    back to back, with the cluster size and, where the tree runs the split
    kernel's E instance, the issue-slot floor of its loop at the executed
    share of tile pairs."""
    import torch
    from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc
    sass = _sass(cs, lib_path, E_FUNCTIONS)
    split_form = bool(sass) and sass["function"] == E_FUNCTIONS[0]
    lanes_hz = (torch.cuda.get_device_properties(dev).multi_processor_count
                * 128 * cs.max_sm_hz())
    recs = {}
    for shape in cs.C_SHAPES:
        args = _e_inputs(cs, dev, shape)
        key = cs.shape_key(*shape)
        got = cuda_assoc.nn_min_sparse_attrs(*args)
        want = cuda_assoc.nn_min_sparse_attrs_plain(*args)
        c_out = cuda_assoc.nn_min_sparse(*args[:5], args[6])
        live = float(cuda_assoc.pair_live(args[1], args[3], args[6])
                     .float().mean())
        torch.cuda.synchronize()
        if not all(map(torch.equal, got, want)):
            raise AssertionError(f"kernel E at {key} differs from its twin")
        if not all(map(torch.equal, got[:2], c_out)):
            raise AssertionError(f"kernel E at {key} differs from C")
        fn = cuda_assoc.nn_min_sparse_attrs
        split = cuda_assoc.sparse_split(*shape) if split_form else 0
        r = recs[key] = {"ms": cs._cuda_ms(lambda: fn(*args), 100),
                         "call_ms": _call_ms(lambda: fn(*args), 100),
                         "split": split, "live_pairs": live}
        if split:
            b, s, m_src, m = shape
            r["floor_ms"] = (b * s * m_src * m * live
                             * sass["slots_per_distance"] / lanes_hz * 1e3)
    return {"shapes": recs, "sass": sass}


def _d_block(cs, dev, lib_path) -> dict:
    """Kernels D1 and D2 at every shape of `chip_smoke.C_SHAPES`, the
    counterpart of `_c_block`: each bit for bit against kernel C and its
    twin (a difference fails the run), on the device (`chip_smoke._cuda_ms`)
    and back to back, with the keyframe groups where the tree picks them
    and the issue-slot floor of whichever form's loop the tree has (the
    first form's loop holds a branch, so its block may be only a part of
    the loop)."""
    import torch
    from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc
    sass = {k: _sass(cs, lib_path, f) for k, f in D_FUNCTIONS.items()}
    lanes_hz = (torch.cuda.get_device_properties(dev).multi_processor_count
                * 128 * cs.max_sm_hz())
    groups = getattr(cuda_assoc, "walk_groups", None)
    recs = {}
    for shape in cs.C_SHAPES:
        args = cs.c_inputs(dev, *shape)
        key = cs.shape_key(*shape)
        want = cuda_assoc.nn_min_sparse(*args)
        plain = cuda_assoc.nn_min_sparse_plain(*args)
        live = float(cuda_assoc.pair_live(args[1], args[3], args[5])
                     .float().mean())
        torch.cuda.synchronize()
        if not all(map(torch.equal, want, plain)):
            raise AssertionError(f"kernel C at {key} differs from its twin")
        rec = recs[key] = {"live_pairs": live,
                           "groups": groups(*shape) if groups else None}
        for k, wrapper in D_WRAPPERS.items():
            fn = getattr(cuda_assoc, wrapper)
            got = fn(*args)
            torch.cuda.synchronize()
            if not all(map(torch.equal, got, want)):
                raise AssertionError(f"kernel {k} at {key} differs from C")
            r = rec[k] = {"ms": cs._cuda_ms(lambda: fn(*args), 100),
                          "call_ms": _call_ms(lambda: fn(*args), 100)}
            if sass[k]:
                b, s, m_src, m = shape
                r["floor_ms"] = (b * s * m_src * m * live
                                 * sass[k]["slots_per_distance"] / lanes_hz
                                 * 1e3)
    return {"shapes": recs, "sass": sass}


def _s_block(cs, dev):
    """The segment sums of `chip_smoke.SEGMENT_SUM_SHAPES`: deterministic
    `index_add_` into n + 1 rows cut to n (the tree's
    `cuda_segment_sum.segment_sum_plain`, or its `features.segment_sum`
    into n + 1 rows where it has no kernel), and the tree's kernel where it
    has one, bit for bit against it."""
    import torch
    from cfear_radarodometry_code_public_tpu_torch.ops import features
    wrapper = "cfear_radarodometry_code_public_tpu_torch.ops.cuda_segment_sum"
    css = (importlib.import_module(wrapper)
           if importlib.util.find_spec(wrapper) else None)
    recs = {}
    for name in cs.SEGMENT_SUM_SHAPES:
        data, ids, n = cs.segment_sum_inputs(dev, name)
        if css is not None:
            def index_add():
                return css.segment_sum_plain(data, ids, n)
        else:
            def index_add():
                return features.segment_sum(data, ids, n + 1)[:n]
        rec = recs[name] = {"index_add_ms": cs._cuda_ms(index_add, 5,
                                                        "index_add_")}
        if css is not None:
            def kernel():
                return css.segment_sum(data, ids, n)
            if not torch.equal(kernel(), index_add()):
                raise AssertionError(f"segment sum {name}: the kernel "
                                     "differs from index_add_")
            rec.update(ms=cs._cuda_ms(kernel, 50), call_ms=_call_ms(kernel, 50))
    return recs


def worker(root) -> int:
    """Time one tree; the last line of stdout is its JSON record."""
    import torch
    cs = _load(root)
    from cfear_radarodometry_code_public_tpu_torch.ops import (
        _build, cuda_features, cuda_lm)
    dev = torch.device("cuda", 0)
    card = cs._card()
    _build.library()
    # ptxas's registers and shared memory of the kernels' entry points
    entry = None
    for line in _build.build_info["report"].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and entry and any(
                k in entry for k in ("lm_solve", "moment") + C_FUNCTIONS
                + A_FUNCTIONS + D_FUNCTIONS["D1"][:1] + B_FUNCTIONS["B1"][:1]
                + B_FUNCTIONS["B2"][:1] + E_FUNCTIONS):
            print(f"{entry}: {line.split(':', 1)[1].strip()}")
    f = cs.phase_lm(dev, card)["lm_solve_fused"]
    images, inputs, one = _g_inputs(cs, dev)
    g = cs.phase_moments(images, dev, card)["moment_accumulate"]

    rec = {"root": os.path.relpath(root, HERE), "card": card, "F": {},
           "host_paced": cs.host_paced}
    for shape in cs.LM_SHAPES:
        cfg, packed, pose0 = _lm_inputs(cs, dev, shape)
        n = cs.lm_shape_key(*shape)
        rec["F"][n] = {
            "call_ms": _call_ms(
                lambda: cuda_lm.lm_solve_fused(packed, pose0, cfg), 100),
            "ee_ms": f["ms_by_n"][n], "masked_ms": f["masked_ms_by_n"][n],
            "b1_ms": f["b1_ms_by_n"][n]}
    lanes, shapes = cs.LM_FLEET
    for b in lanes:
        for shape in shapes:
            cfg, packed, pose0 = _lm_inputs(cs, dev, shape, b)
            n = f"B={b} N={shape[0] * shape[1]} {shape[2]}/{shape[3]}"
            rec["F"][n] = {
                "call_ms": _call_ms(
                    lambda: cuda_lm.lm_solve_fused(packed, pose0, cfg), 100),
                **{k: f["fleet"][n][m] for k, m in (
                    ("ee_ms", "ms"), ("masked_ms", "masked_ms"),
                    ("b1_ms", "b1_ms"))}}
    rec["G"] = {
        "call_ms": _call_ms(
            lambda: cuda_features.moment_accumulate(*inputs), 100),
        "b8_ms": g["ms"], "b1_ms": g["b1_ms"],
        # the smoke's yardstick: float atomics over ready columns
        "index_add_ms": g["library_ms"]}
    rec["C"] = _c_block(cs, dev, _build.library()._name)
    rec["A"] = _a_block(cs, dev, _build.library()._name)
    rec["B"] = _b_block(cs, dev, _build.library()._name)
    rec["D"] = _d_block(cs, dev, _build.library()._name)
    rec["E"] = _e_block(cs, dev, _build.library()._name)
    rec["S"] = _s_block(cs, dev)
    print(json.dumps(rec))
    return 0


def sweep(out_dir) -> int:
    import torch
    cs = _load(HERE)
    from cfear_radarodometry_code_public_tpu_torch.ops import cuda_lm
    dev = torch.device("cuda", 0)
    print(cs._card())
    out = {}
    for s, m, cost, loss in ((1, 1024, "P2P", "Huber"),) + cs.LM_SHAPES:
        cfg, packed, pose0 = _lm_inputs(cs, dev, (s, m, cost, loss))
        want = cuda_lm.lm_solve_fused(packed, pose0, cfg)
        for b in (1, cs.BATCH):
            row = {}
            for c in (1, 2, 4, 8, 16):
                def run():
                    return cuda_lm._launch(packed[:b], pose0[:b], cfg,
                                           cluster=c)
                try:
                    got = run()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    row[c] = str(e)[-40:]
                    continue
                close = bool((got[0] - want[0][:b]).abs().max()
                             <= cs.LM_POSE_TOL)
                row[c] = (round(cs._cuda_ms(run, 50), 5), close)
            out[f"N={s * m} B={b}"] = row
            print(f"N={s * m} B={b}: (ms, within tolerance of the chosen "
                  f"size) by cluster size {row}", flush=True)
    if out_dir:
        with open(os.path.join(out_dir, "sweep_torch_lm_clusters.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
    return 0


def a_sweep(out_dir) -> int:
    import torch
    cs = _load(HERE)
    from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc
    dev = torch.device("cuda", 0)
    print(cs._card())
    pick = cuda_assoc.dense_split
    out = {}
    for shape in cs.A_SHAPES:
        if shape == cs.A_RAGGED:
            continue
        args = cs.a_inputs(dev, *shape)
        want = cuda_assoc.nn_min(*args)
        row = {}
        for c in (1, 2, 4, 8):
            if c > 1 and c > -(-shape[3] // cuda_assoc.DENSE_CHUNK):
                continue
            cuda_assoc.dense_split = lambda *_, c=c: c
            try:
                got = cuda_assoc.nn_min(*args)
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                row[c] = (round(cs._cuda_ms(
                    lambda: cuda_assoc.nn_min(*args), 100), 5), same)
            finally:
                cuda_assoc.dense_split = pick
        key = cs.shape_key(*shape)
        out[key] = {"picked": pick(*shape), "by_split": row}
        print(f"{key}: picked {pick(*shape)}; (ms, bit-equal to the picked "
              f"size) by cluster size {row}", flush=True)
    if out_dir:
        with open(os.path.join(out_dir, "sweep_torch_a_clusters.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
    return 0


def b_sweep(out_dir) -> int:
    import torch
    cs = _load(HERE)
    from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc
    dev = torch.device("cuda", 0)
    print(cs._card())
    pick = cuda_assoc.multi_split
    out = {}
    # and the long-run window's reverse problem at B=8, which `longrun-window`
    # times and A_SHAPES lacks
    for shape in cs.b_shapes() + [(cs.BATCH, 1, 2048, 2048)]:
        args = cs.a_inputs(dev, *shape)
        want = cuda_assoc.nn_min(*args)
        key = cs.shape_key(*shape)
        s, chunks = shape[1], -(-shape[3] // cuda_assoc.DENSE_CHUNK)
        tries = ([(g, 1) for g in (1, 2, 4) if g <= s]
                 + [(s, c) for c in (2, 4, 8) if c <= chunks])
        out[key] = {"picked": list(pick(*shape)),
                    "a_ms": round(cs._cuda_ms(
                        lambda: cuda_assoc.nn_min(*args), 100), 5)}
        for k, wrapper in B_WRAPPERS.items():
            fn = getattr(cuda_assoc, wrapper)
            row = {}
            for g, c in tries:
                cuda_assoc.multi_split = lambda *_, g=g, c=c: (g, c)
                try:
                    got = fn(*args)
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    row[f"{g}x{c}"] = (round(cs._cuda_ms(
                        lambda: fn(*args), 100), 5), same)
                finally:
                    cuda_assoc.multi_split = pick
            out[key][k] = row
        print(f"{key}: picked {out[key]['picked']}, A {out[key]['a_ms']} "
              "ms; (ms, bit-equal to A) by groups x cluster: "
              + "; ".join(f"{k} {out[key][k]}" for k in B_WRAPPERS),
              flush=True)
    if out_dir:
        with open(os.path.join(out_dir, "sweep_torch_b_splits.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
    return 0


def d_sweep(out_dir) -> int:
    import torch
    cs = _load(HERE)
    from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc
    dev = torch.device("cuda", 0)
    print(cs._card())
    pick = cuda_assoc.walk_groups
    out = {}
    for shape in cs.C_SHAPES:
        args = cs.c_inputs(dev, *shape)
        want = cuda_assoc.nn_min_sparse(*args)
        key = cs.shape_key(*shape)
        out[key] = {"picked": pick(*shape),
                    "c_ms": round(cs._cuda_ms(
                        lambda: cuda_assoc.nn_min_sparse(*args), 100), 5)}
        for k, wrapper in D_WRAPPERS.items():
            fn = getattr(cuda_assoc, wrapper)
            row = {}
            for g in D_SWEEP_GROUPS:
                if g > shape[1]:
                    continue
                cuda_assoc.walk_groups = lambda *_, g=g: g
                try:
                    got = fn(*args)
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    row[g] = (round(cs._cuda_ms(lambda: fn(*args), 100), 5),
                              same)
                finally:
                    cuda_assoc.walk_groups = pick
            out[key][k] = row
        print(f"{key}: picked {out[key]['picked']}, C {out[key]['c_ms']} "
              "ms; (ms, bit-equal to C) by keyframe groups: "
              + "; ".join(f"{k} {out[key][k]}" for k in D_WRAPPERS),
              flush=True)
    if out_dir:
        with open(os.path.join(out_dir, "sweep_torch_d_groups.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
    return 0


def e_sweep(out_dir) -> int:
    import torch
    cs = _load(HERE)
    from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc
    dev = torch.device("cuda", 0)
    print(cs._card())
    pick = cuda_assoc.sparse_split
    out = {}
    for shape in cs.C_SHAPES:
        args = _e_inputs(cs, dev, shape)
        c_args = (*args[:5], args[6])
        want = cuda_assoc.nn_min_sparse_attrs_plain(*args)
        key = cs.shape_key(*shape)
        nt = shape[3] // cuda_assoc.TT_SPARSE
        tries = [c for c in (0, 1, 2, 4, 8)
                 if c == 0 or ((c == 1 or c <= nt)
                               and -(-nt // c) <= cuda_assoc.SPLIT_MAX_TILES)]
        out[key] = {"picked": pick(*shape), "C": {}, "E": {}}
        for c in tries:
            cuda_assoc.sparse_split = lambda *_, c=c: c
            try:
                got = cuda_assoc.nn_min_sparse_attrs(*args)
                c_got = cuda_assoc.nn_min_sparse(*c_args)
                same = (all(map(torch.equal, got, want))
                        and all(map(torch.equal, c_got, want[:2])))
                out[key]["E"][c] = (round(cs._cuda_ms(
                    lambda: cuda_assoc.nn_min_sparse_attrs(*args), 100), 5),
                    same)
                out[key]["C"][c] = round(cs._cuda_ms(
                    lambda: cuda_assoc.nn_min_sparse(*c_args), 100), 5)
            finally:
                cuda_assoc.sparse_split = pick
        print(f"{key}: picked {out[key]['picked']}; E (ms, bit-equal to the "
              f"twin and C) by cluster size {out[key]['E']}; C ms "
              f"{out[key]['C']}", flush=True)
    if out_dir:
        with open(os.path.join(out_dir, "sweep_torch_e_splits.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
    return 0


def by_kernel() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    cs = _load(HERE)
    from cfear_radarodometry_code_public_tpu_torch.ops import (cuda_features,
                                                                cuda_lm)
    dev = torch.device("cuda", 0)
    print(cs._card())

    def trace(name, fn, n=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_time_total > 0 and ("moment" in e.key
                                            or "lm_solve" in e.key):
                kernel = e.key.replace("(anonymous namespace)::", "")
                print(f"{name}: {kernel.split('(')[0].split()[-1]} "
                      f"{e.device_time_total / e.count:.2f} us x "
                      f"{e.count / n:g} a call")

    _, inputs, one = _g_inputs(cs, dev)
    trace("G B=8", lambda: cuda_features.moment_accumulate(*inputs))
    trace("G B=1", lambda: cuda_features.moment_accumulate(*one))
    for s, m, cost, loss in cs.LM_SHAPES:
        cfg, packed, pose0 = _lm_inputs(cs, dev, (s, m, cost, loss))
        trace(f"F N={s * m} B=8",
              lambda: cuda_lm.lm_solve_fused(packed, pose0, cfg))
    return 0


class _Tee:
    """stdout, and a copy appended to a log file (for callers that keep
    only the end of a long output)."""

    def __init__(self, path):
        self.out, self.log = sys.stdout, open(path, "a")

    def write(self, text):
        self.out.write(text)
        self.log.write(text)

    def flush(self):
        self.out.flush()
        self.log.flush()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="source trees, in running order")
    ap.add_argument("--mode", choices=("compare", "sweep", "a-sweep",
                                       "b-sweep", "d-sweep", "e-sweep",
                                       "by-kernel"),
                    default="compare")
    ap.add_argument("--out", metavar="DIR", help="also write the records "
                    "and a log of the output there")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        sys.stdout = _Tee(os.path.join(args.out, "compare_torch_kernels.log"))
    if args.mode == "sweep":
        return sweep(args.out)
    if args.mode == "a-sweep":
        return a_sweep(args.out)
    if args.mode == "b-sweep":
        return b_sweep(args.out)
    if args.mode == "d-sweep":
        return d_sweep(args.out)
    if args.mode == "e-sweep":
        return e_sweep(args.out)
    if args.mode == "by-kernel":
        return by_kernel()
    if not args.roots:
        ap.error("name at least one source tree")
    recs = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.abspath(root)],
            cwd=os.path.abspath(root), capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        recs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(recs[0]["card"])
    print("kernel F, ms (back-to-back calls B=8 | on the device: early exit "
          "B=8 / masked B=8 / early exit B=1; the fleet's shapes at their "
          "own B):")
    for n in recs[0]["F"]:
        print(f"  {n if n.startswith('B=') else f'N={n}'}: " + "; ".join(
            f"{r['root']} {r['F'][n]['call_ms']:.4f} | "
            f"{r['F'][n]['ee_ms']:.4f} / {r['F'][n]['masked_ms']:.4f} / "
            f"{r['F'][n]['b1_ms']:.4f}" for r in recs))
    print("kernel G, ms (back-to-back calls B=8 | on the device: B=8 / B=1 / "
          "index_add_ B=8): " + "; ".join(
              f"{r['root']} {r['G']['call_ms']:.4f} | {r['G']['b8_ms']:.4f} / "
              f"{r['G']['b1_ms']:.4f} / {r['G']['index_add_ms']:.4f}"
              for r in recs))
    print("kernel C, ms (back-to-back calls | on the device | bound / "
          "issue-slot floor / cdist + min; split):")
    for key, rec in recs[0]["C"]["shapes"].items():
        print(f"  {key}, executed tile pairs {rec['live_pairs']:.4f}: "
              + "; ".join(
                  f"{r['root']} {c['call_ms']:.4f} | {c['ms']:.4f} | "
                  f"{c['bound_ms']:.4f} / "
                  + (f"{c['floor_ms']:.4f}" if "floor_ms" in c else "-")
                  + f" / {c['library_ms']:.4f}; {c.get('split')}"
                  for r in recs for c in (r["C"]["shapes"][key],)))
    print("kernel A, ms (back-to-back calls | on the device | bound / "
          "issue-slot floor / cdist + min; split):")
    for key, rec in recs[0]["A"]["shapes"].items():
        if "ms" not in rec:
            continue
        print(f"  {key}: " + "; ".join(
            f"{r['root']} {a['call_ms']:.4f} | {a['ms']:.4f} | "
            f"{a['bound_ms']:.4f} / "
            + (f"{a['floor_ms']:.4f}" if "floor_ms" in a else "-")
            + f" / {a['library_ms']:.4f}; {a.get('split')}"
            for r in recs for a in (r["A"]["shapes"][key],)))
    print("kernels D1 / D2, ms (back-to-back calls | on the device | "
          "issue-slot floor; keyframe groups):")
    for key, rec in recs[0]["D"]["shapes"].items():
        print(f"  {key}, executed tile pairs {rec['live_pairs']:.4f}: "
              + "; ".join(
                  f"{r['root']} " + " / ".join(
                      f"{d[k]['call_ms']:.4f} | {d[k]['ms']:.4f} | "
                      + (f"{d[k]['floor_ms']:.4f}" if "floor_ms" in d[k]
                         else "-") for k in D_WRAPPERS)
                  + f"; {d['groups']}"
                  for r in recs for d in (r["D"]["shapes"][key],)))
    print("kernels B1 / B2, ms (back-to-back calls | on the device | "
          "issue-slot floor; A on the device; groups, cluster):")
    for key in recs[0]["B"]["shapes"]:
        print(f"  {key}: " + "; ".join(
            f"{r['root']} " + " / ".join(
                f"{b[k]['call_ms']:.4f} | {b[k]['ms']:.4f} | "
                + (f"{b[k]['floor_ms']:.4f}" if "floor_ms" in b[k] else "-")
                for k in B_WRAPPERS)
            + f"; A {b['a_ms']:.4f}; {b['split']}"
            for r in recs for b in (r["B"]["shapes"][key],)))
    print("kernel E, ms (back-to-back calls | on the device | issue-slot "
          "floor; split):")
    for key in recs[0]["E"]["shapes"]:
        print(f"  {key}: " + "; ".join(
            f"{r['root']} {e['call_ms']:.4f} | {e['ms']:.4f} | "
            + (f"{e['floor_ms']:.4f}" if "floor_ms" in e else "-")
            + f"; {e.get('split')}"
            for r in recs for e in (r["E"]["shapes"][key],)))
    print("segment sum at the cells' shapes, ms (back-to-back calls | on "
          "the device | deterministic index_add_ on the device):")
    for key in recs[0]["S"]:
        print(f"  {key}: " + "; ".join(
            f"{r['root']} " + (f"{s['call_ms']:.4f} | {s['ms']:.4f}"
                               if "ms" in s else "- | -")
            + f" | {s['index_add_ms']:.4f}"
            for r in recs for s in (r["S"][key],)))
    if args.out:
        with open(os.path.join(args.out, "compare_torch_kernels.json"),
                  "w") as f:
            json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
