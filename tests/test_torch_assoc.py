"""Association kernels A (`nn_min`) and C (`nn_min_sparse`): the port's
plain twins against the reference's Pallas kernels in interpret mode, on the
cases of tests/test_registration.py plus a tie case. The CUDA kernels
against the twins: tests/test_torch_cuda.py.

Tolerance: nearest-neighbour indices are compared exactly. d2 is compared
bit for bit with the unfused f32 arithmetic (each of -, *, + rounded, the
TPU kernel's and the CUDA kernel's form), and to within 1 ulp of the
interpret-mode result: XLA's CPU backend contracts dx*dx + dy*dy into
fma(dx, dx, dy*dy), one rounding fewer."""

import numpy as np
import pytest
import torch

from torch_port_helpers import jnp

from cfear_radarodometry_code_public_tpu.ops import pallas_assoc as pa
from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc as ca


def _dense_case(seed=3, s=3, m=512):
    """tests/test_registration.py:test_nn_kernel_variants_match's case:
    an exact duplicate target (a tie) and an empty keyframe."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(m, 2)).astype(np.float32) * 40
    tar = rng.normal(size=(s, m, 2)).astype(np.float32) * 40
    tar[1, 10] = tar[1, 20]
    src[5] = tar[1, 10]
    valid = rng.random((s, m)) < 0.8
    valid[2] = False
    return src, tar, valid


def _sparse_case(seed=1, s=4, m=1024, msrc=512):
    """tests/test_registration.py:test_sparse_assoc_kernel_matches_dense's
    case (spatially ordered points, an empty keyframe) plus a tie: two
    identical targets in different target tiles."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(msrc, 2)).astype(np.float32) * 60
    src = src[np.argsort(src[:, 0], kind="stable")]
    tar = rng.normal(size=(s, m, 2)).astype(np.float32) * 60
    for k in range(s):
        tar[k] = tar[k][np.argsort(tar[k][:, 0], kind="stable")]
    valid = rng.random((s, m)) < 0.8
    valid[2] = False
    valid[0, [300, 700]] = True
    tar[0, 700] = tar[0, 300]
    src[200] = tar[0, 300] + np.float32([0.25, 0.0])
    return src, tar, valid


def _t(*arrays):
    return [torch.as_tensor(np.array(a))[None] for a in arrays]


def _assert_d2(d2_port, d2_ref, nn, src, tar):
    """d2_port is the unfused f32 distance to target nn, bit for bit, and
    within 1 ulp of the reference's d2."""
    t = np.take_along_axis(tar, nn[..., None].astype(np.int64), axis=1)
    dx, dy = src[None, :, 0] - t[..., 0], src[None, :, 1] - t[..., 1]
    unfused = dx * dx + dy * dy
    fin = np.isfinite(d2_ref)
    np.testing.assert_array_equal(d2_port[fin], unfused[fin])
    np.testing.assert_array_equal(np.isfinite(d2_port), fin)
    np.testing.assert_array_max_ulp(d2_port[fin], d2_ref[fin], maxulp=1)


def test_nn_min_plain_matches_pallas():
    src, tar, valid = _dense_case()
    nn_r, d2_r = pa.nn_min(jnp.asarray(src), jnp.asarray(tar),
                           jnp.asarray(valid), interpret=True, ts=256)
    nn_t, d2_t = ca.nn_min(*_t(src, tar, valid))
    np.testing.assert_array_equal(nn_t[0].numpy(), np.asarray(nn_r))
    _assert_d2(d2_t[0].numpy(), np.asarray(d2_r), np.asarray(nn_r), src, tar)
    assert nn_t[0, 1, 5] == 10                     # lowest index wins the tie
    assert np.isinf(d2_t[0, 2].numpy()).all() and (nn_t[0, 2] == 0).all()


@pytest.mark.parametrize("radius", [2.0, 5.0])
def test_nn_min_sparse_plain_matches_pallas(radius):
    src, tar, valid = _sparse_case()
    jsrc, jtar, jvalid = map(jnp.asarray, (src, tar, valid))
    sb = pa.tile_bounds(jsrc, jnp.ones(len(src), bool), 256)
    tb = pa.tile_bounds(jtar, jvalid, pa._TT_SPARSE)
    nn_r, d2_r = pa.nn_min_sparse(jsrc, sb, jtar, tb, jvalid, radius,
                                  interpret=True, ts=256)
    tsrc, ttar, tvalid = _t(src, tar, valid)
    sb_t = ca.tile_bounds(tsrc, torch.ones(1, len(src), dtype=torch.bool), 256)
    tb_t = ca.tile_bounds(ttar, tvalid, ca.TT_SPARSE)
    np.testing.assert_array_equal(sb_t[0].numpy(), np.asarray(sb))
    np.testing.assert_array_equal(tb_t[0].numpy(), np.asarray(tb))
    nn_t, d2_t = ca.nn_min_sparse(tsrc, sb_t, ttar, tb_t, tvalid,
                                  torch.tensor([radius]))
    np.testing.assert_array_equal(nn_t[0].numpy(), np.asarray(nn_r))
    _assert_d2(d2_t[0].numpy(), np.asarray(d2_r), np.asarray(nn_r), src, tar)
    # within the radius the sparse twin equals the dense twin
    nn_d, d2_d = ca.nn_min(tsrc, ttar, tvalid)
    within = d2_d[0] <= radius * radius
    assert within.any() and not within.all()
    assert torch.equal(nn_t[0][within], nn_d[0][within])
    assert torch.equal(d2_t[0][within], d2_d[0][within])
    assert (d2_t[0][~within] >= radius * radius).all()
    assert nn_t[0, 0, 200] == 300                 # tie across target tiles


def test_plain_twins_batch_over_lanes():
    """A (B=2) call equals the two single-lane calls."""
    src, tar, valid = _sparse_case()
    src2, tar2, valid2 = _sparse_case(seed=2)
    b_src, b_tar, b_valid = (torch.as_tensor(np.stack([a, c]))
                             for a, c in ((src, src2), (tar, tar2),
                                          (valid, valid2)))
    sb = ca.tile_bounds(b_src, torch.ones(2, len(src), dtype=torch.bool), 256)
    tb = ca.tile_bounds(b_tar, b_valid, ca.TT_SPARSE)
    radius = torch.tensor([4.0, 2.0])
    nn_b, d2_b = ca.nn_min_sparse(b_src, sb, b_tar, tb, b_valid, radius)
    nd_b, dd_b = ca.nn_min(b_src, b_tar, b_valid)
    for i in range(2):
        nn_1, d2_1 = ca.nn_min_sparse(b_src[i:i + 1], sb[i:i + 1],
                                      b_tar[i:i + 1], tb[i:i + 1],
                                      b_valid[i:i + 1], radius[i:i + 1])
        nd_1, dd_1 = ca.nn_min(b_src[i:i + 1], b_tar[i:i + 1],
                               b_valid[i:i + 1])
        assert torch.equal(nn_b[i], nn_1[0]) and torch.equal(d2_b[i], d2_1[0])
        assert torch.equal(nd_b[i], nd_1[0]) and torch.equal(dd_b[i], dd_1[0])


def test_wrappers_check_their_inputs():
    src, tar, valid = _t(*_dense_case())
    with pytest.raises(TypeError, match="float32"):
        ca.nn_min(src.double(), tar, valid)
    with pytest.raises(ValueError, match="contiguous"):
        ca.nn_min(src, tar.transpose(1, 2), valid)
    with pytest.raises(ValueError, match="must both be 0"):
        ca.nn_min_sparse(src[:, :500], torch.zeros(1, 1, 4), tar,
                         torch.zeros(1, 3, 1, 4), valid, torch.ones(1))
    assert ca.supported(1024) and not ca.supported(1000)
    assert ca.supported_sparse(1024, 1024) and not ca.supported_sparse(256, 768)


def test_cpu_calls_count_no_launches():
    ca.reset_launches()
    ca.nn_min(*_t(*_dense_case()))
    assert ca.launches == {"nn_min": 0, "nn_min_sparse": 0}
