"""The port's CUDA kernels on a card, against their plain PyTorch twins.

Needs a CUDA card and nvcc; every test skips without a card. This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc as ca

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, b=8, s=4, m=1024, seed=0):
    """Slice-shaped inputs: targets near the sources, an empty keyframe,
    a tie between two identical targets in different 512-row tiles."""
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(b, m, 2)) * 50).astype(np.float32)
    src = np.take_along_axis(src, np.argsort(src[..., :1], 1, kind="stable"), 1)
    tar = src[:, None] + rng.normal(size=(b, s, m, 2)).astype(np.float32)
    valid = rng.random((b, s, m)) < 0.9
    valid[:, s - 1] = False
    if m > 700:
        tar[0, 0, 700] = tar[0, 0, 300]
        valid[0, 0, [300, 700]] = True
        src[0, 9] = tar[0, 0, 300]
    return [torch.as_tensor(a).to(dev) for a in (src, tar, valid)]


def test_kernel_a_bit_equal_to_plain(dev):
    src, tar, valid = _inputs(dev)
    ca.reset_launches()
    nn_k, d2_k = ca.nn_min(src, tar, valid)
    nn_p, d2_p = ca.nn_min_plain(src, tar, valid)
    torch.cuda.synchronize()
    assert torch.equal(nn_k, nn_p) and torch.equal(d2_k, d2_p)
    assert nn_k[0, 0, 9].item() == 300
    assert torch.isinf(d2_k[:, -1]).all() and (nn_k[:, -1] == 0).all()
    assert ca.launches == {"nn_min": 1, "nn_min_sparse": 0}


@pytest.mark.parametrize("radius", [2.0, 4.0])
def test_kernel_c_bit_equal_to_plain(dev, radius):
    src, tar, valid = _inputs(dev)
    sb = ca.tile_bounds(src, torch.ones_like(valid[:, 0]), ca.TS_SPARSE)
    tb = ca.tile_bounds(tar, valid, ca.TT_SPARSE)
    r = torch.full((src.shape[0],), radius, device=dev)
    ca.reset_launches()
    nn_k, d2_k = ca.nn_min_sparse(src, sb, tar, tb, valid, r)
    nn_p, d2_p = ca.nn_min_sparse_plain(src, sb, tar, tb, valid, r)
    nn_a, d2_a = ca.nn_min_plain(src, tar, valid)
    torch.cuda.synchronize()
    assert torch.equal(nn_k, nn_p) and torch.equal(d2_k, d2_p)
    within = d2_a <= radius * radius
    assert torch.equal(nn_k[within], nn_a[within])
    assert (d2_k[~within] >= radius * radius).all()
    assert ca.launches == {"nn_min": 0, "nn_min_sparse": 1}


def test_kernels_take_odd_sizes(dev):
    """Kernel A masks a ragged last block (Msrc % 128 != 0, M % 1024 != 0)."""
    src, tar, valid = _inputs(dev, b=3, s=2, m=1500)
    src = src[:, :1000].contiguous()
    nn_k, d2_k = ca.nn_min(src, tar, valid)
    nn_p, d2_p = ca.nn_min_plain(src, tar, valid)
    torch.cuda.synchronize()
    assert torch.equal(nn_k, nn_p) and torch.equal(d2_k, d2_p)


def test_wrappers_raise_instead_of_falling_back(dev):
    src, tar, valid = _inputs(dev, b=1, s=1, m=512)
    with pytest.raises(ValueError, match="is on"):
        ca.nn_min(src, tar.cpu(), valid)
    with pytest.raises(TypeError, match="float32"):
        ca.nn_min(src.half(), tar, valid)
