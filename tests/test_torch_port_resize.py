"""The port's bilinear resize against mrisr_tpu's ``jax.image.resize``
(CPU): ``resize_bilinear`` and ``resize_bilinear_nhwc``, antialias off and
on, down and up, square and not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.ops import resize as jresize
from mrisr_tpu_torch.ops import resize as presize
from torch_port_util import noise

torch.set_num_threads(2)

ATOL = 1e-5  # float32; half-pixel bilinear weights, summed in another order

# (H, W) of a 40 x 36 input: halved, shrunk in one dim and grown in the
# other, grown (antialias must then change nothing), one pixel off
SIZES = [(20, 18), (15, 25), (24, 80), (64, 64), (41, 36), (40, 35)]


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("out_hw", SIZES)
def test_resize_bilinear_matches_jax(out_hw, antialias):
    x = noise((2, 3, 40, 36), 1)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), out_hw,
                                              antialias=antialias))
    got = presize.resize_bilinear(torch.from_numpy(x), out_hw,
                                  antialias=antialias)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("out_hw", [(20, 18), (24, 80)])
def test_resize_bilinear_nhwc_matches_jax(out_hw, antialias):
    x = noise((2, 40, 36, 3), 2)
    want = np.asarray(jresize.resize_bilinear_nhwc(jnp.asarray(x), out_hw,
                                                   antialias=antialias))
    got = presize.resize_bilinear_nhwc(torch.from_numpy(x), out_hw,
                                       antialias=antialias)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("fn, shape", [
    (presize.resize_bilinear, (2, 40, 36)),
    (presize.resize_bilinear_nhwc, (2, 40, 36, 3))])
def test_resize_identity_and_default(fn, shape):
    """The same tensor back at its own size; antialias off by default (the
    data path's numbers)."""
    x = torch.from_numpy(noise(shape, 3))
    assert fn(x, (40, 36)) is x
    assert torch.equal(fn(x, (20, 18)), fn(x, (20, 18), antialias=False))
