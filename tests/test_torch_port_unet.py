"""Port UNet, weight carry and BN folding against mrisr_tpu (fp32, CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrisr_tpu.ckpt.fold_bn import fold_unet_batchnorm as jax_fold
from mrisr_tpu.models import UNet as JaxUNet
from mrisr_tpu_torch.ckpt import fold_unet_batchnorm
from mrisr_tpu_torch.models import UNet
from torch_port_util import jax_unet_variables, noise, port_unet

F = 4
HW = 32

torch.set_num_threads(2)


@pytest.mark.parametrize("use_bias,count", [(True, 31_042_945),
                                            (False, 31_037_057)])
def test_param_count(use_bias, count):
    model = UNet(features=64, use_bias=use_bias)
    assert sum(p.numel() for p in model.parameters()) == count


@pytest.mark.parametrize("use_bias", [True, False])
def test_from_jax_forward_parity(use_bias):
    v = jax_unet_variables(F, HW, seed=1, use_bias=use_bias)
    x = noise((2, HW, HW, 2), seed=2)
    want = np.asarray(JaxUNet(features=F, use_bias=use_bias).apply(
        v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port_unet(v, F, use_bias)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, HW, HW, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_folded_forward_parity():
    """Port fold of the carried weights == jax fold, and the folded port
    forward == UNet(use_bn=False).apply on the jax-folded tree."""
    v = jax_unet_variables(F, HW, seed=3)
    x = noise((2, HW, HW, 2), seed=4)
    folded_tree = jax_fold(v["params"], v["batch_stats"])
    want = np.asarray(JaxUNet(features=F, use_bn=False).apply(
        folded_tree, jnp.asarray(x), train=False))
    ported = fold_unet_batchnorm(port_unet(v, F))
    carried = port_unet(folded_tree, F)
    for (k, a), (k2, b) in zip(ported.state_dict().items(),
                               carried.state_dict().items()):
        assert k == k2
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    with torch.no_grad():
        got = ported(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_fold_rejects_folded():
    with pytest.raises(ValueError, match="BatchNorm"):
        fold_unet_batchnorm(UNet(features=F, use_bn=False))
