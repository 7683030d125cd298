"""Port paired augmentation against mrisr_tpu's (CPU): the port applies the
draws the JAX package made (recomputed here from the key, as
``paired_augment`` splits it), flips and rot90 exactly, the bilinear
rotation within 1e-5; and the port's own draws keep samples paired."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.ops.augment import paired_augment as jax_paired_augment
from mrisr_tpu_torch.ops.augment import apply_paired_augment, paired_augment
from torch_port_util import noise

torch.set_num_threads(2)


def jax_draws(key, b, hflip, vflip, rot90, rotate_degrees):
    """The draws ``mrisr_tpu.ops.augment.paired_augment`` makes under
    ``key``, as torch tensors (None for a disabled transform)."""
    k_h, k_v, k_r, k_a = jax.random.split(key, 4)

    def t(x):
        return torch.from_numpy(np.array(x))

    return (t(jax.random.bernoulli(k_h, 0.5, (b,))) if hflip else None,
            t(jax.random.bernoulli(k_v, 0.5, (b,))) if vflip else None,
            t(jax.random.randint(k_r, (b,), 0, 4)) if rot90 else None,
            t(jax.random.uniform(k_a, (b,), minval=-rotate_degrees,
                                 maxval=rotate_degrees) * (jnp.pi / 180.0))
            if rotate_degrees > 0 else None)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hflip,vflip,rot90", [
    (True, True, False), (True, False, True), (False, True, True),
    (True, True, True)])
def test_flips_and_rot90_equal_jax(seed, hflip, vflip, rot90):
    batch = noise((8, 16, 16, 3), seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_paired_augment(key, jnp.asarray(batch), hflip=hflip,
                                         vflip=vflip, rot90=rot90))
    got = apply_paired_augment(torch.from_numpy(batch),
                               *jax_draws(key, 8, hflip, vflip, rot90, 0.0))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("degrees,shape", [(5.0, (6, 16, 16, 3)),
                                           (30.0, (4, 12, 20, 2))])
def test_rotation_matches_jax(degrees, shape):
    batch = noise(shape, 3)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_paired_augment(key, jnp.asarray(batch), hflip=True,
                                         vflip=True, rotate_degrees=degrees))
    got = apply_paired_augment(torch.from_numpy(batch),
                               *jax_draws(key, shape[0], True, True, False,
                                          degrees))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_port_draws_are_paired_and_seeded():
    """Every channel of a sample gets one transform; the same generator
    seed gives the same batch, and flips vary across samples."""
    base = noise((16, 12, 12, 1), 4)
    batch = torch.from_numpy(np.repeat(base, 3, axis=-1))

    def run(seed, **kw):
        return paired_augment(batch, torch.Generator().manual_seed(seed), **kw)

    for kw in ({}, {"rot90": True}, {"rotate_degrees": 5.0}):
        out = run(0, **kw)
        assert out.shape == batch.shape
        assert torch.equal(out[..., 0], out[..., 1])
        assert torch.equal(out[..., 0], out[..., 2])
        assert torch.equal(run(0, **kw), out)
    flipped = run(1, vflip=False)
    same = [torch.equal(flipped[i], batch[i]) for i in range(16)]
    hflipped = [torch.equal(flipped[i], batch[i].flip(1)) for i in range(16)]
    assert all(a or b for a, b in zip(same, hflipped))
    assert any(same) and any(hflipped)


def test_rot90_needs_square_images():
    x = torch.zeros(2, 8, 12, 3)
    with pytest.raises(ValueError, match="square"):
        apply_paired_augment(x, k=torch.tensor([0, 1]))
