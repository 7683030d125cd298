"""Data-parallel serving in the port (``serve/engine.py:
data_parallel_apply``) against the JAX package's DP engine and the port's
single engine (CPU, two replicas on the CPU; FEAT 4 pair UNet at 16^2,
width-8 Fast-DDPM at 16^2).  ``tests/test_serve.py:136-168`` and
``tests/test_bundle.py:409-433`` are the JAX side's tests."""

import os

import numpy as np
import pytest
import torch

from mrisr_tpu.config import ModelConfig as JaxModelConfig
from mrisr_tpu.serve import engine as je
from mrisr_tpu_torch.ckpt.torch_ckpt import reference_checkpoint
from mrisr_tpu_torch.config import ModelConfig
from mrisr_tpu_torch.models.diffusion import FastDDPMUNet
from mrisr_tpu_torch.serve import (
    data_parallel_apply,
    engine_from_bundle,
    engine_from_model,
    load_bundle,
    make_bundle_apply,
)
from mrisr_tpu_torch.serve.bundle import export_serving_bundle
from torch_port_util import jax_unet_variables, noise, port_unet

torch.set_num_threads(2)

F, HW, DBASE = 4, 16, 8
CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A reference-layout ``unet_best.pt`` both packages load and a
    ``fastddpm_best.pt`` at width 8."""
    w = tmp_path_factory.mktemp("dp_serving")
    os.makedirs(w / "models")
    torch.save(reference_checkpoint(port_unet(
        jax_unet_variables(F, HW, seed=51), F), "unet"),
        w / "models" / "unet_best.pt")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(52)
        diff = FastDDPMUNet(base_features=DBASE)
    torch.save(reference_checkpoint(diff, "fastddpm"),
               w / "models" / "fastddpm_best.pt")
    return w


def _requests(n, seed):
    return list(noise((n, HW, HW, 2), seed=seed))


def test_dp_engine_matches_jax_dp_engine(models):
    """``engine_from_model(..., data_parallel=True, devices=[cpu, cpu])``
    against the JAX package's DP engine on its 8-device mesh, the same
    checkpoint and requests (``tests/test_serve.py:136-156``: atol 2e-2,
    the bf16 forward's bound), and against the port's single engine."""
    xs = _requests(10, seed=53)
    common = dict(models_dir=str(models / "models"), image_size=(HW, HW),
                  batch_size=8, max_delay_ms=20.0)
    with je.engine_from_model("unet", cfg=JaxModelConfig(base_features=F),
                              data_parallel=True, **common) as eng:
        want = np.stack(eng.predict_many(xs))
    with engine_from_model("unet", cfg=ModelConfig(base_features=F),
                           data_parallel=True, devices=CPU2, device="cpu",
                           **common) as eng:
        got = np.stack(eng.predict_many(xs))
    with engine_from_model("unet", cfg=ModelConfig(base_features=F),
                           device="cpu", **common) as eng:
        single = np.stack(eng.predict_many(xs))
    assert got.shape == (10, HW, HW, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-2)
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-6)


def test_dp_int8_fused_engine_equals_single(models):
    """The int8_fused forward (kernels A and B; their plain versions here)
    with one replica and its tables a device: the DP engine equals the
    single engine bit for bit, the codes being exact integer sums."""
    xs = _requests(8, seed=54)
    common = dict(models_dir=str(models / "models"), quant="int8_fused",
                  image_size=(HW, HW), batch_size=4, device="cpu",
                  cfg=ModelConfig(base_features=F),
                  calibration_batches=[noise((4, HW, HW, 2), seed=55)])
    with engine_from_model("unet", **common) as eng:
        single = np.stack(eng.predict_many(xs))
    with engine_from_model("unet", data_parallel=True, devices=CPU2,
                           **common) as eng:
        got = np.stack(eng.predict_many(xs))
    np.testing.assert_array_equal(got, single)


def test_dp_batch_divisibility():
    """A micro-batch that does not divide over the devices raises
    ``ValueError`` naming it (``tests/test_serve.py:159-168``): at build
    time before any replica is built, and when the wrapped forward is
    called directly on such a batch."""
    built = []
    with pytest.raises(ValueError, match="divide"):
        data_parallel_apply(built.append, 3, devices=CPU2, device="cpu")
    assert built == []
    fwd = data_parallel_apply(lambda d: lambda x: x[..., :1], 4,
                              devices=CPU2, device="cpu")
    assert fwd(torch.zeros(4, 2, 2, 2)).shape == (4, 2, 2, 1)
    with pytest.raises(ValueError, match="divide"):
        fwd(torch.zeros(3, 2, 2, 2))
    with pytest.raises(ValueError, match="divide"):
        engine_from_model("unet", models_dir="missing",
                          cfg=ModelConfig(base_features=F),
                          image_size=(HW, HW), batch_size=3,
                          data_parallel=True, devices=CPU2, device="cpu",
                          require_checkpoint=False)


def test_dp_default_devices_on_cpu():
    """``devices=None`` on the CPU: the engine's own device, one replica
    (on the card it is every visible card)."""
    seen = []

    def make(d):
        seen.append(d)
        return lambda x: x[..., :1] * 2

    fwd = data_parallel_apply(make, 4, device="cpu")
    x = torch.arange(4 * 2 * 2 * 2, dtype=torch.float32).reshape(4, 2, 2, 2)
    assert seen == [torch.device("cpu")]
    assert torch.equal(fwd(x), x[..., :1] * 2)


@pytest.mark.parametrize("kind", ["pair int8_fused", "fastddpm int8_deep"])
def test_dp_bundle_engine_equals_single(models, tmp_path, kind):
    """``engine_from_bundle(..., data_parallel=True)`` over two CPU
    replicas against the single engine of the same bundle
    (``tests/test_bundle.py:409-433``).  The Fast-DDPM sampler seeds its
    generator with 0 for the batch it is given: each replica gets its rows
    of the global batch's draws, so the answers equal the single engine's,
    while replicas that drew for their own rows would repeat the first
    rows' noise."""
    model, quant = kind.split()
    name = "unet" if model == "pair" else "fastddpm"
    cfg = ModelConfig(name=name, base_features=F if model == "pair"
                      else DBASE)
    path = export_serving_bundle(
        str(tmp_path / "b"), model_name=name,
        models_dir=str(models / "models"), quant=quant,
        calibration_batches=[noise((4, HW, HW, 2), seed=56)], cfg=cfg,
        image_size=(HW, HW), device="cpu")
    xs = _requests(8, seed=57)
    common = dict(batch_size=4, max_delay_ms=20.0, device="cpu")
    with engine_from_bundle(path, **common) as eng:
        single = np.stack(eng.predict_many(xs))
    with engine_from_bundle(path, data_parallel=True, devices=CPU2,
                            **common) as eng:
        got = np.stack(eng.predict_many(xs))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, single)
    if model == "fastddpm":
        # the replicas' own seed-0 draws would differ from the global ones
        apply = make_bundle_apply(*load_bundle(path), device="cpu")
        x = torch.from_numpy(np.stack(xs[:4]))
        naive = torch.cat([apply(x[:2]), apply(x[2:])]).numpy()
        assert not np.array_equal(naive, single[:4])
