"""The plain references agree with the port at FEAT = 4, 64^2, on the CPU,
on the benchmark's seeded weights; the controls do not."""

import numpy as np
import pytest
import torch

from portbench.reference import fastddpm as ref_dm
from portbench.reference import unet as ref_unet
from portbench.reference.phantom import pair_pool, pair_plan
from portbench.weights import fastddpm_weights, unet_weights

FEAT, HW = 4, 64


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_unet_reference_matches_the_port():
    from mrisr_tpu_torch.ckpt.fold_bn import fold_unet_batchnorm
    from mrisr_tpu_torch.models.unet import UNet

    w = unet_weights(ref_unet.param_shapes(FEAT), 5, torch.device("cpu"))
    model = UNet(features=FEAT)
    missing = model.load_state_dict(w, strict=False)
    assert not missing.unexpected_keys
    assert all(k.endswith("num_batches_tracked")
               for k in missing.missing_keys)
    model.eval()
    x = torch.from_numpy(pair_pool(9, 1, 6, HW)[0, :3])
    with torch.no_grad():
        want = model(x)
        got = ref_unet.forward(w, x)
        folded = fold_unet_batchnorm(model)(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(folded, want, rtol=1e-4, atol=1e-4)
    calib = [x]  # static scales: inputs past the calibration would clip
    q4 = ref_unet.forward_served(w, x, ref_unet.calibrated(w, calib, 4, "cpu"))
    q16 = ref_unet.forward_served(w, x, ref_unet.calibrated(w, calib, 16,
                                                            "cpu"))
    rel = lambda a: float((a - want).norm() / want.norm())  # noqa: E731
    assert rel(q16) < 1e-3 < 0.1 < rel(q4)


def test_fastddpm_reference_matches_the_port():
    from mrisr_tpu_torch.models.diffusion import (
        DiffusionSchedule,
        FastDDPMUNet,
        sample_ancestral,
    )

    w = fastddpm_weights(ref_dm.param_shapes(FEAT, 16), 6,
                         torch.device("cpu"))
    model = FastDDPMUNet(base_features=FEAT, time_dim=16)
    model.load_state_dict(w, strict=True)
    model.eval()
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, HW, HW, 3), generator=g)
    t = torch.tensor([949, 175])
    with torch.no_grad():
        torch.testing.assert_close(ref_dm.denoiser(w, x, t), model(x, t),
                                   rtol=1e-4, atol=1e-4)
        sched = DiffusionSchedule.create(1000, 10, "cosine",
                                         "nonuniform-4060")
        assert ref_dm.nonuniform_4060().tolist() == \
            sched.timesteps.tolist()
        cond = x[..., :2]
        x_t = torch.randn((2, HW, HW, 1), generator=g)
        zs = [torch.randn((2, HW, HW, 1), generator=g) for _ in range(9)]
        want = sample_ancestral(model, cond, None, sched, noise=(x_t, zs))
        got = ref_dm.sample(w, cond, x_t, zs)
        q4 = ref_dm.sample(w, cond, x_t, zs, ref_dm.calibrated(
            w, [x[..., :2]], 4, "cpu"))
    # the chain multiplies a step's rounding by up to 1/sqrt(abar) = 12.8,
    # so single pixels differ in the third digit: held as a whole
    rel = lambda a: float((a - want).norm() / want.norm())  # noqa: E731
    assert rel(got) < 1e-4 < 1e-3 < rel(q4)


def test_phantom_pairs_are_the_3mm_plan():
    assert pair_plan(60).shape == (29, 2)
    assert pair_plan(60)[-1].tolist() == [56, 58]
    a = pair_pool(123456789012, 2, 8, 32)
    b = pair_pool(123456789012, 2, 8, 32)
    assert a.shape == (2, 3, 32, 32, 2) and np.array_equal(a, b)
    assert abs(float(a[..., 0].mean())) < 1e-4
    assert not np.array_equal(a, pair_pool(2, 2, 8, 32))


def test_phantom_is_the_synthetic_volume():
    from mrisr_tpu_torch.data.synthetic import make_synthetic_volume
    from portbench.reference.phantom import phantom_volume

    np.testing.assert_array_equal(phantom_volume(4, 32, 32, seed=17),
                                  make_synthetic_volume(4, 32, 32, seed=17))


def test_training_reference_matches_the_port_step():
    """The port's float32 ``unet_combined`` step, driven as the training
    cell drives it, against the reference's step on the same batches."""
    import time

    from portbench import core
    from portbench.cell import run_cell

    r = run_cell(core.with_deferred(core.benchmark()), "unet_m2.train_bf16",
                 31, 0.2, False,
                 torch.device("cpu"), time.perf_counter(),
                 config_overrides={"widths": {"base_features": FEAT},
                                   "image_size": HW, "volume": {"slices": 8}},
                 traffic_overrides={"compute_dtype": "float32",
                                    "patients": 12},
                 log=lambda s: None)
    got = r["readings"]
    # float32 on both sides: the sums run in another order
    assert got["loss"] < 1e-4 and got["grad_worst"] < 1e-4
    # Adam moves an element by about lr whatever its gradient, so elements
    # whose gradient is rounding-sized move either way
    assert got["change_median"] < 2e-3 and got["excluded"] == 18
    assert r["checks"]["loader_rows"][0] < 1e-5
