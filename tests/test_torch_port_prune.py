"""The teacher-pruned student init in the port against mrisr_tpu/serve/
prune.py (CPU): the channel selection and the pruned tree equal to the JAX
package's on the same flax trees, the slice loaded into a port student
equal to the JAX tree carried by ``from_jax``, identity at equal width and
the refusals."""

import numpy as np
import pytest
import torch

from mrisr_tpu.serve import prune as jprune
from mrisr_tpu_torch.ckpt import unet_state_dict_from_flax
from mrisr_tpu_torch.ckpt.from_jax import unet_flax_params
from mrisr_tpu_torch.ckpt.torch_ckpt import reference_checkpoint
from mrisr_tpu_torch.config import ModelConfig
from mrisr_tpu_torch.models import UNet
from mrisr_tpu_torch.serve import prune as pprune
from torch_port_util import jax_unet_variables, port_unet

torch.set_num_threads(2)

HW = 32


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


@pytest.fixture(scope="module")
def trees():
    teacher = jax_unet_variables(8, HW, seed=51)
    # a dead-channel pattern in one BatchNorm, so the selection is not the
    # identity's leading slice
    g = teacher["params"]["enc2"]["BatchNorm_1"]["scale"]
    g[::2] = 0.0
    student = jax_unet_variables(4, HW, seed=52)
    return _numpy(teacher), _numpy(student)


def test_selection_and_tree_equal_jax(trees):
    teacher, student = trees
    want_idx = jprune.select_channel_indices(teacher, student["params"])
    got_idx = pprune.select_channel_indices(teacher, student["params"])
    assert set(got_idx) == set(want_idx)
    for k in want_idx:
        np.testing.assert_array_equal(got_idx[k], want_idx[k], err_msg=k)
    # the zeroed |gamma| channels are the ones dropped
    np.testing.assert_array_equal(got_idx["enc2.out"], np.arange(1, 16, 2))
    want = jprune.prune_unet_teacher(teacher, student)
    got = pprune.prune_unet_teacher(teacher, student)
    want_leaves, got_leaves = dict(_leaves(want)), dict(_leaves(got))
    assert set(got_leaves) == set(want_leaves)
    for k, w in want_leaves.items():
        assert got_leaves[k].dtype == np.float32, k
        np.testing.assert_array_equal(got_leaves[k], np.asarray(w),
                                      err_msg=k)


def test_load_pruned_student_init_matches_jax(trees, tmp_path):
    """A reference-layout teacher checkpoint, pruned into a port student by
    ``load_pruned_student_init``: the student's state equals the JAX
    package's pruned tree carried by ``unet_state_dict_from_flax``."""
    teacher, _ = trees
    torch.save(reference_checkpoint(port_unet(teacher, 8), "unet"),
               tmp_path / "unet_best.pt")
    student = UNet(features=4)
    sv = pprune._numpy_tree(unet_flax_params(student))
    pprune.load_pruned_student_init("unet", str(tmp_path), student,
                                    cfg=ModelConfig(base_features=8),
                                    device="cpu")
    want = unet_state_dict_from_flax(jprune.prune_unet_teacher(teacher, sv))
    got = student.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(got[k], w), k


def test_identity_at_equal_width(trees):
    teacher, _ = trees
    pruned = pprune.prune_unet_teacher(teacher, teacher)
    want = dict(_leaves({"params": teacher["params"],
                         "batch_stats": teacher["batch_stats"]}))
    for k, v in _leaves(pruned):
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    model = port_unet(pruned, 8)
    x = torch.rand(2, HW, HW, 2)
    with torch.no_grad():
        torch.testing.assert_close(model(x), port_unet(teacher, 8)(x),
                                   rtol=0, atol=1e-6)


def test_refusals(trees):
    teacher, student = trees
    with pytest.raises(ValueError, match="exceeds teacher width"):
        pprune.prune_unet_teacher(student, teacher)
    wrong = {"params": dict(student["params"]),
             "batch_stats": student["batch_stats"]}
    wrong["params"]["final"] = {"kernel": np.zeros((1, 1, 5, 1), np.float32),
                                "bias": np.zeros((1,), np.float32)}
    with pytest.raises(ValueError, match="shape mismatch at /final/kernel"):
        pprune.prune_unet_teacher(teacher, wrong)
