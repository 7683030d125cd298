"""Teacher-pruned student initialization for serving distillation
(counterpart: ``mrisr_tpu/serve/prune.py``).

The width-f student starts from a magnitude-pruned channel slice of the
trained width-F teacher instead of a random init, so distillation
fine-tunes a coarse approximation of the function it must mimic.  Channels
are chosen Network-Slimming style (Liu et al. 2017): every conv of the UNet
is followed by BatchNorm, which normalizes away the kernel's output scale,
so a channel's importance is the |gamma| of its BatchNorm; the upconvs have
no BatchNorm and are scored by each output channel's kernel L2 norm.

Each activation gets ONE ascending index set, used everywhere it flows:
a block's Conv_0 output into its Conv_1; a block's output into the next
block (through the max-pool) and, as the skip, into the matching decoder's
concat; the bottleneck's output into upconv4; an upconv's output into the
first half of its decoder's concat, whose second half is the skip set
offset by the teacher's upconv width.  BatchNorm running statistics are
sliced along.

The slicing works on numpy trees in flax layout (HWIO kernels, the
ConvTranspose kernels flipped as flax applies them), which the port
converts to and from once (``ckpt/from_jax.py``), so no slice can pick the
wrong axis of a torch weight.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mrisr_tpu_torch.device import DeviceLike

BLOCKS = (
    "enc1", "enc2", "enc3", "enc4", "bottleneck",
    "dec4", "dec3", "dec2", "dec1",
)
UPCONVS = ("upconv4", "upconv3", "upconv2", "upconv1")
# decoder block -> (matching upconv, matching encoder skip)
DEC_INPUTS = {
    "dec4": ("upconv4", "enc4"),
    "dec3": ("upconv3", "enc3"),
    "dec2": ("upconv2", "enc2"),
    "dec1": ("upconv1", "enc1"),
}


def _topk_ascending(score: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest scores, in ascending index order (keeps the
    teacher's relative channel layout)."""
    if k > score.shape[0]:
        raise ValueError(
            f"student width {k} exceeds teacher width {score.shape[0]}")
    return np.sort(np.argpartition(score, -k)[-k:])


def _block_widths(params: Dict, block: str) -> tuple:
    c0 = params[block]["Conv_0"]["kernel"].shape[-1]
    c1 = params[block]["Conv_1"]["kernel"].shape[-1]
    return c0, c1


def select_channel_indices(teacher_vars: Dict, student_params: Dict
                           ) -> Dict[str, np.ndarray]:
    """One ascending index set per produced activation.

    Keys: ``<block>.mid`` (Conv_0 output), ``<block>.out`` (Conv_1 output),
    ``<upconv>.out``."""
    tp = teacher_vars["params"]
    idx: Dict[str, np.ndarray] = {}
    for blk in BLOCKS:
        k_mid, k_out = _block_widths(student_params, blk)
        g0 = np.abs(np.asarray(tp[blk]["BatchNorm_0"]["scale"]))
        g1 = np.abs(np.asarray(tp[blk]["BatchNorm_1"]["scale"]))
        idx[f"{blk}.mid"] = _topk_ascending(g0, k_mid)
        idx[f"{blk}.out"] = _topk_ascending(g1, k_out)
    for up in UPCONVS:
        w = np.asarray(tp[up]["kernel"])  # (2, 2, ci, co)
        score = np.sqrt((w.astype(np.float64) ** 2).sum(axis=(0, 1, 2)))
        k = student_params[up]["kernel"].shape[-1]
        idx[f"{up}.out"] = _topk_ascending(score, k)
    return idx


def _input_indices(tp: Dict, idx: Dict[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
    """Input-channel index set per consuming layer."""
    n_in = tp["enc1"]["Conv_0"]["kernel"].shape[-2]
    ins: Dict[str, np.ndarray] = {"enc1.Conv_0": np.arange(n_in)}
    order = ("enc1", "enc2", "enc3", "enc4", "bottleneck")
    for prev, cur in zip(order[:-1], order[1:]):
        ins[f"{cur}.Conv_0"] = idx[f"{prev}.out"]  # max-pool keeps channels
    for blk in BLOCKS:
        ins[f"{blk}.Conv_1"] = idx[f"{blk}.mid"]
    ins["upconv4"] = idx["bottleneck.out"]
    for k in (3, 2, 1):
        ins[f"upconv{k}"] = idx[f"dec{k + 1}.out"]
    for dec, (up, skip) in DEC_INPUTS.items():
        up_width = tp[up]["kernel"].shape[-1]
        ins[f"{dec}.Conv_0"] = np.concatenate(
            [idx[f"{up}.out"], up_width + idx[f"{skip}.out"]])
    ins["final"] = idx["dec1.out"]
    return ins


def _checked(tree: Dict, template: Dict, path: str = "") -> Dict:
    """``tree`` as float32 numpy, its structure and every leaf's shape
    equal to ``template``'s: a topology mismatch fails here, not as a
    shape error mid-training."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError(
                f"pruned tree structure mismatch at {path or '/'}: "
                f"{sorted(tree) if isinstance(tree, dict) else tree!r} vs "
                f"student {sorted(template)}")
        return {k: _checked(tree[k], template[k], f"{path}/{k}")
                for k in template}
    if tuple(tree.shape) != tuple(template.shape):
        raise ValueError(f"pruned tree shape mismatch at {path}: "
                         f"{tuple(tree.shape)} vs student "
                         f"{tuple(template.shape)}")
    return np.asarray(tree, np.float32)


def prune_unet_teacher(teacher_vars: Dict, student_vars: Dict) -> Dict:
    """Magnitude-pruned teacher slice shaped like ``student_vars``.

    teacher_vars: the UNFOLDED trained teacher (``{'params',
    'batch_stats'}``, flax layout, numpy leaves).  student_vars: the
    student's tree in the same layout (the shape template).  Returns a new
    ``{'params', 'batch_stats'}`` tree of float32 numpy arrays."""
    tp, tbs = teacher_vars["params"], teacher_vars["batch_stats"]
    sp = student_vars["params"]
    idx = select_channel_indices(teacher_vars, sp)
    ins = _input_indices(tp, idx)

    params: Dict = {}
    stats: Dict = {}
    for blk in BLOCKS:
        blk_p: Dict = {}
        blk_s: Dict = {}
        for ci, conv in enumerate(("Conv_0", "Conv_1")):
            out = idx[f"{blk}.{'mid' if ci == 0 else 'out'}"]
            inn = ins[f"{blk}.{conv}"]
            src = tp[blk][conv]
            ent = {"kernel": np.asarray(src["kernel"])[:, :, inn][..., out]}
            if "bias" in src:
                ent["bias"] = np.asarray(src["bias"])[out]
            blk_p[conv] = ent
            bn = f"BatchNorm_{ci}"
            blk_p[bn] = {
                "scale": np.asarray(tp[blk][bn]["scale"])[out],
                "bias": np.asarray(tp[blk][bn]["bias"])[out],
            }
            blk_s[bn] = {
                "mean": np.asarray(tbs[blk][bn]["mean"])[out],
                "var": np.asarray(tbs[blk][bn]["var"])[out],
            }
        params[blk] = blk_p
        stats[blk] = blk_s
    for up in UPCONVS:
        out, inn = idx[f"{up}.out"], ins[up]
        params[up] = {
            "kernel": np.asarray(tp[up]["kernel"])[:, :, inn][..., out],
            "bias": np.asarray(tp[up]["bias"])[out],
        }
    params["final"] = {
        "kernel": np.asarray(tp["final"]["kernel"])[:, :, ins["final"], :],
        "bias": np.asarray(tp["final"]["bias"]),
    }
    return {"params": _checked(params, sp),
            "batch_stats": _checked(stats, student_vars["batch_stats"])}


def _numpy_tree(tree: Dict) -> Dict:
    return {k: _numpy_tree(v) if isinstance(v, dict) else
            v.detach().float().cpu().numpy() for k, v in tree.items()}


def load_pruned_student_init(teacher_name: str, models_dir: str, student,
                             cfg=None, device: DeviceLike = None) -> None:
    """Load the teacher checkpoint (unfolded) on ``device`` (``None``: the
    card) and overwrite the port ``UNet`` ``student``'s parameters and
    BatchNorm statistics with its slice at the student's widths."""
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.ckpt.from_jax import (
        unet_flax_params,
        unet_state_dict_from_flax,
    )

    loaded = load_model(teacher_name, models_dir=models_dir,
                        checkpoint="required", cfg=cfg, fold_bn=False,
                        device=device)
    if not getattr(loaded.module, "use_bn", False):
        raise ValueError(
            "pruned init needs the UNFOLDED teacher (with batch_stats); "
            f"{teacher_name!r} loaded without them")
    pruned = prune_unet_teacher(_numpy_tree(unet_flax_params(loaded.module)),
                                _numpy_tree(unet_flax_params(student)))
    sd = unet_state_dict_from_flax(pruned)
    # the student's own BatchNorm step counters stay
    for k, v in student.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    student.load_state_dict(sd, strict=True)
