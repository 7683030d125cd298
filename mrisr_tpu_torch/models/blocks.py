"""Shared conv blocks (counterpart: ``mrisr_tpu/models/blocks.py``).

The module layout mirrors the reference PyTorch UNetBlock: a ``conv``
Sequential whose indices 0/1/3/4 are conv/BN/conv/BN, so the reference's
``.pt`` state-dict keys (``enc1.conv.0.weight`` ...) load as they are.

**Compute dtype** (flax's ``dtype=``, ``mrisr_tpu/models/registry.py:
create_model(name, cfg, dtype)``).  :func:`set_compute_dtype` gives every
conv, transposed conv and dense layer of a model a ``compute_dtype``; the
parameters stay float32, so the optimizer and the checkpoints see float32,
and autograd hands the float32 parameters float32 gradients through the
casts, as JAX differentiates through ``astype``.  The layers round where
flax rounds:

- conv, transposed conv, dense: input, kernel and bias cast to bf16, the
  product rounded to bf16, then the bias added in bf16 (a second rounding);
- BatchNorm and GroupNorm (:class:`BatchNorm2d`, :class:`GroupNorm`): a
  bf16 input is promoted to float32, the statistics (and BatchNorm's
  float32 running statistics) come from that, the normalization runs in
  float32 and its result is rounded to bf16 once;
- SiLU (:func:`silu`): ``x * (1 / (1 + exp(-x)))`` op by op in bf16, each
  op rounded, the expression ``jax.nn.silu`` runs on a bf16 array;
- everything between (ReLU, max-pool, concatenation, DeepCNN's residual
  add, the time-embedding add) runs on the bf16 tensors themselves.

``torch.autocast`` rounds elsewhere: it returns float32 from ``batch_norm``
and keeps elementwise ops in float32, so a residual add or a GroupNorm ->
SiLU between two convs would see unrounded values.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mrisr_tpu_torch.models.conv import Conv2d, lowp_bias

# flax momentum 0.9 == torch momentum 0.1 (torch weighs the NEW batch)
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode update of ``running_var``
    uses the biased batch variance, as flax's ``BatchNorm`` does
    (``mrisr_tpu/models/blocks.py``); torch's own update uses the unbiased
    one, n / (n - 1) larger, which at a 2x2 bottleneck of batch 4 (n = 16)
    is a 6.7 % difference an update.  Normalization (biased variance), the
    momentum, eps, the eval forward and the state-dict keys are torch's.

    A bf16 input is normalized in float32 (statistics included) and the
    result returned in bf16, as flax's ``BatchNorm(dtype=bfloat16)``.

    ``data_mesh`` (set by ``parallel/mesh.py:replicated``): in training
    mode the statistics are the global batch's over the data group, as
    under JAX's mesh: the sum all-reduced for the mean, then the sum of
    squared deviations for the biased variance, through a collective whose
    backward is the global one.  ``torch.nn.SyncBatchNorm`` refuses CPU
    tensors and updates the running variance with the unbiased rule.

    Under :func:`remat` the backward re-runs the forward to rebuild its
    saved tensors.  That re-run (``recomputing``, set by :func:`remat`)
    normalizes as the forward did, a data mesh's all-reduces included
    (their sums feed the rebuilt normalization, and every rank re-runs the
    same graph), but leaves the running statistics and the counter alone:
    the forward committed them, once a step, as flax commits
    ``batch_stats`` once under ``nn.remat``."""

    data_mesh = None
    recomputing = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return self._forward(x.float()).to(x.dtype)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.data_mesh is not None:
            return self._forward_global(x)
        if not self.recomputing:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        from mrisr_tpu_torch.parallel.mesh import psum

        mesh, shape = self.data_mesh, (1, -1, 1, 1)
        n = x.numel() // x.shape[1] * mesh.size
        mean = psum(x.sum(dim=(0, 2, 3)), mesh) / n
        dev = x - mean.view(shape)
        var = psum((dev * dev).sum(dim=(0, 2, 3)), mesh) / n
        if not self.recomputing:
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
                self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return dev * scale.view(shape) + self.bias.view(shape)


@contextlib.contextmanager
def _recomputing(block: nn.Module) -> Iterator[None]:
    """Mark ``block``'s BatchNorms while the backward re-runs it."""
    norms = [m for m in block.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


def remat(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` keeping only ``x`` for the backward, which re-runs the
    block to rebuild what it saved: flax's ``nn.remat``.  Non-reentrant,
    so the re-run records with grad mode on, as the forward did, and every
    conv takes the same route both times (``models/conv.py:avoids_cudnn``).
    The re-run marks the block's BatchNorms (``recomputing``), so they
    commit their running statistics once.  The blocks draw no random
    numbers, so there is no RNG state to replay
    (``preserve_rng_state=False``)."""
    return torch.utils.checkpoint.checkpoint(
        block, x, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing(block)))


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm``; a bf16 input is normalized in float32 and the
    result returned in bf16, as flax's ``GroupNorm(dtype=bfloat16)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return super().forward(x.float()).to(x.dtype)
        return super().forward(x)


class Linear(nn.Linear):
    """``nn.Linear`` that runs in ``compute_dtype`` when one is set (flax's
    ``Dense(dtype=...)``: the product rounded, then the bias added)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        return lowp_bias(F.linear(x.to(cd), self.weight.to(cd)), self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that runs in ``compute_dtype`` when one is
    set (flax's ``ConvTranspose(dtype=...)``)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        y = F.conv_transpose2d(x.to(cd), self.weight.to(cd), None,
                               self.stride, self.padding, self.output_padding,
                               self.groups, self.dilation)
        return lowp_bias(y, self.bias)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU; on a bf16 tensor ``x * (1 / (1 + exp(-x)))`` op by op, each
    op rounded to bf16, as ``jax.nn.silu`` computes it on a bf16 array."""
    if x.dtype == torch.bfloat16:
        return x * torch.reciprocal(1 + torch.exp(-x))
    return F.silu(x)


class SiLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return silu(x)


def set_compute_dtype(model: nn.Module,
                      dtype: Optional[torch.dtype]) -> nn.Module:
    """flax's ``dtype=`` for every layer of ``model``: bf16 computes each
    conv, transposed conv and dense layer in bf16, and the norms and
    activations follow their inputs' type; float32 or None computes in the
    parameters' own type.  The parameters are untouched."""
    cd = torch.bfloat16 if dtype == torch.bfloat16 else None
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.compute_dtype = cd
    return model


class DoubleConv(nn.Module):
    """(Conv3x3 -> BN -> ReLU) x 2.

    ``use_bn=False`` builds the BN-folded inference variant (conv -> ReLU
    x 2, indices 0 and 2); folded convs always carry a bias.
    """

    def __init__(self, in_channels: int, features: int,
                 use_bias: bool = True, use_bn: bool = True):
        super().__init__()
        layers = []
        for i in range(2):
            layers.append(Conv2d(
                in_channels if i == 0 else features, features, 3, padding=1,
                bias=use_bias or not use_bn,
            ))
            if use_bn:
                layers.append(BatchNorm2d(
                    features, eps=BN_EPS, momentum=BN_MOMENTUM))
            layers.append(nn.ReLU(inplace=True))
        self.conv = nn.Sequential(*layers)

    def convs(self):
        """The two Conv2d layers, in order."""
        return [m for m in self.conv if isinstance(m, nn.Conv2d)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel_size=2, stride=2) on NCHW."""
    return F.max_pool2d(x, 2, 2)


def max_pool_3x3_s1(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel_size=3, stride=1, padding=1) on NCHW, the DeepCNN
    stem's; the padding is -inf, as flax's ``nn.max_pool`` pads."""
    return F.max_pool2d(x, 3, stride=1, padding=1)


class PixelShuffleUpConv(ConvTranspose2d):
    """ConvTranspose2d(kernel_size=2, stride=2) computed as one matmul and
    a pixel shuffle.  With kernel == stride the op is exactly

        out[n, o, 2i + a, 2j + b] = sum_c x[n, c, i, j] W[c, o, a, b] + bias[o]

    one ``(N*H*W, C_in) @ (C_in, 4*C_out)`` product, the interleave of its
    four phases, then the bias.  Its parameters are ``ConvTranspose2d``'s
    (``weight`` ``(C_in, C_out, 2, 2)``, ``bias``), so checkpoints, the
    flax kernel carry (``ckpt/from_jax.py:convt_weight``) and the init are
    the same for both forms.  In ``compute_dtype`` the product is rounded,
    then the bias added, as flax's ``PixelShuffleUpConv(dtype=...)``."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(in_channels, features, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        w = self.weight if cd is None else self.weight.to(cd)
        x = x if cd is None else x.to(cd)
        n, ci, h, wd = x.shape
        co = w.shape[1]
        y = torch.matmul(x.permute(0, 2, 3, 1).reshape(-1, ci),
                         w.reshape(ci, co * 4))
        y = (y.reshape(n, h, wd, co, 2, 2).permute(0, 3, 1, 4, 2, 5)
             .reshape(n, co, 2 * h, 2 * wd))
        return lowp_bias(y, self.bias)


def UpConv2x2(in_channels: int, features: int,
              impl: str = "convt") -> ConvTranspose2d:
    """ConvTranspose2d(kernel_size=2, stride=2).  Its weight is
    ``(in, out, 2, 2)``; the flax kernel is the same spatially flipped
    (``ckpt/from_jax.py``).  ``impl='pixel_shuffle'`` computes it as
    :class:`PixelShuffleUpConv`, with the same parameters; 'convt' (the
    default, as in the JAX package) is ``F.conv_transpose2d``."""
    if impl == "pixel_shuffle":
        return PixelShuffleUpConv(in_channels, features)
    if impl != "convt":
        raise ValueError(f"UpConv2x2 impl must be 'convt' or "
                         f"'pixel_shuffle', got {impl!r}")
    return ConvTranspose2d(in_channels, features, 2, stride=2)
