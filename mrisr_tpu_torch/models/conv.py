"""``Conv2d`` with its route picked from the shape it is called at.

Two kinds of float32 calls on the card go around cuDNN to PyTorch's own
convolution (im2col and one cuBLAS GEMM a sample, forward and backward),
both measured on an NVIDIA H100 80GB HBM3 at 700 W
(``tools/train_step_probe.py``, ``tools/route_probe.py``, PERF.md §5-6):

- ``'fft'``: the shapes of :data:`CUDNN_FFT_SHAPES`, at which cuDNN's
  heuristic runs an FFT convolution with one complex GEMM per frequency
  bin: the UNet's ``dec2.conv.0`` (256 -> 128 channels at 128^2, batch 4)
  took 300-450 ms forward and backward that way and takes 5.5 ms here,
  within 1e-5 of cuDNN's output.
- ``'small map'``: a conv that autograd records (a train step) at batch
  <= 4 on a map of at most 64 x 64.  There cuDNN's float32 algorithms
  left the Fast-DDPM step's worst gradient 3x further from a float64 step
  than the CPU's own float32 step (1.2e-4 against 3.9e-5); this route
  brings it to 2.3e-5, and the Fast-DDPM and unet_combined steps are no
  slower for it (79.4 against 80.8 ms, 54.5 against 60.8).

Every other call is ``nn.Conv2d``'s.  The state-dict keys and the module
type (a subclass of ``nn.Conv2d``) are unchanged, so checkpoints, the BN
fold and the int8 quantizer see the layer they saw before.

A layer with a ``compute_dtype`` (bf16: ``models/blocks.py:
set_compute_dtype``, flax's ``dtype=``) casts its input, weight and bias to
that type, convolves, rounds, then adds the bias and rounds again, as flax's
``nn.Conv`` does.  Those calls go to cuDNN: no bf16 conv of the six
families' train steps (batch 4) or eval forwards (batch 8) runs more than
10x its bf16 bound under cuDNN while PyTorch's own conv is 5x faster
(``tools/train_step_probe.py --dtype bfloat16``, 156 shapes, NVIDIA H100
80GB HBM3 at 700 W).  The best own-conv gain is 1.6x, at the UNet's
``upconv4`` (4 x 1024 x 16^2: cuDNN 1.485 ms, 114x its bound; own 0.930),
too small a gain to route.  The 'fft' shape above is cuDNN's float32
choice: in bf16 ``dec2.conv.0`` takes 1.495 ms under cuDNN, 3.588 own.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# (batch, C_in, C_out, H, W) of the float32 3x3 stride-1 convs at which
# cuDNN's heuristic runs an FFT convolution more than 10x over the conv's
# float32 bound while PyTorch's own convolution is at least 5x faster
CUDNN_FFT_SHAPES = frozenset({
    (4, 256, 128, 128, 128),
})
# the 'small map' route: batch and map side at most
SMALL_MAP_BATCH, SMALL_MAP_SIDE = 4, 64


def route(shape: Sequence[int], conv: nn.Conv2d,
          recorded: bool) -> Optional[str]:
    """The route of a float32 conv on the card at NCHW input ``shape``:
    'fft', 'small map' (``recorded``: autograd records the call) or None
    (cuDNN)."""
    n, c, h, w = shape
    if conv.groups != 1:
        return None
    if (conv.kernel_size == (3, 3) and conv.stride == (1, 1)
            and (n, c, conv.out_channels, h, w) in CUDNN_FFT_SHAPES):
        return "fft"
    if recorded and n <= SMALL_MAP_BATCH and max(h, w) <= SMALL_MAP_SIDE:
        return "small map"
    return None


def avoids_cudnn(x: torch.Tensor, conv: nn.Conv2d) -> bool:
    """True where ``conv`` at ``x`` skips cuDNN: a float32 CUDA input and
    a :func:`route`."""
    if not (x.is_cuda and x.dtype == torch.float32 and x.dim() == 4):
        return False
    recorded = torch.is_grad_enabled() and (x.requires_grad
                                            or conv.weight.requires_grad)
    return route(x.shape, conv, recorded) is not None


class _NoCudnnConv(torch.autograd.Function):
    """A convolution whose forward and backward both run with cuDNN off
    (PyTorch's own im2col + GEMM).  The TF32 settings of the caller hold:
    the GEMMs are cuBLAS's."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, dilation, bias is not None)
        with _cudnn_off():
            return F.conv2d(x, weight, bias, stride, padding, dilation)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, has_bias = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                has_bias and ctx.needs_input_grad[2]]
        with _cudnn_off():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if has_bias else None,
                stride, padding, dilation, False, [0, 0], 1, mask)
        return gx, gw, gb, None, None, None


@contextlib.contextmanager
def _cudnn_off() -> Iterator[None]:
    """``torch.backends.cudnn.enabled = False`` inside the block and
    nothing else (``cudnn.flags`` would also reset TF32 and benchmark)."""
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


def conv2d_no_cudnn(x: torch.Tensor, weight: torch.Tensor,
                    bias, stride: Tuple[int, int] = (1, 1),
                    padding: Tuple[int, int] = (0, 0),
                    dilation: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """``F.conv2d`` (groups 1) with cuDNN off in the forward and the
    backward."""
    return _NoCudnnConv.apply(x, weight, bias, tuple(stride), tuple(padding),
                              tuple(dilation))


def lowp_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``y + bias`` in ``y``'s type: flax adds the bias after the product
    has been rounded, and rounds the sum again.  ``y`` is NCHW or
    ``(..., C)``."""
    if bias is None:
        return y
    b = bias.to(y.dtype)
    return y + (b[:, None, None] if y.dim() == 4 else b)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that sends the calls of :func:`avoids_cudnn` around
    cuDNN, and runs in ``compute_dtype`` when one is set."""

    # None: the parameters' own type (float32, or float64 after .double())
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is not None:
            return lowp_bias(self._conv_forward(x.to(cd), self.weight.to(cd),
                                                None), self.bias)
        if self.padding_mode == "zeros" and avoids_cudnn(x, self):
            return conv2d_no_cudnn(x, self.weight, self.bias, self.stride,
                                   self.padding, self.dilation)
        return super().forward(x)
