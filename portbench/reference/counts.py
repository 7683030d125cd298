"""Operations and bytes from shapes, and the H100's published peaks.

The work a model needs, counted from its call shapes: a conv's operations
are 2 x MACs; its bytes read each input once (int8 codes, int8 weights,
the per-channel float32 scale and bias) and write each output once.  The
same count holds whatever implements the site, so a kernel's share of its
bound cannot pass 100 % unless the time leaves out work.

Sites follow the served paths: the M2 UNet's int8_fused forward (kernel A
at every conv, int8 codes between them and float32 out of the 1x1 head;
kernel B at the four upconvs, the decoder's concat fused) and Fast-DDPM's
int8_deep forward (kernel A at the 16 deep sites with float32 out, kernel
B's float mode at upconv3 and upconv2, K3 at the 10 GroupNorm + SiLU sites
that feed a deep conv, bf16 in and int8 out; the rest in bf16).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense, at 700 W
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per element of K3: 3 for the sums, 2 for the affine,
# 5 for SiLU (exp counted as one), 3 for the quantizer
GN_OPS_PER_ELEM = 13

Site = Tuple[str, float, float, float]  # (name, operations, bytes, peak)


def conv_site(name: str, n: int, h: int, ci: int, co: int, k: int,
              out_bytes: int) -> Site:
    m = n * h * h
    return (name, 2.0 * m * co * k * k * ci,
            float(m * ci + co * k * k * ci + 8 * co + m * co * out_bytes),
            PEAK_INT8_OPS)


def upconv_site(name: str, n: int, h: int, c: int, co: int,
                float_out: bool) -> Site:
    """2x2 stride-2 upconv of an ``h``-square input; int8 out writes the
    concat with the skip (read once), float out writes float32."""
    m = n * h * h
    if float_out:
        nbytes = m * c + 4 * co * c + 32 * co + 16 * m * co
    else:
        nbytes = m * c + 4 * co * c + 32 * co + 4 * m * co + 4 * m * 2 * co
    return (name, 2.0 * m * c * 4 * co, float(nbytes), PEAK_INT8_OPS)


def gn_site(name: str, n: int, h: int, c: int) -> Site:
    elems = n * h * h * c
    return (name, float(GN_OPS_PER_ELEM * elems), float(3 * elems + 8 * c + 4),
            PEAK_FP32_FLOPS)


def bound_s(site: Site) -> float:
    """The least time the card could take for the site."""
    _, ops, nbytes, peak = site
    return max(ops / peak, nbytes / PEAK_BYTES)


def unet_kernel_sites(n: int, hw: int = 256, f: int = 64
                      ) -> Dict[str, List[Site]]:
    """Kernel A's and B's sites of one int8_fused forward of ``n`` rows."""
    a, h = [], hw
    widths = [(2, f), (f, 2 * f), (2 * f, 4 * f), (4 * f, 8 * f),
              (8 * f, 16 * f)]
    for name, (ci, co) in zip(("enc1", "enc2", "enc3", "enc4", "bottleneck"),
                              widths):
        a += [conv_site(f"{name}/Conv_0", n, h, ci, co, 3, 1),
              conv_site(f"{name}/Conv_1", n, h, co, co, 3, 1)]
        h //= 2
    for lvl, co in zip((4, 3, 2, 1), (8 * f, 4 * f, 2 * f, f)):
        h = hw >> (lvl - 1)
        a += [conv_site(f"dec{lvl}/Conv_0", n, h, 2 * co, co, 3, 1),
              conv_site(f"dec{lvl}/Conv_1", n, h, co, co, 3, 1)]
    a.append(conv_site("final", n, hw, f, 1, 1, 4))
    b = [upconv_site(f"upconv{lvl}", n, hw >> lvl, 2 * co, co, False)
         for lvl, co in zip((4, 3, 2, 1), (8 * f, 4 * f, 2 * f, f))]
    return {"kernel_a": a, "kernel_b": b}


def unet_model_ops(hw: int = 256, f: int = 64) -> List[Site]:
    """Every conv and upconv of one UNet slice, int8 served."""
    sites = unet_kernel_sites(1, hw, f)
    return sites["kernel_a"] + sites["kernel_b"]


def fastddpm_kernel_sites(n: int, hw: int = 256, b: int = 64
                          ) -> Dict[str, List[Site]]:
    """Kernel A's, B's and K3's sites of one int8_deep denoiser call."""
    h1, h2, h3 = hw // 2, hw // 4, hw // 8
    a = []
    for blk, h, ci, co in (("enc2", h1, 2 * b, 4 * b),
                           ("enc3", h2, 4 * b, 8 * b),
                           ("bottleneck", h3, 8 * b, 8 * b),
                           ("dec3", h2, 12 * b, 4 * b),
                           ("dec2", h1, 6 * b, 2 * b)):
        a += [conv_site(f"{blk}/conv1", n, h, ci, co, 3, 4),
              conv_site(f"{blk}/conv2", n, h, co, co, 3, 4)]
        if ci != co:
            a.append(conv_site(f"{blk}/skip", n, h, ci, co, 1, 4))
    up = [upconv_site("upconv3", n, h3, 8 * b, 4 * b, True),
          upconv_site("upconv2", n, h2, 4 * b, 2 * b, True)]
    k3 = [gn_site(name, n, h, c) for name, h, c in (
        ("enc2/norm1", h1, 2 * b), ("enc2/norm2", h1, 4 * b),
        ("enc3/norm1", h2, 4 * b), ("enc3/norm2", h2, 8 * b),
        ("bottleneck/norm1", h3, 8 * b), ("bottleneck/norm2", h3, 8 * b),
        ("dec3/norm1", h2, 12 * b), ("dec3/norm2", h2, 4 * b),
        ("dec2/norm1", h1, 6 * b), ("dec2/norm2", h1, 2 * b))]
    return {"kernel_a": a, "kernel_b": up, "k3": k3}


def _float_conv(name: str, h: int, ci: int, co: int, k: int) -> Site:
    return (name, 2.0 * h * h * co * k * k * ci, 0.0, PEAK_BF16_FLOPS)


def fastddpm_model_ops(hw: int = 256, b: int = 64, d: int = 128,
                       steps: int = 10) -> List[Site]:
    """Every conv, upconv and dense layer of one served slice: ``steps``
    denoiser calls, the deep sites int8 and the rest bf16."""
    deep = fastddpm_kernel_sites(1, hw, b)
    one = deep["kernel_a"] + deep["kernel_b"]
    one += [_float_conv("init_conv", hw, 3, b, 3),
            _float_conv("enc1/conv1", hw, b, 2 * b, 3),
            _float_conv("enc1/conv2", hw, 2 * b, 2 * b, 3),
            _float_conv("enc1/skip", hw, b, 2 * b, 1),
            _float_conv("upconv1", hw // 2, 2 * b, 4 * b, 1),
            _float_conv("dec1/conv1", hw, 3 * b, b, 3),
            _float_conv("dec1/conv2", hw, b, b, 3),
            _float_conv("dec1/skip", hw, 3 * b, b, 1),
            _float_conv("final_conv", hw, b, 1, 3),
            ("time_mlp", 2.0 * (d * 2 * d * 2 + d * sum(
                (2 * b, 4 * b, 8 * b, 8 * b, 4 * b, 2 * b, b))), 0.0,
             PEAK_BF16_FLOPS)]
    return [(f"step{s}/{name}", ops, nbytes, peak)
            for s in range(steps) for name, ops, nbytes, peak in one]


def ideal_s(sites: List[Site]) -> float:
    """Operations over the peak of their precision, summed."""
    return sum(ops / peak for _, ops, _, peak in sites)


def unet_flops_per_slice(hw: int = 256, f: int = 64,
                         valid_taps: bool = False) -> float:
    """2 x MACs of one UNet slice (convs, upconvs, head).  The sites count
    every tap of a 3x3 conv, the SAME padding's zeros too, as the kernels
    compute them; ``valid_taps`` counts only taps inside the image
    (``3h - 2`` a row and a column of an ``h``-square map)."""
    if not valid_taps:
        return sum(ops for _, ops, _, _ in unet_model_ops(hw, f))
    total = 0.0
    for name, ops, _, _ in unet_model_ops(hw, f):
        if name.startswith(("upconv", "final")):
            total += ops
            continue
        lvl = {"enc1": 0, "enc2": 1, "enc3": 2, "enc4": 3, "bottleneck": 4,
               "dec4": 3, "dec3": 2, "dec2": 1, "dec1": 0}[name.split("/")[0]]
        h = hw >> lvl
        total += ops * (3 * h - 2) ** 2 / (9 * h * h)
    return total
