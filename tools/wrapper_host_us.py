#!/usr/bin/env python3
"""Host microseconds a launch of kernels A and B through their Python
wrappers, at every site of one full-width int8_fused UNet forward (batch 8).

    python3 tools/wrapper_host_us.py [--root DIR] [--label NAME]

DIR (default: this checkout) is a checkout whose ``mrisr_tpu_torch`` package
is timed; the sites, the inputs and the timing loop (``host_us``: 50 launches
enqueued without a synchronize) are those of this checkout's chip_smoke.py.
Each site keeps the least of 20 such means: the host is shared, and other
work only ever adds to a launch's time.  Two versions of the wrappers
compare in one run on one card when the script runs once for each, in
turns.  Needs one CUDA card.  Prints the card
and one JSON line: {"label", "root", "sites": [{"kernel", "site",
"host_us"}], "forward_host_us"} (the sum over the forward's 23 launches).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPEATS = 20  # host_us rounds a site; the least is kept


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def least_host_us(cs, fn) -> float:
    return min(cs.host_us(fn) for _ in range(REPEATS))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout holding the mrisr_tpu_torch to time")
    ap.add_argument("--label", default="", help="name printed with the result")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import mrisr_tpu_torch
    from mrisr_tpu_torch.ops.conv_int8 import conv2d_int8, pack_conv
    from mrisr_tpu_torch.ops.upconv import pack_upconv, upconv2x2_int8

    pkg = os.path.dirname(os.path.abspath(mrisr_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"mrisr_tpu_torch came from {pkg}, not {root}")
    if not torch.cuda.is_available():
        print("wrapper_host_us: no CUDA card", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    print(f"card: {cs.card_line()}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def uniform(n, lo, hi):
        return torch.rand(n, generator=g, device=dev) * (hi - lo) + lo

    sites = []
    for name, h, ci, co, k, out_float in cs.conv_sites():
        x = codes((cs.BATCH, h, h, ci))
        wp = pack_conv(codes((k, k, ci, co)))
        s = uniform(co, 0.3, 2.3) * 60 / (127 * 127 / 3 * (k * k * ci) ** 0.5)
        b = uniform(co, -2, 2)
        us = least_host_us(cs, lambda: conv2d_int8(
            x, wp, s, b, relu=not out_float, out_float=out_float))
        sites.append({"kernel": "conv_int8", "site": name, "host_us": us})
    for name, h, c, co in cs.upconv_sites():
        x = codes((cs.BATCH, h, h, c))
        skip = codes((cs.BATCH, 2 * h, 2 * h, co))
        w2, s4, b4 = pack_upconv(codes((2, 2, c, co)), uniform(co, 0.03, 0.23),
                                 uniform(co, -10, 10))
        us = least_host_us(cs, lambda: upconv2x2_int8(x, w2, s4, b4,
                                                      skip=skip))
        sites.append({"kernel": "upconv_int8", "site": name, "host_us": us})
    for r in sites:
        print(f"{r['kernel']:12s} {r['site']:20s} host {r['host_us']:.2f} us")
    print(json.dumps({"label": args.label, "root": root, "sites": sites,
                      "forward_host_us": sum(r["host_us"] for r in sites)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
