"""The quantizer's test cases, shared by its CPU tests
(``test_torch_port_quantize.py``) and its card tests
(``test_torch_port_cuda.py``): the quantizer sites of both Fast-DDPM
networks' int8_deep forward, and inputs at its rounding and saturation
edges; and kernel E's sites in the three networks' int8_deep forward
(``test_torch_port_bias_residual.py`` and the card tests).  Imports
neither jax nor mrisr_tpu, as the card tests must not."""

import torch

from mrisr_tpu_torch.models.ddpm_unet import CH_MULT, attn_levels, level_plan


def quant_sites(net, ch, hw):
    """(name, H, C) of each quantizer call in one int8_deep denoiser call
    of the notebook net (base ``ch``) or the DDPM UNet (``ch``) on
    ``hw``^2 maps: every int8 conv input that K3 does not emit (a skip or
    nin_shortcut reads its block's input, an upconv, an upsample's conv,
    whose codes are taken before the nearest-2x repeat, an attention
    block's proj_out).  6 sites a notebook call, 27 a DDPM UNet call."""
    if net == "notebook":
        return [("enc2/skip", hw // 2, 2 * ch), ("enc3/skip", hw // 4, 4 * ch),
                ("upconv3", hw // 8, 8 * ch), ("dec3/skip", hw // 4, 12 * ch),
                ("upconv2", hw // 4, 4 * ch), ("dec2/skip", hw // 2, 6 * ch)]
    plan, sites = level_plan(ch), []
    for part in ("down", "up"):
        for i, j, ci, co in plan[part]:
            if i > 0 and ci != co:
                sites.append((f"{part}/{i}/block/{j}/nin_shortcut", hw >> i,
                              ci))
            if i in attn_levels():
                sites.append((f"{part}/{i}/attn/{j}/proj_out", hw >> i, co))
    last = len(CH_MULT) - 1
    sites.append(("mid/attn_1/proj_out", hw >> last, plan["mid"]))
    sites += [(f"up/{i}/upsample/conv", hw >> i, ch * CH_MULT[i])
              for i in range(2, last + 1)]
    return sites


def quant_edge_values(a, dtype):
    """Inputs whose int8 codes at scale ``a`` test the quantizer's rounding,
    in ``dtype`` on the CPU: x / a at every integer and tie k + 0.5 from
    -131 to 130.5, their neighbours one unit in the last place either side
    (near-ties, where a multiply by 1 / a in place of the division moves
    codes), the +-127 saturation edges, +-inf and +-0."""
    k = torch.arange(-131, 131, dtype=torch.float64)
    grid = torch.cat([k, k + 0.5]) * a
    x = grid[grid != 0].to(dtype)
    bits = x.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    edges = torch.tensor([126.5, 127.0, 127.49, 127.5, 128.0, 1e6],
                         dtype=torch.float64) * a
    return torch.cat([x, (bits + 1).view(dtype), (bits - 1).view(dtype),
                      edges.to(dtype), (-edges).to(dtype),
                      torch.tensor([float("inf"), float("-inf"), 0.0, -0.0],
                                   dtype=dtype)])



def bias_sites(net):
    """Kernel E's calls in one int8_deep denoiser call on the card
    (``FastDDPMForward`` with 'fused'), in order: (the float conv whose
    bias it adds, the float shortcut conv whose bias it adds too or None,
    whether it takes a residual).  ``net``: 'notebook', 'ddpm' (the DDPM
    UNet) or 'adm'.  4, 12 and 13 calls, of which 2, 5 and 6 take a
    residual; the names do not depend on the widths."""
    if net == "notebook":
        return [("init_conv", None, False),
                ("enc1/conv2", "enc1/skip", True),
                ("upconv1", None, False),
                ("dec1/conv2", "dec1/skip", True)]
    if net == "ddpm":
        last = len(CH_MULT) - 1
        return ([("conv_in", None, False)]
                + [(f"down/0/block/{j}/conv2", None, True) for j in (0, 1)]
                + [(f"down/{i}/downsample/conv", None, False)
                   for i in range(last)]
                + [("up/1/upsample/conv", None, False)]
                + [(f"up/0/block/{j}/conv2", f"up/0/block/{j}/nin_shortcut",
                    True) for j in (0, 1, 2)])
    sites = [("input_blocks/0/0", None, False)]
    for k in (1, 2):  # the two ResBlocks of the full-size level
        sites += [(f"input_blocks/{k}/0/in_layers/2", None, False),
                  (f"input_blocks/{k}/0/out_layers/3", None, True)]
    # the up-ResBlock into the full-size level (no skip), then that level's
    # three ResBlocks, each reading a concatenation (a 1x1 skip)
    sites += [("output_blocks/14/1/in_layers/2", None, False),
              ("output_blocks/14/1/out_layers/3", None, True)]
    for k in (15, 16, 17):
        sites += [(f"output_blocks/{k}/0/in_layers/2", None, False),
                  (f"output_blocks/{k}/0/out_layers/3",
                   f"output_blocks/{k}/0/skip_connection", True)]
    return sites
