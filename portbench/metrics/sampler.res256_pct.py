"""sampler: the share of the sampler's card time spent at the full-size
level of the DDPM UNet: the device time of the port's ``ddpm.level`` spans
whose ``res`` is the image's height (256) over that of the
``sampler.step`` span around them, the median over the steps recorded
whole in the profiled sub-window, as ``program_spans.device_share`` takes
it, the other levels' spans left out.  Moves ``served_slices_per_s``.
None where the port records no such spans."""

import statistics

from portbench import program_spans

MOVES = "served_slices_per_s"
OUTER, INNER = "sampler.step", "ddpm.level"


def read(ctx):
    res = int(ctx.config["image_size"])
    spans = program_spans.recorded(ctx)
    by_key = {s.key: s for s in spans}
    tops = {s.key: s.device_ms for s in spans
            if s.name == OUTER and s.device_ms}
    if not tops:
        return None
    part = dict.fromkeys(tops, 0.0)
    for s in spans:
        if s.name != INNER or s.ids.get("res") != res or s.device_ms is None:
            continue
        up = by_key.get(s.parent)
        while up is not None and up.key not in tops:
            up = by_key.get(up.parent)
        if up is not None:
            part[up.key] += s.device_ms
    if not any(part.values()):
        return None
    return statistics.median(100.0 * part[k] / ms for k, ms in tops.items())
