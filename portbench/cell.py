"""One run of one serving cell: set-up, warm-up, the measured window, the
per-layer readings, the check against the plain reference."""

from __future__ import annotations

import dataclasses
import gc
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench import core
from portbench.reference.phantom import pair_pool

WARM_BATCHES = 2
PROFILER_SETTLE_S = 0.5


def _engine_counters(engine) -> Dict[str, float]:
    return dataclasses.asdict(engine.stats)


def _instrument(engine, spans: core.Spans, trace: bool, rows,
                fault: Optional[Callable], card: List):
    """The benchmark's own spans around the engine's calls into the
    forward (``apply``), its batch assembly and its resolution; on the
    card, a pair of CUDA events around each forward on the engine's stream,
    with its host start and its requests (``card``); the rows of each
    batch where answers depend on them; a planted fault (tests)."""
    apply = fault(engine._apply) if fault is not None else engine._apply
    on_card = engine.device.type == "cuda"
    served = [0]  # requests of the batch last collected

    def timed_apply(x):
        t = time.perf_counter()
        if on_card:
            # on the engine's stream, after the batch's upload
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        try:
            return apply(x)
        finally:
            if on_card:
                ev[1].record()
                card.append((t, served[0], *ev))
            spans.add("apply", t, time.perf_counter())

    engine._apply = timed_apply
    collect = engine._collect

    def tracked_collect(buf):
        t = time.perf_counter()
        batch = collect(buf)
        served[0] = len(batch) if batch else 0
        if trace:
            spans.add("engine.collect", t, time.perf_counter())
        if batch and rows is not None:
            for k, p in enumerate(batch):
                rows[id(p.future)] = k
        return batch

    engine._collect = tracked_collect
    if trace:
        resolve = engine._resolve

        def timed_resolve(pending):
            t = time.perf_counter()
            try:
                return resolve(pending)
            finally:
                spans.add("engine.resolve", t, time.perf_counter())

        engine._resolve = timed_resolve


def run_cell(bench: Dict[str, Any], name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_process: float, *,
             config_overrides: Optional[Dict] = None,
             traffic_overrides: Optional[Dict] = None,
             fault: Optional[Callable] = None,
             control_bits: Optional[int] = None,
             log=lambda s: print(s, file=sys.stderr, flush=True)
             ) -> Dict[str, Any]:
    """Run cell ``name``; returns the fields of the result line, the gap
    readings of the program's answers (``readings``) and, with
    ``control_bits``, of the reference served at that precision in their
    place (``control``)."""
    spec = core.cell(bench, name)
    cfg = core.merged(core.data_file("configs", spec["config"]),
                      config_overrides)
    traffic = core.merged(core.data_file("traffic", spec["traffic"]),
                          traffic_overrides)
    fam = core.module("families", cfg["family"])
    loop = core.module("loops", traffic["loop"])
    if hasattr(loop, "run_cell"):  # a loop with a flow of its own
        return loop.run_cell(bench, name, cfg, traffic, fam, seed, seconds,
                             trace, device, t_process, fault=fault,
                             control_bits=control_bits, log=log)
    eng_cfg = traffic["engine"]
    batch = int(eng_cfg["batch_size"])
    check = cfg["check"]

    pool = pair_pool(seed, int(traffic["pool_volumes"]),
                     int(cfg["volume"]["slices"]), int(cfg["image_size"]),
                     int(traffic.get("pair_gap", 2)))
    w = fam.weights(cfg, seed, device)
    calib = core.calibration(cfg, pool, seed)
    spans = core.Spans()
    rows = {} if fam.needs_rows else None
    counters: Dict[str, Dict[str, float]] = {}
    prof_box: List = []
    card: List = []
    profile_s = float(traffic.get("profile_s", 3.0))

    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        engine = fam.build(cfg, w, calib, workdir, device, eng_cfg)
        try:
            _instrument(engine, spans, trace, rows, fault, card)
            flat = pool.reshape(-1, *pool.shape[2:])
            engine.predict_many([flat[i % len(flat)]
                                 for i in range(WARM_BATCHES * batch)])

            def window(t0: float, t1: float) -> None:
                counters["start"] = _engine_counters(engine)
                if trace:
                    at = t0 + max(0.0, (t1 - t0 - profile_s) / 2)
                    time.sleep(max(0.0, at - time.perf_counter()))
                    # the engine's counters and the rate are read over the
                    # stretch before the profiler starts, which stalls the
                    # process while it starts
                    counters["end"] = _engine_counters(engine)
                    prof_box.append((time.perf_counter(),
                                     *_profile(profile_s, device)))
                time.sleep(max(0.0, t1 - time.perf_counter()))
                counters.setdefault("end", _engine_counters(engine))

            out = loop.run(engine, pool, traffic, seed, seconds, window,
                           int(check["sample"]), rows)
        finally:
            engine.close()
    t0, t1 = out.window
    setup_s = t0 - t_process
    # every forward has resolved once the engine has closed
    card_ms = _card_ms_per_slice(card, t0, t1)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for line in out.lines:
        log(line)
    if out.marks and traffic["loop"] == "closed":
        log("rate by 2 s of the window: " + " ".join(
            _stretch_rates(out.marks, t0, t1, 2.0)))

    profile, rate = None, out.rate
    if prof_box:
        asked, prof, h0, h1 = prof_box[0]
        profile = core.summarize(prof, h0, h1, spans)
        rate = _unprofiled_rate(out, asked, h1)
        for what, lo, hi in (("before", t0, asked), ("during", h0, h1),
                             ("after", h1 + PROFILER_SETTLE_S, t1)):
            try:
                a, b, n = core.batch_edges(out.marks, lo, hi)
                log(f"rate {what} the profile: {n / (b - a):.2f} slices/s")
            except ValueError:
                pass
    dist, norms = fam.compare(cfg, w, out.samples, pool, device, batch, calib)
    stat = check.get("statistic", "worst_med")
    readings = core.gap_readings(dist, norms) if dist else {}
    number = readings.get(stat, float("inf"))
    control = (core.gap_readings(*fam.compare(
        cfg, w, out.samples, pool, device, batch, calib, bits=control_bits))
        if control_bits and dist else None)
    limit = float(check["limit"])
    correct = (out.failed == 0 and len(dist) >= int(check["sample"])
               and core.passes(number, limit))
    checks = {f"{fam.NUMBER}.{stat}": (number, limit),
              "failed_requests": (float(out.failed), 0.0),
              "samples_short": (float(max(0, int(check["sample"])
                                          - len(dist))), 0.0)}

    ctx = core.Context(
        cell=name, config=cfg, traffic=traffic, rate=rate,
        engine={k: counters["end"][k] - counters["start"][k]
                for k in counters.get("end", {})},
        spans=spans, window=(t0, t1), profile=profile,
        sites=fam.sites(cfg, batch), slice_ideal_s=fam.slice_ideal_s(cfg),
        card_ms_per_slice=card_ms)
    e2e = dict(out.metrics)
    if card_ms is not None:
        e2e["card_ms_per_slice"] = (card_ms, "ms")
    metrics: Dict[str, Any] = {}
    for m in core.cell_metrics(bench, name, trace):
        if trace:
            v = core.reader(m["name"]).read(ctx)
        elif m["name"] == "setup_s":
            v = setup_s
        else:
            v = e2e.get(m["name"], (None,))[0]
        if v is not None:
            metrics[m["name"]] = (float(v), m["unit"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace and ctx.profile is not None:
        dev["busy_s"] = ctx.profile.busy_s
        dev["window_s"] = ctx.profile.window_s
        breakdown = {"device_ops": ctx.profile.top_ops(),
                     "idle_gaps": ctx.profile.top_gaps}
    return {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": dev,
            "checks": checks, "breakdown": breakdown, "readings": readings,
            "control": control,
            "control_correct": (core.passes(control[stat], limit)
                                if control else None),
            "setup_s": setup_s, "loop": out}


def _profile(seconds: float, device):
    """``torch.profiler`` over ``seconds`` of the running window, the
    device's activity only (the host's spans are the benchmark's own);
    kept in memory and read once the window has closed.  Returns
    ``(profiler, host start, host end)``."""
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CUDA] if device.type == "cuda"
            else [ProfilerActivity.CPU])
    with profile(activities=acts) as prof:
        h0 = time.perf_counter()
        time.sleep(seconds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        h1 = time.perf_counter()
    return prof, h0, h1


def _card_ms_per_slice(card: List, t0: float, t1: float
                       ) -> Optional[float]:
    """The card's milliseconds a served slice: the device time between
    the events around each forward that the engine started in the window,
    over those forwards' requests."""
    ms, n = 0.0, 0
    for t, served, start, end in card:
        if t0 <= t < t1:
            ms += start.elapsed_time(end)
            n += served
    return ms / n if n else None


def _stretch_rates(marks, t0: float, t1: float, step: float):
    out, a = [], t0
    while a + step <= t1 + 1e-9:
        try:
            lo, hi, n = core.batch_edges(marks, a, a + step)
            out.append(f"{n / (hi - lo):.0f}")
        except ValueError:
            out.append("-")
        a += step
    return out


def _unprofiled_rate(out, asked: float, h1: float) -> Optional[float]:
    """The slices resolved a second over the longer stretch of the window
    that the profiler left alone (it stalls the process while it starts
    and slows the host while it runs and stops)."""
    t0, t1 = out.window
    after = h1 + PROFILER_SETTLE_S
    lo, hi = (t0, asked) if asked - t0 > t1 - after else (after, t1)
    try:
        start, end, n = core.batch_edges(out.marks, lo, hi)
    except ValueError:
        return None
    return n / (end - start)
