"""Coded CNN inference under a closed loop: each client sends its next
batch of images the moment the last one's logits are on the host.

The program under test is ``repro_torch``'s compiled network plan run by
its forward entry (``configs/<c>.json`` names both) on the coded backend
the cell names (``benchlib/program.py``), with the configuration's fault
pattern.

A request is timed from the moment it is sent until its logits are on the
host; the window is every request sent in ``seconds`` seconds, closed by
the last one's answer.  A traced run profiles a fixed block of requests
and reduces the profile after the window; its host-clock readings
(latencies, coded runs' walls) leave that block out.  After the window
every request's logits are held to the plain reference's for the same
images."""
from __future__ import annotations

import gc
import time

import torch

from benchlib import program, roofline
from benchlib import traffic as tr
from benchlib.trace import Tracer


class Obs:
    """What the per-layer readers read (``metrics/*.py``)."""

    kind = "cnn"

    def __init__(self, **kw):
        self.__dict__.update(kw)


def conv_work(cfg: dict, ref, plan, batch: int, live: int) -> dict:
    """Least seconds of the conv work one request asks for, by the design:
    a master-run layer once; a coded layer's ``live`` pieces (the n pieces
    less the dead workers', which never compute) of w_out // k output
    columns each, plus the master's remainder columns; and the uncoded
    network's matrix FLOPs (the convolutions and the classifier)."""
    from repro_torch.core.netplan import SegmentStep

    k_of = {}
    for step in plan.steps:
        if isinstance(step, SegmentStep):
            for i in range(step.start, step.stop):
                k_of[i] = step.scheme.k
    least = flops = 0.0
    for i, li in enumerate(ref.conv_layers(cfg)):
        size = li["spatial"] + 2 * cfg["pad"]
        layer = roofline.Conv(batch, li["c_in"], li["c_out"], size, size,
                              cfg["kernel"])
        flops += layer.flops()
        if i not in k_of:
            least += layer.least_s()
            continue
        w_p, rem = roofline.width_split(layer.w_out, k_of[i])
        least += live * roofline.conv_piece(layer, w_p).least_s()
        if rem:
            least += roofline.conv_piece(layer, rem).least_s()
    flops += roofline.gemm_flops(batch, ref.head_features(cfg),
                                 cfg["classes"])
    return {"conv_least_s": least, "model_flops": flops}


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False) -> dict:
    cfg, mix, wl, ref = cell.config, cell.traffic, cell.workload, cell.reference
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
    from repro_torch.core import SystemParams, compile_plan

    layers_of = program.resolve(cfg["program"]["layers"])
    forward = program.resolve(cfg["program"]["forward"])

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = ref.make_params(cfg, gen, dev)
    B, P = int(mix["batch"]), int(mix["distinct_inputs"])
    images = ref.make_inputs(cfg, gen, P * B, dev).view(
        P, B, cfg["channels"], cfg["image"], cfg["image"])
    layers = layers_of(cfg["image"])
    plan = compile_plan(layers, int(cfg["coded"]["workers"]),
                        SystemParams(), cfg["coded"]["scheme"])
    ex = program.backend(cfg, wl["backend"])
    reports: list = []
    ex.on_report = reports.append
    tracer = Tracer(torch, trace)
    tracer.warm()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def request(x):
        with tracer.span("request"):
            t0 = time.perf_counter()
            logits = forward(params, x, plan=plan, executor=ex)
            out = logits.cpu()
            return out, time.perf_counter() - t0

    for j in range(int(wl["warmup_requests"])):
        request(images[j % P])
    sync()
    order = tr.closed_loop_inputs(mix, 1 << 16, seed)
    lo, hi = wl["trace_requests"]
    del reports[:]
    setup_s = time.perf_counter() - t_start

    outs, lat, sent = [], [], []
    profiled = []   # where the profiled requests' reports start and end
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = len(outs)
        if i == lo:
            tracer.start()
            profiled.append(len(reports))
        p = int(order[i])
        o, dt = request(images[p])
        outs.append(o)
        lat.append(dt)
        sent.append(p)
        if i + 1 == hi:
            tracer.stop()
            profiled.append(len(reports))
    t1 = time.perf_counter()
    tracer.collect()
    n_req = len(outs)
    traced = max(0, min(hi, n_req) - lo) if trace else 0
    if trace and profiled:  # host-clock readings of the rest only
        lat = lat[:lo] + lat[hi:]
        del reports[profiled[0]:(profiled + [len(reports)])[1]]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    live = int(cfg["coded"]["workers"]) - len(cfg["coded"]["dead"])
    work = conv_work(cfg, ref, plan, B, live)
    obs = Obs(trace=tracer.data, traced_requests=traced, latencies_s=lat,
              run_walls_s=[r.wall_s for r in reports], dtype=cfg["dtype"],
              **work)

    # the program's state goes before the reference runs
    ex.close()
    del ex, plan, reports
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    limit = float(wl["checks"]["logit_err"])
    checks, bad = check(cfg, ref, params, images, sent, outs, limit)
    extra = ({"control": run_control(cfg, ref, params, images, sent, limit)}
             if control else {})
    return {**extra, "e2e": {"images_per_s": B * n_req / (t1 - t0),
                             "setup_s": setup_s},
            "obs": obs, "correct": judge(checks, bad),
            "attempted": n_req, "failed": bad, "checks": checks,
            "device": {"memory_peak_bytes": int(peak)}}


def judge(checks: list, failed: int) -> bool:
    """``correct``: every answer came, and every number is within its
    limit."""
    return failed == 0 and all(c["value"] <= c["limit"] for c in checks)


def check(cfg, ref, params, images, sent, outs, limit: float
          ) -> tuple[list, int]:
    """Every request's logits against the reference's for its images: the
    widest gap, as a share of the reference's largest logit.  Returns the
    checks and the count of answers of the wrong shape or not finite."""
    refs = {}
    worst, bad = 0.0, 0
    for p, got in zip(sent, outs):
        if p not in refs:
            refs[p] = ref.forward(cfg, params, images[p]).cpu()
        want = refs[p]
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            bad += 1
            continue
        err = float((got - want).abs().max() / want.abs().max())
        worst = max(worst, err)
    return [{"name": "logit_err", "value": worst, "limit": limit}], bad


def run_control(cfg, ref, params, images, sent, limit: float) -> dict:
    """The control: the reference with TF32 operands put in the program's
    place, answering the same requests, judged by ``check`` and ``judge``
    as the program is."""
    ctl = {p: ref.forward(cfg, params, images[p], tf32=True).cpu()
           for p in sorted(set(sent))}
    checks, bad = check(cfg, ref, params, images, sent,
                        [ctl[p] for p in sent], limit)
    return {"checks": checks, "correct": judge(checks, bad)}

