"""CNN workloads from the paper (§V, App. A): VGG16, ResNet18, small CNN.

Three artefacts per network:

* ``*_conv_specs`` — the per-layer :class:`~repro_torch.core.netplan.LayerInfo`
  list (padded-input geometry + activation/pad/pool structure) used by the
  latency model / planner / simulator / segment compiler, with the paper's
  type-1 / type-2 classification (App. A: a layer is type-1 iff
  distributed execution can accelerate it — VGG's early low-intensity
  convs and ResNet's 1x1 downsamples come out type-2).
* an init function building runnable conv + head parameters at any image
  size, from a ``torch.Generator``, on the requested device (default
  ``"cuda"``; absent CUDA raises — pass ``device="cpu"`` to run there).
* a runnable forward whose conv stack executes through a compiled
  :class:`~repro_torch.core.netplan.NetPlan` — coded *segments* with
  one encode at entry and one decode at exit — under any registered coding
  scheme, functionally or on a ``repro_torch.dist`` worker pool.

The type-1 threshold is derived from :class:`SystemParams` (the
compute-to-bandwidth cost ratio), not hard-coded: see :func:`is_type1`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..core.coded_conv import ACTIVATIONS, conv2d, run_segment
from ..core.latency import SystemParams
from ..core.netplan import (LayerInfo, LocalStep, NetPlan, SegmentStep,
                            compile_plan)
from ..core.schemes import CodingScheme, get_scheme
from ..core.splitting import ConvSpec
from ..telemetry.trace import span

__all__ = ["LayerInfo", "vgg16_conv_specs", "resnet18_conv_specs",
           "is_type1", "type1_threshold", "maxpool2d", "forward_plan",
           "init_cnn", "cnn_head_features",
           "init_small_cnn", "small_cnn_forward", "small_cnn_conv_specs",
           "small_cnn_layers", "SMALL_CNN_PARAMS",
           "init_vgg16", "vgg16_forward",
           "init_resnet18", "resnet18_forward"]


# ---------------------------------------------------------------------------
# type-1 / type-2 classification (App. A), threshold derived from params
# ---------------------------------------------------------------------------

def type1_threshold(params: SystemParams | None = None,
                    margin: float = 1.4) -> float:
    """Intensity (FLOP/byte) above which distributing a layer can pay.

    A subtask's round-trip charges its bytes at the per-byte transmission
    cost t_tr = theta_rec + 1/mu_rec and its FLOPs at the per-FLOP worker
    cost t_w = theta_cmp + 1/mu_cmp; distribution can only win when the
    compute a worker absorbs outweighs the transfer it adds, i.e. when
    FLOPs/byte exceeds t_tr / t_w — times a ``margin`` of headroom for
    the encode/decode GEMMs and the k-th-order-statistic inflation the
    ratio alone does not see.  Under the default ``SystemParams`` this
    evaluates to exactly the 200.0 FLOP/B the classification was
    previously hard-coded to (margin 1.4 x the 142.9 cost ratio), and it
    keeps VGG16's conv1 and ResNet18's 1x1 downsamples type-2 (App. A) —
    pinned by tests/test_netplan.py.
    """
    p = params if params is not None else SystemParams()
    t_tr = p.theta_rec + 1.0 / p.mu_rec
    t_w = p.theta_cmp + 1.0 / p.mu_cmp
    return margin * t_tr / t_w


def is_type1(spec: ConvSpec, params: SystemParams | None = None,
             min_intensity: float | None = None) -> bool:
    """Type-1 iff compute dominates transfer enough for distribution to pay.

    Intensity = subtask FLOPs per transferred byte at k=1, compared to
    :func:`type1_threshold` derived from ``params`` (``min_intensity``
    overrides the derived threshold for callers that pin one explicitly).
    """
    thresh = (min_intensity if min_intensity is not None
              else type1_threshold(params))
    flops = spec.subtask_flops(spec.w_out)
    bytes_ = spec.recv_bytes(spec.w_in) + spec.send_bytes(spec.w_out)
    return flops / bytes_ > thresh


# ---------------------------------------------------------------------------
# network definitions
# ---------------------------------------------------------------------------

def _spec(c_in, c_out, size, kernel=3, stride=1, pad=1) -> ConvSpec:
    return ConvSpec(c_in=c_in, c_out=c_out, h_in=size + 2 * pad,
                    w_in=size + 2 * pad, kernel=kernel, stride=stride)


def vgg16_conv_specs(image: int = 224,
                     params: SystemParams | None = None) -> List[LayerInfo]:
    cfg = [  # (name, c_in, c_out, spatial, pool after)
        ("conv1_1", 3, 64, image, 0), ("conv1_2", 64, 64, image, 2),
        ("conv2_1", 64, 128, image // 2, 0), ("conv2_2", 128, 128, image // 2, 2),
        ("conv3_1", 128, 256, image // 4, 0), ("conv3_2", 256, 256, image // 4, 0),
        ("conv3_3", 256, 256, image // 4, 2),
        ("conv4_1", 256, 512, image // 8, 0), ("conv4_2", 512, 512, image // 8, 0),
        ("conv4_3", 512, 512, image // 8, 2),
        ("conv5_1", 512, 512, image // 16, 0), ("conv5_2", 512, 512, image // 16, 0),
        ("conv5_3", 512, 512, image // 16, 2),
    ]
    out = []
    for name, ci, co, s, pool in cfg:
        spec = _spec(ci, co, s)
        out.append(LayerInfo(name, spec, is_type1(spec, params),
                             act="relu", pad=1, pool=pool))
    return out


def resnet18_conv_specs(image: int = 224,
                        params: SystemParams | None = None) -> List[LayerInfo]:
    out: List[LayerInfo] = []

    def add(name, ci, co, size, kernel=3, stride=1, pad=1, act="relu",
            pool=0, barrier=False):
        spec = ConvSpec(c_in=ci, c_out=co, h_in=size + 2 * pad,
                        w_in=size + 2 * pad, kernel=kernel, stride=stride)
        out.append(LayerInfo(name, spec, is_type1(spec, params), act=act,
                             pad=pad, pool=pool, barrier=barrier))

    # the stem pools, each block's second conv and every 1x1 downsample
    # end at a structural join (residual add): barrier stops the segment
    # compiler from fusing across what the flat layer list cannot express
    add("conv1", 3, 64, image, kernel=7, stride=2, pad=3, pool=2)
    s = image // 4  # after stride-2 conv + pool
    for b in range(2):  # layer1: 64 -> 64
        add(f"l1b{b}c1", 64, 64, s)
        add(f"l1b{b}c2", 64, 64, s, act=None, barrier=True)
    add("l2b0c1", 64, 128, s, stride=2)
    add("l2ds", 64, 128, s, kernel=1, stride=2, pad=0, act=None, barrier=True)
    s //= 2
    add("l2b0c2", 128, 128, s, act=None, barrier=True)
    add("l2b1c1", 128, 128, s)
    add("l2b1c2", 128, 128, s, act=None, barrier=True)
    add("l3b0c1", 128, 256, s, stride=2)
    add("l3ds", 128, 256, s, kernel=1, stride=2, pad=0, act=None, barrier=True)
    s //= 2
    add("l3b0c2", 256, 256, s, act=None, barrier=True)
    add("l3b1c1", 256, 256, s)
    add("l3b1c2", 256, 256, s, act=None, barrier=True)
    add("l4b0c1", 256, 512, s, stride=2)
    add("l4ds", 256, 512, s, kernel=1, stride=2, pad=0, act=None, barrier=True)
    s //= 2
    add("l4b0c2", 512, 512, s, act=None, barrier=True)
    add("l4b1c1", 512, 512, s)
    add("l4b1c2", 512, 512, s, act=None, barrier=True)
    return out


# ---------------------------------------------------------------------------
# runnable execution: a compiled NetPlan walked over real arrays
# ---------------------------------------------------------------------------

def maxpool2d(x: torch.Tensor, window: int, stride: int | None = None) -> torch.Tensor:
    """VALID max-pool over H and W (NCHW)."""
    stride = stride or window
    # floor mode, no padding: the reference's VALID reduce_window
    return F.max_pool2d(x, window, stride)


def _pad_hw(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return F.pad(x, (pad, pad, pad, pad))  # last dim first: W, then H


def _finish_layer(y: torch.Tensor, li: LayerInfo) -> torch.Tensor:
    if li.act is not None:
        y = ACTIVATIONS[li.act](y)
    if li.pool:
        y = maxpool2d(y, li.pool)
    return y


def forward_plan(plan: NetPlan, convs: Sequence[torch.Tensor], x: torch.Tensor,
                 *, subset=None, executor=None,
                 assignment=None) -> torch.Tensor:
    """Run a conv stack through its compiled plan.

    Segments execute ``run_segment`` (one encode, resident chains, one
    decode; interior activations inside the chains); the master applies
    each segment's final activation and pooling post-decode, and runs
    LocalStep layers itself, each of these a ``repro.cnn.layer`` span.
    ``convs[i]`` is layer i's OIHW weight.
    """
    for step in plan.steps:
        sub = plan.layers[step.start:step.stop]
        ws = [convs[i] for i in range(step.start, step.stop)]
        if isinstance(step, SegmentStep):
            y = run_segment(
                _pad_hw(x, sub[0].pad), ws, step.scheme,
                [li.spec for li in sub], [li.pad for li in sub],
                [li.act for li in sub], split=step.split, subset=subset,
                executor=executor, assignment=assignment)
            with span("cnn.layer"):
                x = _finish_layer(y, sub[-1])
        else:
            for li, w in zip(sub, ws):
                with span("cnn.layer"):
                    x = _finish_layer(conv2d(_pad_hw(x, li.pad), w,
                                             li.spec.stride), li)
    return x


def cnn_head_features(layers: Sequence[LayerInfo]) -> int:
    """Flattened feature count after the last conv layer (+ pools)."""
    h = w = None
    for li in layers:
        h, w = li.spec.h_out, li.spec.w_out
        if li.pool:
            h, w = h // li.pool, w // li.pool
    return layers[-1].spec.c_out * h * w


def init_cnn(gen: torch.Generator, layers: Sequence[LayerInfo],
             n_classes: int = 10, *,
             device: str | torch.device = "cuda") -> dict:
    """He-init conv weights + a linear head for any LayerInfo stack.

    Numbers are drawn from ``gen`` on the generator's own device and moved
    to ``device``; they are deterministic in the generator's seed and are
    not the reference's random bits (parity tests convert the reference's
    parameters through ``repro_torch.convert`` instead).
    """
    dev = resolve_device(device)

    def normal(shape) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=torch.float32).to(dev)

    convs = []
    for li in layers:
        s = li.spec
        w = normal((s.c_out, s.c_in, s.kernel, s.kernel))
        convs.append(w * (2.0 / (s.c_in * s.kernel ** 2)) ** 0.5)
    feat = cnn_head_features(layers)
    head = normal((feat, n_classes)) * feat ** -0.5
    return {"convs": convs, "head": head}


@functools.lru_cache(maxsize=256)
def _compile_cached(layers: tuple, n: int, params: SystemParams,
                    scheme: str | None,
                    fixed: CodingScheme | None) -> NetPlan:
    """Every argument is a frozen dataclass / str, so repeated forwards of
    the same network (the serving loop, the per-block ResNet branches)
    reuse one compiled plan instead of re-running the cut DP per call."""
    if fixed is not None:
        return compile_plan(layers, n, params, fixed_scheme=fixed)
    return compile_plan(layers, n, params, scheme)


def _resolve_plan(layers: Sequence[LayerInfo], plan: NetPlan | None,
                  scheme, code: CodingScheme | None, n: int | None,
                  sys_params: SystemParams | None) -> NetPlan | None:
    """Shared forward-entry logic: an explicit plan wins; otherwise compile
    (and memoize) one from (scheme | code instance, n, params); None means
    run locally."""
    if plan is not None:
        return plan
    if code is None and scheme is None:
        return None
    params = sys_params if sys_params is not None else SystemParams()
    if code is not None:
        return _compile_cached(tuple(layers), code.n, params, None, code)
    if not isinstance(scheme, str):  # a scheme instance pins (n, k)
        return _compile_cached(tuple(layers), scheme.n, params, None, scheme)
    if n is None:
        raise ValueError("scheme given by name needs n= (worker count)")
    get_scheme(scheme)  # fail fast on unknown names
    return _compile_cached(tuple(layers), n, params, scheme, None)


# ---------------------------------------------------------------------------
# small runnable CNN (end-to-end coded inference at toy size)
# ---------------------------------------------------------------------------

_SMALL = [  # (c_in, c_out, stride) — VGG-ish, image 32
    (3, 32, 1), (32, 32, 1), (32, 64, 2), (64, 64, 1),
]

# The small CNN models an edge-LAN testbed (slow CPU compute, ~4 Gbps
# local link) rather than the paper's Pi-over-WiFi scale: its layers are
# only a few MFLOP, so under the WiFi-scale default SystemParams every
# one is type-2 and nothing would distribute.  Derived threshold: 2.0
# FLOP/B, which classifies all four layers type-1 — the same
# classification the old hard-coded min_intensity=10.0 produced.
SMALL_CNN_PARAMS = SystemParams(
    mu_cmp=2e8, theta_cmp=2e-9,     # ~0.14 GFLOP/s effective edge CPU
    mu_rec=5e8, theta_rec=8e-9,     # ~ 4 Gbps LAN
    mu_sen=5e8, theta_sen=8e-9,
)


def small_cnn_layers(image: int = 32,
                     params: SystemParams | None = None) -> List[LayerInfo]:
    params = params if params is not None else SMALL_CNN_PARAMS
    out, s = [], image
    for i, (ci, co, st) in enumerate(_SMALL):
        spec = ConvSpec(c_in=ci, c_out=co, h_in=s + 2, w_in=s + 2,
                        kernel=3, stride=st)
        out.append(LayerInfo(f"conv{i + 1}", spec, is_type1(spec, params),
                             act="relu", pad=1))
        s = s // st
    return out


def small_cnn_conv_specs(image: int = 32) -> List[ConvSpec]:
    return [li.spec for li in small_cnn_layers(image)]


def init_small_cnn(gen: torch.Generator, n_classes: int = 10,
                   image: int = 32, *,
                   device: str | torch.device = "cuda") -> dict:
    return init_cnn(gen, small_cnn_layers(image), n_classes, device=device)


def small_cnn_forward(
    params: dict,
    x: torch.Tensor,
    code: CodingScheme | None = None,
    subset=None,
    *,
    scheme: str | CodingScheme | None = None,
    n: int | None = None,
    sys_params: SystemParams | None = None,
    plan: NetPlan | None = None,
    executor=None,
) -> torch.Tensor:
    """Forward pass through the compiled segment plan.

    ``code`` (kept for compatibility) pins one scheme instance — any
    registered :class:`CodingScheme`, not just MDS — for every segment;
    ``scheme``/``n`` compile a per-segment (n, k°) plan instead; ``plan``
    supplies a precompiled :class:`NetPlan` (the serving path compiles
    once and reuses).  No coding arguments -> plain local inference.
    ``subset`` (default: each scheme's ``default_subset``) picks the
    worker outputs decode consumes, emulating stragglers.
    """
    layers = small_cnn_layers(image=x.shape[-1],
                              params=sys_params or SMALL_CNN_PARAMS)
    plan = _resolve_plan(layers, plan, scheme, code, n,
                         sys_params or SMALL_CNN_PARAMS)
    if plan is None:
        h = x
        for li, w in zip(layers, params["convs"]):
            h = _finish_layer(conv2d(_pad_hw(h, li.pad), w, li.spec.stride),
                              li)
    else:
        h = forward_plan(plan, params["convs"], x, subset=subset,
                         executor=executor)
    h = h.reshape(h.shape[0], -1)
    return h @ params["head"]


# ---------------------------------------------------------------------------
# runnable VGG16 / ResNet18
# ---------------------------------------------------------------------------

def init_vgg16(gen: torch.Generator, n_classes: int = 10, image: int = 32,
               *, device: str | torch.device = "cuda") -> dict:
    return init_cnn(gen, vgg16_conv_specs(image), n_classes, device=device)


def vgg16_forward(
    params: dict,
    x: torch.Tensor,
    code: CodingScheme | None = None,
    subset=None,
    *,
    scheme: str | CodingScheme | None = None,
    n: int | None = None,
    sys_params: SystemParams | None = None,
    plan: NetPlan | None = None,
    executor=None,
) -> torch.Tensor:
    """Runnable VGG16: 13-conv stack through the compiled segment plan
    (master-run layers are ``repro.cnn.layer`` spans), then the classifier
    (``repro.cnn.head``)."""
    layers = vgg16_conv_specs(image=x.shape[-1], params=sys_params)
    plan = _resolve_plan(layers, plan, scheme, code, n, sys_params)
    if plan is None:
        h = x
        for li, w in zip(layers, params["convs"]):
            with span("cnn.layer"):
                h = _finish_layer(conv2d(_pad_hw(h, li.pad), w,
                                         li.spec.stride), li)
    else:
        h = forward_plan(plan, params["convs"], x, subset=subset,
                         executor=executor)
    with span("cnn.head"):
        return h.reshape(h.shape[0], -1) @ params["head"]


def init_resnet18(gen: torch.Generator, n_classes: int = 10,
                  image: int = 64, *,
                  device: str | torch.device = "cuda") -> dict:
    return init_cnn(gen, resnet18_conv_specs(image), n_classes, device=device)


def _resnet_blocks(layers: Sequence[LayerInfo]):
    """(c1_idx, c2_idx, ds_idx | None) triples of the 8 basic blocks."""
    blocks, i = [], 1
    while i < len(layers):
        if layers[i + 1].name.endswith("ds"):
            blocks.append((i, i + 2, i + 1))
            i += 3
        else:
            blocks.append((i, i + 1, None))
            i += 2
    return blocks


def resnet18_forward(
    params: dict,
    x: torch.Tensor,
    code: CodingScheme | None = None,
    subset=None,
    *,
    scheme: str | CodingScheme | None = None,
    n: int | None = None,
    sys_params: SystemParams | None = None,
    executor=None,
) -> torch.Tensor:
    """Runnable ResNet18 (basic blocks, bias/BN-free convs).

    Each residual branch's conv pair compiles as its own mini plan — the
    c1 -> c2 boundary carries a relu, so it fuses into one depth-2 segment
    under selection schemes and stays per-layer under linear mixes; the
    skip add and the following relu are master-side joins (barriers).
    """
    layers = resnet18_conv_specs(image=x.shape[-1], params=sys_params)
    convs = params["convs"]

    def branch(idxs: Sequence[int], h: torch.Tensor) -> torch.Tensor:
        sub = [layers[i] for i in idxs]
        pln = _resolve_plan(sub, None, scheme, code, n, sys_params)
        if pln is None:
            for li, w in zip(sub, (convs[i] for i in idxs)):
                h = _finish_layer(conv2d(_pad_hw(h, li.pad), w,
                                         li.spec.stride), li)
            return h
        return forward_plan(pln, {i: convs[j] for i, j in enumerate(idxs)},
                            h, subset=subset, executor=executor)

    h = _finish_layer(conv2d(_pad_hw(x, layers[0].pad), convs[0],
                             layers[0].spec.stride), layers[0])
    for c1, c2, ds in _resnet_blocks(layers):
        skip = h if ds is None else conv2d(_pad_hw(h, layers[ds].pad),
                                           convs[ds], layers[ds].spec.stride)
        h = F.relu(branch((c1, c2), h) + skip)
    h = h.reshape(h.shape[0], -1)
    return h @ params["head"]
