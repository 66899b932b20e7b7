"""The plain reference of Granite-4.0-H-Small as
``configs/granite-4.0-h-small.json`` states it, this device's share of
the experts held, in float32 with TF32 off, by ``torch`` alone: no cache,
no batching, no coding and no kernel of the program.  It imports torch and
nothing else.

    x = 12 * E[tokens]                                   E: (100352, 4096), tied
    for i in 0..39:   mixer_i = attention if i in {5, 15, 25, 35} else Mamba2
        h = x + 0.22 * mixer_i(RMSNorm(x))
            Mamba2: in_proj -> (z, xBC, dt); causal depthwise conv 4 (+bias), SiLU on xBC;
                    dt = softplus(dt + dt_bias); A = -exp(A_log); SSD over 128 heads x 64,
                    state 128, one B/C group; y + D * x; RMSNorm(y * SiLU(z)); out_proj
            attention: q (32 x 128), k, v (8 x 128), no positions, causal,
                    softmax(q k^T * 0.0078125) v, o-proj; no biases
        u = RMSNorm(h)
        s = u W_router (4096 x 72, f32);  (v, e) = top10(s);  g = softmax(v)   over the 10
        routed(u) = sum_{j : e_j held} g_j W2[e_j] (SiLU(u W1a[e_j]) * u W1b[e_j])   width 768
        shared(u) = W2s (SiLU(u W1as) * u W1bs)                                     width 1536
        x = h + 0.22 * (routed(u) + shared(u))
    logits = RMSNorm(x) E^T / 16

RMSNorm has eps 1e-5 and, as in the port, the scale (1 + w) with w drawn
as zeros; W1a is the port's ``w_gate``, W1b its ``w_in``, W2 its
``w_out``.  The held experts are the first ``model["experts_held"]``;
the gates are not renormalised over them (the devices that hold the
others add their slots).  The SSD is the
recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t, in
its chunked dual form.

``make_params`` is how a run makes the weights on the card from its seed,
in the layout the port's model reads; the program and this reference are
handed the same tensors.  The weights are bf16 and each layer's are cast
to f32 only while that layer runs (the whole model in f32 would not fit
beside the program's).  ``fp8`` is the control: the same reference with
every matrix weight rounded to float8 e4m3 (one scale a tensor).
``forward(..., ties=[])`` appends, per call, how many (token, layer)
routings had their 10th and 11th scores within ``TIE`` of each other: a
near tie that rounding may break the other way in the program."""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

CHUNK = 64          # the reference's own SSD chunk length
Q_BLOCK = 1024      # query rows an attention block takes at a time
GEN_CHUNK = 1 << 27  # normal draws a call while making the weights
TIE = 1e-3          # scores this close may route either way: the input
                    # rounded to bf16 (2^-9) moves a unit score ~1e-3


def dims(m: dict) -> dict:
    D = m["d_model"]
    di = m["ssm_expand"] * D
    N = m["ssm_state"]
    H = di // m["ssm_head_dim"]
    hd = m.get("head_dim") or D // m["n_heads"]
    return {"D": D, "di": di, "N": N, "H": H, "P": m["ssm_head_dim"],
            "conv_dim": di + 2 * N, "in_proj": 2 * di + 2 * N + H,
            "W": m["ssm_conv"], "Ha": m["n_heads"], "K": m["n_kv_heads"],
            "hd": hd, "F": m["d_ff"], "Fs": m["shared_d_ff"],
            "E": m["n_experts"], "Eh": m["experts_held"],
            "V": m["vocab"], "Vp": -(-m["vocab"] // 256) * 256}


def layout(m: dict, embed_std: float | None = None) -> dict:
    """The parameter tree: each leaf (kind, shape, fan_in, dtype name); a
    normal leaf's standard deviation is fan_in ** -0.5, the embedding's
    ``embed_std`` when given."""
    d = dims(m)
    embed_fan_in = d["D"] if embed_std is None else embed_std ** -2
    w = m["dtype"]
    f32 = "float32"
    D, Eh, Fe, Fs = d["D"], d["Eh"], d["F"], d["Fs"]

    def mamba():
        return {
            "in_proj": ("normal", (D, d["in_proj"]), D, w),
            "conv_w": ("normal", (d["conv_dim"], d["W"]), d["W"], w),
            "conv_b": ("zeros", (d["conv_dim"],), 0, w),
            "A_log": ("a_log", (d["H"],), 0, f32),
            "D": ("ones", (d["H"],), 0, f32),
            "dt_bias": ("dt_bias", (d["H"],), 0, f32),
            "gate_norm": ("zeros", (d["di"],), 0, f32),
            "out_proj": ("normal", (d["di"], D), d["di"], w),
        }

    def attn():
        return {"wq": ("normal", (D, d["Ha"], d["hd"]), D, w),
                "wk": ("normal", (D, d["K"], d["hd"]), D, w),
                "wv": ("normal", (D, d["K"], d["hd"]), D, w),
                "wo": ("normal", (d["Ha"], d["hd"], D), d["Ha"] * d["hd"], w)}

    layers = []
    for kind in m["layer_types"]:
        layer = ({"norm": ("zeros", (D,), 0, f32), "mamba": mamba()}
                 if kind == "mamba" else
                 {"attn_norm": ("zeros", (D,), 0, f32), "attn": attn()})
        layer["ffn_norm"] = ("zeros", (D,), 0, f32)
        layer["moe"] = {"router": ("normal", (D, d["E"]), D, f32),
                        "w_in": ("normal", (Eh, D, Fe), D, w),
                        "w_gate": ("normal", (Eh, D, Fe), D, w),
                        "w_out": ("normal", (Eh, Fe, D), Fe, w)}
        layer["shared"] = {"w_in": ("normal", (D, Fs), D, w),
                           "w_out": ("normal", (Fs, D), Fs, w),
                           "w_gate": ("normal", (D, Fs), D, w)}
        layers.append(layer)
    return {"layers": layers,
            "final_norm": ("zeros", (D,), 0, f32),
            "embed": ("normal", (d["Vp"], D), embed_fan_in, w)}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _put(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def make_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """The weights on ``device``, the normal draws made on ``gen``'s device
    in calls of up to ``GEN_CHUNK`` values and cut into the matrices."""
    m = cfg["model"]
    spec = layout(m, cfg.get("embed_std"))
    out = _skeleton(spec)
    normal = [(p, s) for p, s in _leaves(spec) if s[0] == "normal"]
    sizes = [math.prod(s[1]) for _, s in normal]
    left = sum(sizes)
    buf, pos = None, 0
    for (path, (_, shape, fan_in, dt)), n in zip(normal, sizes):
        if buf is None or pos + n > buf.numel():
            buf = torch.randn(max(n, min(GEN_CHUNK, left)), generator=gen,
                              device=gen.device, dtype=torch.float32)
            pos = 0
        w = buf[pos:pos + n].view(shape).mul_(fan_in ** -0.5)
        pos += n
        left -= n
        _put(out, path, w.to(device=device, dtype=getattr(torch, dt)))
    H = dims(m)["H"]
    for path, (kind, shape, _, dt) in _leaves(spec):
        dtype = getattr(torch, dt)
        if kind == "zeros":
            _put(out, path, torch.zeros(shape, dtype=dtype, device=device))
        elif kind == "ones":
            _put(out, path, torch.ones(shape, dtype=dtype, device=device))
        elif kind == "a_log":
            _put(out, path, torch.log(torch.linspace(
                1.0, 16.0, H, dtype=dtype, device=device)))
        elif kind == "dt_bias":
            _put(out, path, torch.full(shape, math.log(math.expm1(1e-2)),
                                       dtype=dtype, device=device))
    return out


# ---------------------------------------------------------------------------
# the forward pass, float32
# ---------------------------------------------------------------------------

def fp8(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one scale (its largest magnitude
    to 448), back in float32: the control's precision."""
    w = w.float()
    s = w.abs().max().clamp(min=1e-12) / 448.0
    return (w / s).to(torch.float8_e4m3fn).float() * s


@contextlib.contextmanager
def tf32_off():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
        1.0 + scale.float())


def ssd(x, dt, A, Bm, Cm):
    """x (B, T, H, P), dt (B, T, H), A (H,), Bm / Cm (B, T, N) -> y
    (B, T, H, P): the recurrence in its chunked dual form."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    L = CHUNK
    pad = -T % L
    if pad:  # dt = 0 steps: no decay, no input
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in (x, dt, Bm, Cm))
    c = x.shape[1] // L
    X = (x * dt[..., None]).view(Bsz, c, L, H, P)
    a = (dt * A).view(Bsz, c, L, H).permute(0, 3, 1, 2)      # (B, H, c, L)
    Bc = Bm.view(Bsz, c, L, N)
    Cc = Cm.view(Bsz, c, L, N)
    cum = torch.cumsum(a, dim=-1)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    seg = cum[..., :, None] - cum[..., None, :]              # (B, H, c, L, S)
    decay = torch.where(causal, torch.exp(seg.masked_fill(~causal, 0.0)),
                        torch.zeros((), device=x.device))
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y = torch.einsum("bcls,bhcls,bcshp->bclhp", CB, decay, X)
    # the state each chunk hands on, then the states entering each chunk
    to_end = torch.exp(cum[..., -1:] - cum)                  # (B, H, c, L)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, to_end, X)
    h = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    entering = []
    total = torch.exp(cum[..., -1])                          # (B, H, c)
    for i in range(c):
        entering.append(h)
        h = h * total[:, :, i, None, None] + states[:, i]
    h_in = torch.stack(entering, dim=1)                      # (B, c, H, P, N)
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, h_in, torch.exp(cum))
    return y.reshape(Bsz, c * L, H, P)[:, :T]


def mamba(p, x, d, q):
    Bsz, T, _ = x.shape
    zxbcdt = x @ q(p["in_proj"])
    di, N, C = d["di"], d["N"], d["conv_dim"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + C]
    dt_raw = zxbcdt[..., di + C:]
    w = p["conv_w"].float()
    W = w.shape[-1]
    padded = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(padded[:, k:k + T] * w[:, k] for k in range(W))
    xbc = F.silu(conv + p["conv_b"].float())
    xs = xbc[..., :di].reshape(Bsz, T, d["H"], d["P"])
    Bm = xbc[..., di:di + N]
    Cm = xbc[..., di + N:]
    dt = F.softplus(dt_raw + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y = ssd(xs, dt, A, Bm, Cm) + p["D"].float()[:, None] * xs
    y = y.reshape(Bsz, T, di) * F.silu(z)
    return rms_norm(y, p["gate_norm"], d["eps"]) @ q(p["out_proj"])


def attention(p, x, d, scale, q):
    """Causal GQA attention with no positional encoding."""
    Bsz, T, D = x.shape
    Ha, K, hd = d["Ha"], d["K"], d["hd"]
    qh = (x @ q(p["wq"]).reshape(D, Ha * hd)).view(Bsz, T, Ha, hd)
    kh = (x @ q(p["wk"]).reshape(D, K * hd)).view(Bsz, T, K, hd)
    vh = (x @ q(p["wv"]).reshape(D, K * hd)).view(Bsz, T, K, hd)
    kh = kh.repeat_interleave(Ha // K, dim=2)
    vh = vh.repeat_interleave(Ha // K, dim=2)
    out = torch.empty_like(qh)
    keys = torch.arange(T, device=x.device)
    for t0 in range(0, T, Q_BLOCK):
        t1 = min(T, t0 + Q_BLOCK)
        s = torch.einsum("bthp,bshp->bhts", qh[:, t0:t1], kh[:, :t1]) * scale
        mask = keys[None, :t1] <= torch.arange(t0, t1, device=x.device)[:, None]
        s = s.masked_fill(~mask, float("-inf"))
        out[:, t0:t1] = torch.einsum("bhts,bshp->bthp", torch.softmax(s, -1),
                                     vh[:, :t1])
    return out.reshape(Bsz, T, Ha * hd) @ q(p["wo"]).reshape(Ha * hd, D)


def ffn(p, x, q):
    return (F.silu(x @ q(p["w_gate"])) * (x @ q(p["w_in"]))) @ q(p["w_out"])


def routed(p, u, m, q, ties=None):
    """The held experts' part of the routed mixture of ``u`` (B, T, D)."""
    D = u.shape[-1]
    flat = u.reshape(-1, D)
    s = flat @ p["router"].float()
    top, eid = torch.topk(s, m["top_k"] + 1, dim=-1)
    if ties is not None:
        ties[-1] += int((top[:, -2] - top[:, -1] < TIE).sum())
    top, eid = top[:, :-1], eid[:, :-1]
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(flat)
    for j in range(m["experts_held"]):
        tok, slot = torch.nonzero(eid == j, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = flat[tok]
        he = F.silu(xe @ q(p["w_gate"][j])) * (xe @ q(p["w_in"][j]))
        out.index_add_(0, tok, gates[tok, slot, None] * (he @ q(p["w_out"][j])))
    return out.view(u.shape)


@torch.no_grad()
def forward(cfg: dict, params: dict, tokens: torch.Tensor, *,
            last: int | None = None, quant: bool = False,
            ties: list | None = None) -> torch.Tensor:
    """Logits (B, T', vocab) in float32 of ``tokens`` (B, T): every
    position, or the ``last`` ones only.  ``quant=True`` is the control
    (float8 e4m3 matrix weights).  ``ties``: see the module's docstring."""
    m = cfg["model"]
    d = dict(dims(m), eps=float(cfg["rms_norm_eps"]))
    q = fp8 if quant else (lambda w: w.float())
    rs = float(m["residual_scale"])
    if ties is not None:
        ties.append(0)
    with tf32_off():
        emb = q(params["embed"])
        x = emb[tokens.long()] * float(m["embed_scale"])
        for kind, layer in zip(m["layer_types"], params["layers"]):
            if kind == "mamba":
                a = mamba(layer["mamba"], rms_norm(x, layer["norm"], d["eps"]),
                          d, q)
            else:
                a = attention(layer["attn"],
                              rms_norm(x, layer["attn_norm"], d["eps"]), d,
                              float(m["attn_scale"]), q)
            h = x + rs * a
            u = rms_norm(h, layer["ffn_norm"], d["eps"])
            x = h + rs * (routed(layer["moe"], u, m, q, ties)
                          + ffn(layer["shared"], u, q))
        if last is not None:
            x = x[:, -last:]
        x = rms_norm(x, params["final_norm"], d["eps"])
        return (x @ emb[: d["V"]].T) / float(m["logits_scale"])
