"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory with true hidden-state recurrence), the
counterpart of the JAX package's `models/xlstm.py`.

mLSTM cell (per head, exponential gating with m-stabilizer):
    i_t = exp(itilde_t), f_t = exp(ftilde_t)
    C_t = f_t C_{t-1} + i_t v_t k_t^T
    n_t = f_t n_{t-1} + i_t k_t
    h_t = o_t * (C_t q_t / max(|n_t . q_t|, 1))

Two forms of one cell, as in the reference: the recurrent form
(`mlstm_impl='scan'`, its stabilizer m starting at 0) and the
chunkwise-parallel form (`'chunked'`, m starting at -1e30), which detaches
its two running maxima where the reference stops their gradients.
sLSTM has recurrent gate connections R h_{t-1} (inherently sequential):
a Python loop over `_slstm_step`, which is what the reference's
`lax.scan` is in eager PyTorch.  Neither block launches a hand-written
kernel; the reference has no Pallas kernel on this path either.

The loops take their per-step operands from `unbind`, whose backward
stacks the steps' gradients once, where indexing `x[:, t]` would make a
full-size zero gradient a step; sLSTM's recurrent weight is laid out for
the batched product once a sequence (`_rec_weight`), where an einsum
would copy it, and autograd keep the copy, at every step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, pdtype, rmsnorm, rmsnorm_init

_F32 = torch.float32


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_init(gen, cfg: ModelConfig, device="cpu") -> dict:
    d = cfg.d_model
    pd = int(d * cfg.mlstm_proj_factor)
    nh = cfg.num_heads
    dt = pdtype(cfg)
    return {
        "w_up": dense_init(gen, (d, pd), dt, device=device),
        "w_up_gate": dense_init(gen, (d, pd), dt, device=device),
        "wqkv": dense_init(gen, (3, pd, pd), dt, fan_in=pd, device=device),
        "w_if": dense_init(gen, (pd, 2 * nh), _F32, fan_in=pd,
                           device=device),
        "bias": torch.cat([torch.zeros(nh, dtype=_F32, device=device),
                           torch.linspace(3.0, 6.0, nh, dtype=_F32,
                                          device=device)]),  # i, f biases
        "conv1d": dense_init(gen, (cfg.conv_width, pd), dt,
                             fan_in=cfg.conv_width, device=device),
        "w_down_x": dense_init(gen, (pd, d), dt, fan_in=pd, device=device),
        "out_norm": rmsnorm_init(pd, device),
    }


def _conv_seq(w, x):
    """causal depthwise conv via shifted adds (zero left padding)."""
    cw = w.shape[0]
    s = x.shape[1]
    y = torch.zeros_like(x)
    for j in range(cw):
        shift = cw - 1 - j
        xs = F.pad(x, (0, 0, shift, 0))[:, :s]
        y = y + xs * w[j]
    return y


def _mlstm_qkv(p, cfg: ModelConfig, xm, conv_fn):
    nh = cfg.num_heads
    pd = xm.shape[-1]
    dh = pd // nh
    xc = F.silu(conv_fn(xm))
    q = xc @ p["wqkv"][0]
    k = xc @ p["wqkv"][1] * (dh ** -0.5)
    v = xm @ p["wqkv"][2]                      # from the un-convolved xm
    gates = xc.float() @ p["w_if"] + p["bias"]
    i_t, f_t = gates[..., :nh], gates[..., nh:]                  # log-gates

    def heads(z):
        return z.reshape(z.shape[:-1] + (nh, dh))
    return heads(q), heads(k), heads(v), i_t, F.logsigmoid(f_t)


def _mlstm_scan(q, k, v, log_i, log_f):
    """Recurrent (paper-faithful) form.  q,k,v: (B,S,H,dh); gates (B,S,H)
    -> (h (B,S,H,dh) float32, the final (C, n, m))."""
    b, s, h, dh = q.shape
    qf, kf, vf = (z.float() for z in (q, k, v))
    c = torch.zeros((b, h, dh, dh), dtype=_F32, device=q.device)
    n = torch.zeros((b, h, dh), dtype=_F32, device=q.device)
    m = torch.zeros((b, h), dtype=_F32, device=q.device)
    hs = []
    for qt, kt, vt, li, lf in zip(qf.unbind(1), kf.unbind(1), vf.unbind(1),
                                  log_i.unbind(1), log_f.unbind(1)):
        m_new = torch.maximum(lf + m, li)
        i_p = torch.exp(li - m_new)
        f_p = torch.exp(lf + m - m_new)
        c = f_p[..., None, None] * c + i_p[..., None, None] * (
            vt[..., None, :] * kt[..., :, None])                 # (B,H,dh,dh)
        n = f_p[..., None] * n + i_p[..., None] * kt
        num = torch.einsum("bhkv,bhk->bhv", c, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, 1), (c, n, m)


def _mlstm_chunked(q, k, v, log_i, log_f, chunk: int):
    """Chunkwise-parallel mLSTM (linear-attention style): O(S*chunk) intra
    matmuls + an inter-chunk state scan.  Beyond-paper perf variant.  S is
    a multiple of `chunk`: mlstm_apply_seq calls it only then."""
    b, s, h, dh = q.shape
    nc = s // chunk
    qf = q.float().reshape(b, nc, chunk, h, dh)
    kf = k.float().reshape(b, nc, chunk, h, dh)
    vf = v.float().reshape(b, nc, chunk, h, dh)
    li = log_i.reshape(b, nc, chunk, h)
    lf = log_f.reshape(b, nc, chunk, h)
    csum_f = torch.cumsum(lf, dim=2)                              # (B,N,L,H)
    total_f = csum_f[:, :, -1]                                    # (B,N,H)

    # ---- inter-chunk state recursion (scan over chunks) ----
    # decay from position j to end of chunk: total_f - csum_f
    decay_to_end = total_f[:, :, None] - csum_f                   # (B,N,L,H)
    g = li + decay_to_end                                         # log weight
    m_chunk = torch.amax(g, dim=2).detach()                       # (B,N,H)
    w_loc = torch.exp(g - m_chunk[:, :, None])                    # (B,N,L,H)
    # the reference's three-operand einsum "bnlh,bnlhk,bnlhv->bnhkv" as two
    # products (weight k, then contract with v over l), so that no
    # (B,N,L,H,dh,dh) intermediate is formed
    c_loc = torch.einsum("bnlhk,bnlhv->bnhkv", w_loc[..., None] * kf, vf)
    n_loc = torch.einsum("bnlh,bnlhk->bnhk", w_loc, kf)

    c = torch.zeros((b, h, dh, dh), dtype=_F32, device=q.device)
    n = torch.zeros((b, h, dh), dtype=_F32, device=q.device)
    m = torch.full((b, h), -1e30, dtype=_F32, device=q.device)
    # the state before each chunk
    c_prev, n_prev, m_prev = [], [], []
    for c_l, n_l, m_l, tf in zip(c_loc.unbind(1), n_loc.unbind(1),
                                 m_chunk.unbind(1), total_f.unbind(1)):
        c_prev.append(c)
        n_prev.append(n)
        m_prev.append(m)
        m_new = torch.maximum(m + tf, m_l)
        sc_prev = torch.exp(m + tf - m_new)
        sc_loc = torch.exp(m_l - m_new)
        c = sc_prev[..., None, None] * c + sc_loc[..., None, None] * c_l
        n = sc_prev[..., None] * n + sc_loc[..., None] * n_l
        m = m_new
    c_prev = torch.stack(c_prev, 1)                               # (B,N,H,dh,dh)
    n_prev = torch.stack(n_prev, 1)
    m_prev = torch.stack(m_prev, 1)

    # ---- intra-chunk (quadratic within chunk) + inter contribution ----
    # state before token j inside the chunk = prev_state * exp(csum_f_j)
    d_q = csum_f                                                  # (B,N,L,H)
    m_q = m_prev[:, :, None] + d_q               # log scale of prev state at j
    # intra pair weight from token t (source) to j (dest), t<=j:
    # w = exp(li_t + csum_f_j - csum_f_t)
    g_src = li - csum_f                                           # (B,N,L,H)
    m_intra = torch.amax(g_src, dim=2, keepdim=True).detach()     # (B,N,1,H)
    m_tot = torch.maximum(m_q, m_intra + d_q)                     # (B,N,L,H)
    # inter contribution
    sc_inter = torch.exp(m_q - m_tot)                             # (B,N,L,H)
    num_inter = torch.einsum("bnhkv,bnlhk->bnlhv", c_prev, qf) \
        * sc_inter[..., None]
    den_inter = torch.einsum("bnhk,bnlhk->bnlh", n_prev, qf) * sc_inter
    # intra contribution
    w_src = torch.exp(g_src - m_intra)                            # (B,N,L,H)
    sc_intra = torch.exp(m_intra + d_q - m_tot)                   # (B,N,L,H)
    scores = torch.einsum("bnlhk,bnthk->bnlth", qf, kf)           # (B,N,L,T,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=_F32, device=q.device))
    wmat = scores * w_src[:, :, None] * tri[None, None, :, :, None]
    num_intra = torch.einsum("bnlth,bnthv->bnlhv", wmat, vf) \
        * sc_intra[..., None]
    den_intra = wmat.sum(3) * sc_intra
    num = num_inter + num_intra
    den = den_inter + den_intra
    den = torch.maximum(torch.abs(den), torch.exp(-m_tot))
    out = (num / den[..., None]).reshape(b, s, h, dh)
    return out, (c, n, m)


def mlstm_apply_seq(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    make_cache: bool = False):
    """x: (B, S, d) -> (out, cache or None).  The chunked form runs when
    the config asks for it and S is a multiple of the chunk longer than
    one chunk; the recurrent form otherwise."""
    s = x.shape[1]
    xm = x @ p["w_up"]
    xg = x @ p["w_up_gate"]
    q, k, v, li, lf = _mlstm_qkv(p, cfg, xm,
                                 lambda z: _conv_seq(p["conv1d"], z))
    if cfg.mlstm_impl == "chunked" and s % cfg.mlstm_chunk == 0 \
            and s > cfg.mlstm_chunk:
        h, (c_f, n_f, m_f) = _mlstm_chunked(q, k, v, li, lf, cfg.mlstm_chunk)
    else:
        h, (c_f, n_f, m_f) = _mlstm_scan(q, k, v, li, lf)
    h = h.reshape(x.shape[0], s, -1).to(x.dtype)
    h = rmsnorm(p["out_norm"], h, cfg.norm_eps)
    out = (h * F.silu(xg)) @ p["w_down_x"]
    cache = None
    if make_cache:
        cw = cfg.conv_width
        # a copy, so that the cache does not hold the (B, S, pd) tensor
        conv_state = F.pad(xm, (0, 0, cw - 1, 0))[:, -(cw - 1):].clone()
        cache = {"mc": c_f, "mn": n_f, "mm": m_f, "conv_m": conv_state}
    return out, cache


def mlstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                 pos: int):
    """One-step decode.  x (B, 1, d); cache {'mc' (B,H,dh,dh), 'mn'
    (B,H,dh), 'mm' (B,H) float32, 'conv_m' (B, cw-1, pd)}."""
    nh = cfg.num_heads
    xm = (x @ p["w_up"])[:, 0]                                   # (B, pd)
    xg = (x @ p["w_up_gate"])[:, 0]
    conv = cache["conv_m"]
    cw = p["conv1d"].shape[0]
    # the reference's order: the new row's term first, then the window's
    xc = xm * p["conv1d"][cw - 1]
    for j in range(cw - 1):
        xc = xc + conv[:, j] * p["conv1d"][j]
    xc = F.silu(xc)
    pd = xm.shape[-1]
    dh = pd // nh
    q = (xc @ p["wqkv"][0]).reshape(-1, nh, dh).float()
    k = ((xc @ p["wqkv"][1]) * (dh ** -0.5)).reshape(-1, nh, dh).float()
    v = (xm @ p["wqkv"][2]).reshape(-1, nh, dh).float()
    gates = xc.float() @ p["w_if"] + p["bias"]
    li, lf = gates[..., :nh], F.logsigmoid(gates[..., nh:])
    c, n, m = cache["mc"], cache["mn"], cache["mm"]
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + m - m_new)
    c = f_p[..., None, None] * c + i_p[..., None, None] * (
        v[..., None, :] * k[..., :, None])
    n = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", c, q)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, q)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(x.shape[0], -1).to(x.dtype)
    h = rmsnorm(p["out_norm"], h, cfg.norm_eps)
    out = ((h * F.silu(xg)) @ p["w_down_x"])[:, None]
    new_conv = torch.cat([conv[:, 1:], xm[:, None]], dim=1)
    return out, {"mc": c, "mn": n, "mm": m_new, "conv_m": new_conv}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_init(gen, cfg: ModelConfig, device="cpu") -> dict:
    d = cfg.d_model
    nh = cfg.num_heads
    dh = d // nh
    pf = int(d * cfg.slstm_proj_factor)
    dt = pdtype(cfg)
    return {
        "w_slstm": dense_init(gen, (d, 4 * d), _F32, device=device),  # z,i,f,o
        "w_rec": dense_init(gen, (4, nh, dh, dh), _F32, fan_in=dh,
                            device=device),
        "bias": torch.cat([torch.zeros(2 * d, dtype=_F32, device=device),
                           torch.full((d,), 4.0, dtype=_F32, device=device),
                           torch.zeros(d, dtype=_F32, device=device)]),
        "w_up": dense_init(gen, (d, pf), dt, device=device),
        "w_down_x": dense_init(gen, (pf, d), dt, fan_in=pf, device=device),
        "out_norm": rmsnorm_init(d, device),
    }


def _rec_weight(w_rec: torch.Tensor) -> torch.Tensor:
    """w_rec (4, nh, dh, dh) as (nh, dh, 4 dh), the layout of the
    recurrent product's batched matmul over heads."""
    g, nh, dh, _ = w_rec.shape
    return w_rec.permute(1, 2, 0, 3).reshape(nh, dh, g * dh)


def _by_gate(z: torch.Tensor) -> torch.Tensor:
    """(..., 4d) pre-activations (z, i, f, o) -> (4, ..., d)."""
    return z.unflatten(-1, (4, -1)).movedim(-2, 0)


def _slstm_step(cfg: ModelConfig, carry, xt, w_rec, bias):
    """xt: (4, B, d) pre-activations from input (`_by_gate`); carry: (c,
    n, h, m) each (B, d) float32; w_rec: `_rec_weight(p["w_rec"])`; bias:
    p["bias"] as (4, 1, d)."""
    c, n, h, m = carry
    b, d = c.shape
    nh = cfg.num_heads
    dh = d // nh
    hh = h.reshape(b, nh, dh).transpose(0, 1)                    # (nh, B, dh)
    # the reference's einsum "bhk,ghkj->gbhj", as out[h, b, (g, j)]
    rec = torch.bmm(hh, w_rec).reshape(nh, b, 4, dh).permute(2, 1, 0, 3) \
        .reshape(4, b, d)
    z_pre, li, f_pre, o_pre = (xt + rec + bias).unbind(0)       # li: log input
    z = torch.tanh(z_pre)
    lf = F.logsigmoid(f_pre)                                     # log forget
    o = torch.sigmoid(o_pre)
    lf_m = lf + m
    m_new = torch.maximum(lf_m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf_m - m_new)
    c = f_p * c + i_p * z
    n = torch.maximum(f_p * n + i_p, torch.exp(-m_new))
    h_new = o * (c / n)
    return (c, n, h_new, m_new), h_new


def slstm_apply_seq(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    make_cache: bool = False):
    """x: (B, S, d) -> (out, cache or None); the four states start at
    zeros."""
    b, s, d = x.shape
    pre = _by_gate(x.float() @ p["w_slstm"])                     # (4,B,S,d)
    carry = tuple(torch.zeros((b, d), dtype=_F32, device=x.device)
                  for _ in range(4))
    w_rec = _rec_weight(p["w_rec"])
    bias = p["bias"].reshape(4, 1, d)
    hs = []
    for xt in pre.unbind(2):
        carry, ht = _slstm_step(cfg, carry, xt, w_rec, bias)
        hs.append(ht)
    h = torch.stack(hs, 1).to(x.dtype)                           # (B,S,d)
    h = rmsnorm(p["out_norm"], h, cfg.norm_eps)
    out = F.gelu(h @ p["w_up"], approximate="tanh") @ p["w_down_x"]
    cache = {"sc": carry[0], "sn": carry[1], "sh": carry[2],
             "sm": carry[3]} if make_cache else None
    return out, cache


def slstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                 pos: int):
    pre = x[:, 0].float() @ p["w_slstm"]
    carry = (cache["sc"], cache["sn"], cache["sh"], cache["sm"])
    carry, h = _slstm_step(cfg, carry, _by_gate(pre),
                           _rec_weight(p["w_rec"]),
                           p["bias"].reshape(4, 1, -1))
    h = rmsnorm(p["out_norm"], h.to(x.dtype), cfg.norm_eps)
    out = (F.gelu(h @ p["w_up"], approximate="tanh") @ p["w_down_x"])[:, None]
    return out, {"sc": carry[0], "sn": carry[1], "sh": carry[2],
                 "sm": carry[3]}
