"""Plain PyTorch versions of the hand-written CUDA kernels.

They run on CPU tensors (the kernel wrappers in `kernels.ops` take them
only there) and are what the kernels are held against on the card: the
same function on the same inputs, with no claim to speed."""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.bayes import (FOLD_HEAD, _nig_step, fit_blr_batch,
                                    fold_head)
from repro_torch.kernels.bayes_fit import (check_batch, check_slab,
                                           slab_columns, slab_table)
from repro_torch.kernels.decision_plane import check_cost, cost_corr


def bayes_fit_ref(x: torch.Tensor, y: torch.Tensor,
                  mask: torch.Tensor) -> dict:
    """Batched MacKay evidence fit: the batched `fit_blr` of core.bayes.
    (T, N) float32 x, y, mask -> posterior dict with leaves stacked over T.
    The CUDA kernel, with its closed-form 2x2 algebra, its residual taken
    from float64 moments of the row and its own reduction order, matches
    it at rtol 5e-3 / atol 5e-4 (tests/test_torch_fit_design.py rehearses
    that arithmetic on the CPU)."""
    return fit_blr_batch(x, y, mask)


def _predictive(x, mu0, mu1, s00, s01, s11, beta, x_mu, x_sd, y_mu, y_sd
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float64 predictive of rows given as eleven (Q,) columns, term
    for term the expressions of core.bayes.predict_blr_np (so it is
    bitwise equal to it)."""
    xs = (x - x_mu) / x_sd
    mean_s = mu0 + mu1 * xs
    var_s = 1.0 / beta + s00 + 2.0 * s01 * xs + s11 * xs * xs
    mean = mean_s * y_sd + y_mu
    # numpy.maximum(var_s, 0.0): NaN propagates, -0.0 becomes +0.0
    var_s = torch.where(var_s <= 0.0, 0.0, var_s)
    return mean, _sqrt_rn(var_s) * y_sd


def bayes_predict_ref(batch) -> Optional[torch.Tensor]:
    """Reference batched posterior predictive in float64 over the packed
    queries of `batch` (`kernels.bayes_fit.pack_predict`), with the
    argument and results of `kernels.bayes_fit.bayes_predict`: (Q, 2) mean
    and std interleaved, or, with targets, each query's pair written at
    its destination index in its target (the one whose first query, in the
    slab's table, it reaches last; an index outside the target's rows is
    not written) and None returned."""
    c = slab_columns(check_batch(batch), batch.q)
    mu, sig = c["mu"], c["sigma"]
    mean, std = _predictive(c["x"], mu[:, 0], mu[:, 1], sig[:, 0, 0],
                            sig[:, 0, 1], sig[:, 1, 1], c["beta_prec"],
                            c["x_mu"], c["x_sd"], c["y_mu"], c["y_sd"])
    if not batch.targets:
        return torch.stack([mean, std], dim=1)
    table = slab_table(batch)
    dest = c["dest"]
    owner = torch.searchsorted(table[:, 0].contiguous(),
                               torch.arange(batch.q, device=dest.device),
                               right=True) - 1
    for k, t in enumerate(batch.targets):
        sel = (owner == k) & (dest >= 0) & (dest < table[k, 3])
        t.mean[dest[sel]] = mean[sel]
        t.std[dest[sel]] = std[sel]
    return None


def _sqrt_rn(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 square root of v >= 0 (or NaN).

    On the CPU, torch.sqrt of a float64 tensor goes through MKL's vector
    sqrt, which is off by an ulp on some inputs, so it would break the
    bitwise contract with numpy and with the kernel's IEEE `sqrt`.  The
    complex128 path reaches the C library's csqrt, which returns the
    correctly rounded real sqrt for a non-negative real argument."""
    return torch.sqrt(v.to(torch.complex128)).real


def fused_cost_ref(batch, base: torch.Tensor,
                   z: Optional[float] = None) -> torch.Tensor:
    """The (T, N) float64 HEFT cost matrix of the packed task rows of
    `batch` (`kernels.decision_plane.pack_cost`) and the (T, N) static
    factors `base`, with the arguments and results of
    `kernels.decision_plane.fused_cost`: fc = base * corr (one multiply a
    cell, as `TenantBinding.factor_matrix`), then the predictive, then
    max(mean, 1e-3) * fc, then + z * (std * fc) when z is neither None nor
    0.  Term for term `predict_blr_np`, then `store.compute.scale`, then
    `store.compute.cost_matrix`, so it is bitwise equal to them."""
    c = slab_columns(check_cost(batch, base), batch.t)
    mu, sig = c["mu"], c["sigma"]
    mean, std = _predictive(c["x"], mu[:, 0], mu[:, 1], sig[:, 0, 0],
                            sig[:, 0, 1], sig[:, 1, 1], c["beta_prec"],
                            c["x_mu"], c["x_sd"], c["y_mu"], c["y_sd"])
    f = base * cost_corr(batch)[None, :]
    # numpy.maximum(mean, 1e-3): NaN propagates, -0.0 becomes 1e-3
    mean = torch.where(mean < 1e-3, 1e-3, mean)
    w = mean[:, None] * f
    if z is not None and z != 0.0:
        w = w + z * (std[:, None] * f)
    return w


def nig_fold_ref(slab: torch.Tensor, t: int) -> torch.Tensor:
    """Fold of the T-row ragged slab (`core.bayes.fold_pack`) into the
    (T, FOLD_STATE) folded states, with the arguments and results of
    `kernels.bayes_fit.nig_fold`: term for term `core.bayes._nig_fold_np`
    (the same `_nig_step` expressions, each one IEEE add, multiply or
    divide per element), so it is bitwise equal to it and to the scalar
    `nig_update` chain.  Column k folds every row that holds more than k
    observations; V and prec come back as [0, 0], [0, 1], [1, 1]."""
    check_slab(slab, fold_head(t) + FOLD_HEAD * t, slab.device)
    off = slab[:t + 1].view(torch.int64)
    start = off[:-1]
    hdr = slab[start[:, None] + torch.arange(FOLD_HEAD, device=slab.device)]
    counts = torch.minimum(hdr[:, 0].long(),
                           (off[1:] - start - FOLD_HEAD) // 2)
    mu1, mu2, v11, v12, v22, p11, p12, p22, b = hdr[:, 1:].unbind(1)
    for k in range(int(counts.max()) if t else 0):
        mk = counts > k
        at = torch.where(mk, start + FOLD_HEAD + 2 * k, start)
        xk = torch.where(mk, slab[at], 0.0)
        yk = torch.where(mk, slab[at + 1], 0.0)
        (nmu1, nmu2, nv11, nv12, nv22, np11, np12, np22, nb) = _nig_step(
            mu1, mu2, v11, v12, v22, p11, p12, p22, b, xk, yk)
        # numpy.maximum(nb, 1e-12): NaN propagates
        nb = torch.where(nb < 1e-12, 1e-12, nb)
        mu1 = torch.where(mk, nmu1, mu1)
        mu2 = torch.where(mk, nmu2, mu2)
        v11 = torch.where(mk, nv11, v11)
        v12 = torch.where(mk, nv12, v12)
        v22 = torch.where(mk, nv22, v22)
        p11 = torch.where(mk, np11, p11)
        p12 = torch.where(mk, np12, p12)
        p22 = torch.where(mk, np22, p22)
        b = torch.where(mk, nb, b)
    return torch.stack([mu1, mu2, v11, v12, v22, p11, p12, p22, b], dim=1)


def eft_sweep_ref(W: torch.Tensor, order_arr: torch.Tensor,
                  dep_rows: torch.Tensor, gb8: torch.Tensor,
                  ready0: torch.Tensor, avail: torch.Tensor,
                  same: torch.Tensor, gbps_min: torch.Tensor, *, S: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """One workflow's HEFT insertion sweep, task by task, with the
    arguments and results of `kernels.decision_plane.eft_sweep`.  Works in
    the dtype of W (float64 for the kernel, float32 to hold it against the
    reference's float32 sweep).

    Per-node busy intervals live in (N, S) begin/end stacks padded with
    +inf.  A task's candidate start before interval k is
    max(ready, end[k-1]); the earliest fitting one is its start on that
    node, and the node with the earliest finish wins (first minimum).  The
    interval goes in at the counting-searchsorted position of the
    (begin, end) order.  A masked row (order -1) inserts (inf, inf), a
    no-op on the pads, and writes its results to the dump row T."""
    T, N = W.shape
    f, dev = W.dtype, W.device
    inf = torch.tensor(float("inf"), dtype=f, device=dev)
    has = avail > 0.0
    b0 = torch.full((N, S), float("inf"), dtype=f, device=dev)
    b1 = torch.full((N, S), float("inf"), dtype=f, device=dev)
    b0[:, 0] = torch.where(has, 0.0, inf)
    b1[:, 0] = torch.where(has, avail, inf)
    assign = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    fin = torch.zeros(T + 1, dtype=f, device=dev)
    est_a = torch.zeros(T + 1, dtype=f, device=dev)
    eft_a = torch.zeros(T + 1, dtype=f, device=dev)
    comm = torch.zeros((T + 1, N), dtype=f, device=dev)
    ar = torch.arange(S, device=dev)
    ninf_col = torch.full((N, 1), float("-inf"), dtype=f, device=dev)
    for t in range(T):
        o = order_arr[t].long()
        valid = o >= 0
        i = o.clamp(min=0)
        drows = dep_rows[i].long()
        ds = drows.clamp(0, T)
        dcand = fin[ds][:, None] + comm[ds]                    # (D, N)
        dcand = torch.where((drows >= 0)[:, None], dcand, -inf)
        ready = ready0[i]
        if dcand.shape[0]:
            ready = torch.maximum(ready, dcand.amax(dim=0))
        dur = W[i]
        prev = torch.cat([ninf_col, b1[:, :-1]], dim=1)
        cand = torch.maximum(ready[:, None], prev)
        fits = cand + dur[:, None] <= b0
        est = torch.where(fits, cand, inf).amin(dim=1)
        eft = est + dur
        j = torch.argmin(eft)
        estj, eftj = est[j], eft[j]
        est_ins = torch.where(valid, estj, inf)
        eft_ins = torch.where(valid, eftj, inf)
        b0j, b1j = b0[j], b1[j]
        pos = ((b0j < est_ins).sum()
               + ((b0j == est_ins) & (b1j < eft_ins)).sum())
        b0[j] = torch.where(ar < pos, b0j, torch.where(
            ar == pos, est_ins, torch.roll(b0j, 1)))
        b1[j] = torch.where(ar < pos, b1j, torch.where(
            ar == pos, eft_ins, torch.roll(b1j, 1)))
        iw = torch.where(valid, i, T)
        assign[iw] = j.to(torch.int32)
        fin[iw] = eftj
        est_a[iw] = estj
        eft_a[iw] = eftj
        comm[iw] = torch.where(same[j], 0.0, gb8[i] / gbps_min[j])
    cnt = (b0 < inf).sum(dim=1).to(torch.int32)
    return assign[:T], est_a[:T], eft_a[:T], cnt


def eft_sweep_many_ref(W: Sequence[torch.Tensor], order_arr: torch.Tensor,
                       dep_rows: Sequence[torch.Tensor],
                       gb8: Sequence[torch.Tensor],
                       ready0: Sequence[torch.Tensor],
                       avail: Sequence[torch.Tensor], same: torch.Tensor,
                       gbps_min: torch.Tensor, *, S: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """B workflows' sweeps on one cluster, with the arguments and results
    of `kernels.decision_plane.eft_sweep_many`: `eft_sweep_ref` run lane
    by lane on each lane's operands padded to the common (T, D), T rows of
    order_arr and D the widest dep_rows (zero W, ready0 and gb8 rows, -1
    dependencies).  A lane's steps read only rows its order names, and a
    masked step row 0, so the pad rows are never read."""
    b, t = order_arr.shape
    d = max((x.shape[1] for x in dep_rows), default=0)
    outs = []
    for k in range(b):
        pad = t - W[k].shape[0]
        dk = dep_rows[k]
        dep = torch.full((t, d), -1, dtype=dk.dtype, device=dk.device)
        dep[:dk.shape[0], :dk.shape[1]] = dk
        outs.append(eft_sweep_ref(
            torch.nn.functional.pad(W[k], (0, 0, 0, pad)), order_arr[k], dep,
            torch.nn.functional.pad(gb8[k], (0, pad)),
            torch.nn.functional.pad(ready0[k], (0, 0, 0, pad)), avail[k],
            same, gbps_min, S=S))
    return tuple(torch.stack(x) for x in zip(*outs))


def upward_rank_ref(W: Sequence[torch.Tensor], tables: Sequence
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HEFT's upward ranks of B workflows, with the arguments and results
    of `kernels.decision_plane.upward_rank`: per lane, w_avg =
    W.cumsum(dim=1)[:, -1] / N (a left-to-right sum, then one IEEE
    division; W.sum(1) when N = 0), then the recurrence in reverse topo
    order on Python floats, term for term `_PlanContext.ranks`:
    best = max(best, avg_comm[i] + rank[s]) over the successors from
    best = 0.0, rank[i] = w_avg[i] + best.  -> (rank (B, T) with -inf past
    each lane's rows, bad (B,) int32: 1 where W holds a non-finite
    cell)."""
    b = len(W)
    t = max((w.shape[0] for w in W), default=0)
    dev = W[0].device if b else torch.device("cpu")
    rank = torch.full((b, t), float("-inf"), dtype=torch.float64,
                      device=dev)
    bad = torch.zeros(b, dtype=torch.int32, device=dev)
    for k, (w, tab) in enumerate(zip(W, tables)):
        tk, n = w.shape
        w_avg = (w.cumsum(dim=1)[:, -1] / n if n else w.sum(1)).tolist()
        avg_comm = tab.avg_comm.tolist()
        ptr, idx = tab.succ_ptr.tolist(), tab.succ_idx.tolist()
        r = [0.0] * tk
        for i in range(tk - 1, -1, -1):
            best = 0.0
            for s in idx[ptr[i]:ptr[i + 1]]:
                best = max(best, avg_comm[i] + r[s])
            r[i] = w_avg[i] + best
        rank[k, :tk] = torch.tensor(r, dtype=torch.float64)
        bad[k] = int(not bool(torch.isfinite(w).all()))
    return rank, bad


NEG_INF = -1e30


def band_mask(sq: int, skv: int, causal: bool, window: int,
              device=None) -> torch.Tensor:
    """(sq, skv) bool: query i sees key j when j <= i (causal) and
    j > i - window (window > 0)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' working type: float32, or float64 for float64
    inputs (the CPU tests' gradchecks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scores(q, k, causal, window):
    """Masked scaled scores (B, K, G, Sq, Skv) in the working type, with
    q grouped as (B, Sq, K, G, hd), and the band mask."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    qg = q.to(_acc(q.dtype)).reshape(b, sq, kh, h // kh, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(qg.dtype)) / math.sqrt(hd)
    mask = band_mask(sq, k.shape[1], causal, window, q.device)
    return torch.where(mask, s, NEG_INF), qg, mask


def attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0):
    """`attention_ref`'s output and each row's log-sum-exp of its scaled
    scores, lse (B, H, Sq) in the working type (what the kernel's
    `with_lse` returns)."""
    b, sq, h, _ = q.shape
    s, _, _ = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(s.dtype))
    lse = torch.logsumexp(s, dim=-1).reshape(b, h, sq)
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype), lse


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k (B, Skv, K, hd), v (B, Skv, K, hd_v) with
    H % K == 0: query head h reads kv head h // (H / K), as the JAX
    `ref.attention_ref` repeats the kv heads (here the grouping is a
    reshape, nothing is copied).  Scores scaled by 1 / sqrt(hd) (q's, as
    the reference's `chunked_causal_attention` scales MLA's) and softmax in
    float32 (float64 for float64 inputs), masked entries at -1e30 as in
    the reference; the output (B, Sq, H, hd_v) in q's dtype.  It
    materializes the (Sq, Skv) scores: the plain version, not a path for
    long sequences."""
    return attention_fwd_ref(q, k, v, causal=causal, window=window)[0]


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      *, causal: bool = True, window: int = 0):
    """The gradient of `attention_ref` at (q, k, v), as the backward
    kernel computes it: P = exp(S - lse) on the visible pairs (0
    elsewhere), D = rowsum(dO * O), dS = P (dO V^T - D), dq = dS K / sqrt
    (hd), dk = dS^T Q / sqrt(hd) summed over each kv head's query heads,
    dv = P^T dO likewise; in the working type, returned in the inputs'
    dtypes.  o, do and dv have v's head dim, dq and dk q's."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    s, qg, mask = _scores(q, k, causal, window)
    acc = s.dtype
    lse_g = lse.to(acc).reshape(b, kh, h // kh, sq, 1)
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    og_shape = qg.shape[:-1] + (v.shape[-1],)
    dog = do.to(acc).reshape(og_shape)
    kf, vf = k.to(acc), v.to(acc)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    delta = (dog * o.to(acc).reshape(og_shape)).sum(-1)     # (B, Sq, K, G)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    scale = 1.0 / math.sqrt(hd)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def rglru_scan_ref(a: torch.Tensor, gx: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + gx_t over (B, T, W) float32, from h0 (B, W):
    sequential in time, each step a separately rounded multiply and add,
    the CUDA kernel's order (so the kernel is bitwise equal to it).
    float64 inputs stay float64 (the CPU tests' gradchecks)."""
    h = h0.to(_acc(a.dtype))
    out = torch.empty(a.shape, dtype=h.dtype, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t] * h + gx[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                       g: torch.Tensor):
    """The scan's gradient from its output h and g = dL/dh: walking t
    from T - 1 down, dh_t = g_t + a_{t+1} dh_{t+1} (dh_{T-1} = g_{T-1}),
    da_t = dh_t h_{t-1} (h_{-1} = h0), dgx_t = dh_t; dh0 = a_0 dh_0.  Each
    step a separately rounded multiply and add, the CUDA kernel's order,
    so the kernel is bitwise equal to it -> (da, dgx, dh0)."""
    steps = a.shape[1]
    da, dgx = torch.empty_like(a), torch.empty_like(a)
    dh = torch.zeros_like(h0)
    for t in range(steps - 1, -1, -1):
        dh = g[:, t] if t == steps - 1 else g[:, t] + a[:, t + 1] * dh
        dgx[:, t] = dh
        da[:, t] = dh * (h[:, t - 1] if t > 0 else h0)
    dh0 = a[:, 0] * dh if steps else torch.zeros_like(h0)
    return da, dgx, dh0
