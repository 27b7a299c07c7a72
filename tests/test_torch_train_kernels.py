"""The backward kernels' plain versions and the port's autograd Functions,
on the CPU.

`kernels.ops.flash_attention` and `kernels.ops.rglru_scan` differentiate
through `torch.autograd.Function`s whose backward is the CUDA kernel on a
card and `ref.attention_bwd_ref` / `ref.rglru_scan_bwd_ref` on the CPU;
the kernels are held against those plain versions on the card
(chip_smoke.py, phase_train_kernels).  Here the plain versions are held:

  * against torch autograd of the plain forward, by `gradcheck` in float64
    at tiny shapes (GQA group 3, a window, not causal, odd S, an MQA group
    of 4), whose own tolerances are float64's;
  * against the JAX package's gradient of the function its model
    differentiates (`chunked_causal_attention` on head-expanded k and v,
    the associative scan `ref.rglru_scan_ref`), float32 at rtol 2e-5 /
    atol 2e-5 (the kernels' float32 tolerance: the two packages sum in
    other orders);
  * the lse the forward saves against the JAX logsumexp of the masked
    scores (rtol 1e-6 / atol 1e-5, float32).

No test here needs the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as scan

TOL = dict(rtol=2e-5, atol=2e-5)

# (B, S, H, K, hd, causal, window)
CASES = [
    (1, 7, 3, 1, 4, True, 0),          # MQA group 3, odd S
    (2, 9, 6, 2, 4, True, 3),          # GQA group 3, a window
    (1, 6, 4, 4, 4, False, 0),         # MHA, not causal
    (1, 8, 4, 1, 4, False, 3),         # not causal, a window
    (2, 5, 4, 1, 8, True, 2),          # MQA group 4, a window
]


def _qkv(seed, b, s, h, kh, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd))]
    return [torch.from_numpy(a).to(dtype) for a in arrs], arrs


@pytest.mark.parametrize("case", CASES)
def test_attention_plain_backward_gradchecks(case):
    b, s, h, kh, hd, causal, window = case
    (q, k, v), _ = _qkv(1, b, s, h, kh, hd, torch.float64)
    for t in (q, k, v):
        t.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=causal,
                                            window=window), (q, k, v))


@pytest.mark.parametrize("case", CASES[:3])
def test_attention_plain_backward_is_autograd_of_plain_forward(case):
    b, s, h, kh, hd, causal, window = case
    (q, k, v), _ = _qkv(2, b, s, h, kh, hd, torch.float64)
    do = torch.randn((b, s, h, hd), dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0))
    for t in (q, k, v):
        t.requires_grad_()
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert o.grad_fn.name().startswith("FlashAttention")
    got = torch.autograd.grad(o, (q, k, v), do)
    want = torch.autograd.grad(
        ref.attention_ref(q, k, v, causal=causal, window=window), (q, k, v),
        do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", [c for c in CASES if c[5]])
def test_attention_plain_backward_matches_jax_gradient(case):
    """The JAX model's attention (chunked online softmax over kv heads
    expanded to the query heads) differentiated by jax.vjp."""
    b, s, h, kh, hd, causal, window = case
    (q, k, v), arrs = _qkv(3, b, s, h, kh, hd, torch.float32)
    do = np.random.default_rng(4).standard_normal((b, s, h, hd)).astype(
        np.float32)
    o, lse = ref.attention_fwd_ref(q, k, v, causal=True, window=window)
    got = ref.attention_bwd_ref(q, k, v, o, torch.from_numpy(do), lse,
                                causal=True, window=window)

    def jfn(q, k, v):
        return jattn.chunked_causal_attention(
            q, jnp.repeat(k, h // kh, axis=2), jnp.repeat(v, h // kh, axis=2),
            window=window)
    jo, vjp = jax.vjp(jfn, *map(jnp.asarray, arrs))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_attention_lse_is_the_masked_logsumexp():
    b, s, h, kh, hd = 2, 11, 4, 2, 8
    (q, k, v), (qa, ka, _) = _qkv(5, b, s, h, kh, hd, torch.float32)
    _, lse = ref.attention_fwd_ref(q, k, v, causal=True, window=4)
    sc = jnp.einsum("bqhd,bkhd->bhqk", qa, jnp.repeat(ka, h // kh, axis=2))
    sc = sc / hd ** 0.5
    mask = ref.band_mask(s, s, True, 4).numpy()
    want = jax.nn.logsumexp(jnp.where(mask, sc, -1e30), axis=-1)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_rglru_plain_backward_gradchecks():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 7, 3)))
    gx = torch.from_numpy(rng.standard_normal((2, 7, 3)))
    h0 = torch.from_numpy(rng.standard_normal((2, 3)))
    for t in (a, gx, h0):
        t.requires_grad_()
    assert torch.autograd.gradcheck(ops.rglru_scan, (a, gx, h0))
    h = ops.rglru_scan(a, gx, h0)
    assert h.grad_fn.name().startswith("RGLRUScan")


@pytest.mark.parametrize("t", [1, 2, 33])
def test_rglru_plain_backward_matches_jax_gradient(t):
    rng = np.random.default_rng(7 + t)
    a = rng.uniform(0.7, 1.0, (2, t, 5)).astype(np.float32)
    gx = (0.1 * rng.standard_normal((2, t, 5))).astype(np.float32)
    h0 = rng.standard_normal((2, 5)).astype(np.float32)
    g = rng.standard_normal((2, t, 5)).astype(np.float32)
    at, gxt, h0t, gt = map(torch.from_numpy, (a, gx, h0, g))
    h = ref.rglru_scan_ref(at, gxt, h0t)
    got = ref.rglru_scan_bwd_ref(at, h, h0t, gt)
    _, vjp = jax.vjp(jref.rglru_scan_ref, jnp.asarray(a), jnp.asarray(gx),
                     jnp.asarray(h0))
    for x, w in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), **TOL)


def test_plain_backward_runs_in_the_kernels_order():
    """The plain reverse scan is the kernel's recurrence step by step
    (separately rounded multiply and add), so the kernel is held to it
    bitwise on the card: here it is held to that recurrence written out,
    bitwise."""
    rng = np.random.default_rng(9)
    a, h, g = (torch.from_numpy(rng.standard_normal((1, 6, 4)).astype(
        np.float32)) for _ in range(3))
    h0 = torch.zeros((1, 4))
    da, dgx, dh0 = ref.rglru_scan_bwd_ref(a, h, h0, g)
    dh = g[:, 5]
    for t in range(5, -1, -1):
        if t < 5:
            dh = g[:, t] + a[:, t + 1] * dh
        assert torch.equal(dgx[:, t], dh)
        assert torch.equal(da[:, t], dh * (h[:, t - 1] if t else h0))
    assert torch.equal(dh0, a[:, 0] * dh)


def test_no_graph_without_grad():
    """Serving (no grad, inference_mode) takes the forward alone: no
    Function, nothing saved."""
    (q, k, v), _ = _qkv(8, 1, 5, 2, 1, 4, torch.float32)
    with torch.inference_mode():
        assert ops.flash_attention(q, k, v).grad_fn is None
    o = ops.flash_attention(q, k, v)
    assert o.grad_fn is None
    assert torch.equal(o, ref.attention_ref(q, k, v))


def test_backward_wrappers_take_cuda_tensors_only():
    (q, k, v), _ = _qkv(9, 1, 5, 2, 1, 64, torch.float32)
    lse = torch.zeros((1, 2, 5))
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_bwd(q, k, v, q, q, lse)
    # MLA's pair (q and k 192, v, o and dO 128): a pair the backward takes,
    # refused on the CPU all the same
    q, k = torch.zeros((1, 5, 2, 192)), torch.zeros((1, 5, 1, 192))
    v, o = torch.zeros((1, 5, 1, 128)), torch.zeros((1, 5, 2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_bwd(q, k, v, o, o, lse)
    a = torch.zeros((1, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        scan.rglru_scan_bwd(a, a, a[:, 0], a)


# (q and k, v) -> bf16 (dK/dV, dQ) bytes and stages, f32 (dK/dV, dQ) bytes
BWD_SMEM = {(64, 64): ((101504, 100480), (4, 4), (139776, 104960)),
            (128, 128): ((183424, 198784), (4, 4), (157952, 149760)),
            (256, 256): ((215168, 198784), (2, 1), (223488, 185600)),
            (192, 128): ((224384, 206976), (4, 3), (143616, 122112))}


@pytest.mark.parametrize("pair", flash.BWD_PAIRS, ids=str)
def test_backward_shared_memory_fits_the_card(pair):
    """The backward's tiles at every head-dim pair and dtype fit a block's
    opt-in shared memory on an H100 (232,448 bytes); the C side is held
    to these numbers on the card.  bf16 takes the wgmma route; its dK/dV
    block holds K and V of its keys (128 at hd 64, 64 wider), a ring of
    Q and dO tiles (4 stages, 2 at hd 256) with their rows, and above hd
    64 the 16 KB P^T exchange; its dQ block both consumers' Q and dO and
    a ring of K and V tiles (4 stages, 1 at hd 256, 3 at MLA's (192,
    128), where a fourth would take 247,936 bytes).  Each ring has the
    most stages up to 4 that fit."""
    hd, hd_v = pair
    for dt in (torch.float32, torch.bfloat16):
        for which in (0, 1):
            assert 0 < flash.bwd_smem_bytes(hd, which, dt, hd_v) <= 232448
    assert [flash.bwd_route(dt, hd) for dt in (torch.bfloat16,
                                               torch.float32)] \
        == ["wgmma", "cuda_cores"]
    bf16, stages, f32 = BWD_SMEM[pair]
    assert tuple(flash.bwd_smem_bytes(hd, w, torch.bfloat16, hd_v)
                 for w in (0, 1)) == bf16
    assert tuple(flash.bwd_stages(hd, w, hd_v) for w in (0, 1)) == stages
    assert tuple(flash.bwd_smem_bytes(hd, w, torch.float32, hd_v)
                 for w in (0, 1)) == f32
    for w in (0, 1):
        if stages[w] < flash.BWD_MAX_STAGES:
            assert flash.bwd_smem_bytes_at(hd, hd_v, w, stages[w] + 1) \
                > flash.SMEM_OPTIN
    if hd == hd_v:      # the equal pairs' hd_v defaults to hd
        assert flash.bwd_smem_bytes(hd, 0, torch.bfloat16) == bf16[0]
    if pair == (192, 128):
        assert flash.bwd_smem_bytes_at(192, 128, 1, 4) == 247936


# (W, aligned, route): the tma route wants W * 4 bytes a multiple of 16 (W
# a multiple of 4) and every (B, T, W) operand on a 16-byte boundary
@pytest.mark.parametrize("w,aligned,want", [
    (4, True, "tma"), (6, True, "direct"), (12, True, "tma"),
    (13, True, "direct"), (4096, True, "tma"), (4096, False, "direct"),
    (0, True, "direct")])
def test_scan_bwd_route_by_width_and_alignment(w, aligned, want):
    assert scan.scan_bwd_route(w, aligned) == want


def test_scan_bwd_smem_bytes_fits_the_card():
    """A tma block (a ring of a, g and h tiles and two staging buffers of
    da and dgx) fits the H100's 232,448-byte opt-in, one block an SM, and
    its size implies SCAN_BWD_STAGES tiles in the ring; the direct route
    takes none.  The C side is held to these numbers on the card."""
    smem = scan.scan_bwd_smem_bytes(4096, True)
    box = scan.SCAN_BWD_COLS * scan.SCAN_BWD_ROWS * 4
    assert box == 8192 and smem == 131328
    assert (smem - 256) % box == 0
    assert ((smem - 256) // box - 2 * scan.SCAN_BWD_OUT_BUFS) // 3 \
        == scan.SCAN_BWD_STAGES == 4
    assert smem + 1024 <= 233472 < 2 * (smem + 1024) and smem <= 232448
    assert scan.scan_bwd_smem_bytes(13, True) == 0


def test_scan_bwd_operand_alignment():
    """`aligned16` reads the operands' addresses as the C entry point
    does: a view one float in is off a 16-byte boundary."""
    buf = torch.zeros(65)
    assert scan.aligned16(buf[:64], buf[:64])
    assert not scan.aligned16(buf[:64], buf[1:])
    assert scan.scan_bwd_route(64, scan.aligned16(buf[1:])) == "direct"


# (B, Skv, H, K, hd, SMs, splits): SmolLM's training shape (640 blocks of
# 128 keys at hd 64) and RecurrentGemma's (64 blocks of 64 keys at hd 256)
# do not and do split; the small MQA cases split to 4; GQA and MHA at
# enough blocks, or with a group of 1, never split
@pytest.mark.parametrize("b,skv,h,kh,hd,sms,want", [
    (8, 2048, 15, 5, 64, 132, 1), (1, 4096, 16, 1, 256, 132, 2),
    (2, 1000, 16, 1, 256, 132, 4), (2, 1000, 12, 4, 256, 132, 1),
    (2, 1000, 16, 16, 256, 132, 1), (1, 4096, 16, 1, 64, 132, 4),
    (1, 64, 2, 1, 64, 132, 2), (1, 0, 4, 1, 64, 132, 1)])
def test_bwd_head_splits_and_scratch_by_shape(b, skv, h, kh, hd, sms, want):
    """The dK/dV pass's head split and the scratch it sizes: the rows of
    every query tile, plus two float32 planes a split when it splits; the
    float32 route's scratch is D alone."""
    assert flash.bwd_head_splits(b, skv, h, kh, sms, hd) == want
    sq = skv
    rows = b * h * -(-sq // 64) * 128
    parts = 2 * want * b * skv * kh * hd if want > 1 else 0
    assert flash.bwd_scratch_floats(torch.bfloat16, b, sq, skv, h, kh, hd,
                                    sms) == rows + parts
    assert flash.bwd_scratch_floats(torch.float32, b, sq, skv, h, kh, hd,
                                    sms) == b * h * sq


# (B, Skv, H, K, SMs, splits) at MLA's pair, q and k 192, v 128: 64-key
# blocks as at hd 128 and 256; DeepSeek-V2's training shape (MHA, 128
# heads) never splits; GQA groups of 8 and 3 split in 2 and 3
@pytest.mark.parametrize("b,skv,h,kh,sms,want", [
    (2, 4096, 128, 128, 132, 1), (2, 1000, 16, 2, 132, 2),
    (1, 1000, 6, 2, 132, 3), (1, 64, 8, 1, 132, 4)])
def test_bwd_head_splits_and_scratch_at_mla_pair(b, skv, h, kh, sms, want):
    """The head split follows q's head dim alone; with a split, the
    scratch holds a dV partial of v's 128 columns and a dK partial of
    q's 192 for each split, after the rows; the float32 route's scratch
    is D alone."""
    assert flash.bwd_head_splits(b, skv, h, kh, sms, 192) == want
    assert flash.bwd_head_splits(b, skv, h, kh, sms, 192) \
        == flash.bwd_head_splits(b, skv, h, kh, sms, 128)
    rows = b * h * -(-skv // 64) * 128
    parts = want * b * skv * kh * (192 + 128) if want > 1 else 0
    assert flash.bwd_scratch_floats(torch.bfloat16, b, skv, skv, h, kh, 192,
                                    sms, 128) == rows + parts
    assert flash.bwd_scratch_floats(torch.float32, b, skv, skv, h, kh, 192,
                                    sms, 128) == b * h * skv


# (Sq, Skv, H, K, causal, window): causal, window 1 and 64, not causal (and
# windowed), ragged S; groups 1, 3 and 16
@pytest.mark.parametrize("hd", [64, 256, 192])
@pytest.mark.parametrize("sq,skv,h,kh,causal,window", [
    (200, 200, 6, 2, True, 0), (130, 130, 16, 1, True, 1),
    (200, 200, 3, 3, True, 64), (130, 130, 3, 1, False, 0),
    (200, 200, 6, 2, False, 64), (257, 257, 16, 1, True, 0),
    (193, 130, 3, 1, True, 0), (130, 193, 16, 1, False, 0)])
def test_flash_bwd_plan_covers_each_visible_pair_once(sq, skv, h, kh,
                                                      causal, window, hd):
    """The dK/dV walk against ref.band_mask, at every head split of the
    group and both block widths (128 keys at hd 64, 64 wider, q's head dim
    192 at MLA's pair among them): each
    visible (query, key, head) pair in exactly one walked tile, no hidden
    pair in a walked tile's count; a "skip" tile holds no visible pair, a
    "full" one only visible pairs and 64 real keys; the splits of a kv
    head partition its group of query heads."""
    mask = ref.band_mask(sq, skv, causal, window).numpy()
    group = h // kh
    for splits in range(1, min(4, group) + 1):
        count = np.zeros((h, sq, skv), dtype=np.int64)
        heads_of = {}
        for k0, kvh, hs, tiles in flash.flash_bwd_plan(
                sq, skv, h, kh, causal, window, hd, splits):
            assert all(x // group == kvh for x in hs)
            heads_of.setdefault((k0, kvh), []).extend(hs)
            k1 = min(k0 + 64, skv)
            for q0, kind in tiles:
                q1 = min(q0 + 64, sq)
                vis = mask[q0:q1, k0:k1]
                assert kind in flash.TILE_KINDS
                if kind == "skip":
                    assert not vis.any()
                    continue
                if kind == "full":
                    assert vis.all() and k0 + 64 <= skv
                for x in hs:
                    count[x, q0:q1, k0:k1] += vis
        np.testing.assert_array_equal(count, np.broadcast_to(mask,
                                                             count.shape))
        for (k0, kvh), hs in heads_of.items():
            assert sorted(hs) == list(range(kvh * group, (kvh + 1) * group))
