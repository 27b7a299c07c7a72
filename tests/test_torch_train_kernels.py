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
    a = torch.zeros((1, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        scan.rglru_scan_bwd(a, a, a[:, 0], a)


def test_backward_shared_memory_fits_the_card():
    """The backward's tiles at every head dim and dtype fit a block's
    opt-in shared memory on an H100 (232,448 bytes); the C side is held
    to these numbers on the card.  bf16 takes the mma route."""
    for hd in flash.HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            for which in (0, 1):
                assert 0 < flash.bwd_smem_bytes(hd, which, dt) <= 232448
    assert flash.bwd_smem_bytes(256, 0) == 223488
    assert [flash.bwd_route(dt, hd) for dt, hd in (
        (torch.bfloat16, 64), (torch.bfloat16, 256), (torch.float32, 64))] \
        == ["mma", "mma", "cuda_cores"]
    assert flash.bwd_smem_bytes(64, 0, torch.bfloat16) == 55808
    assert flash.bwd_smem_bytes(256, 0, torch.bfloat16) == 154112
