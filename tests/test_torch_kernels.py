"""The port's kernel modules against the JAX package, on the CPU.

A CPU tensor takes each kernel's plain PyTorch version, so these tests hold
the plain versions (the oracles the CUDA kernels are held against on the
card) to the reference: `bayes_predict` bitwise against
`core.bayes.predict_blr_np` and at float32 tolerance against the Pallas
kernel in interpret mode; `bayes_fit` against the Pallas kernel at the
rtol 5e-3 / atol 5e-4 of tests/test_kernels.py (its closed-form 2x2
algebra and its reduction order differ from the batched fit's) and against
the reference's batched `fit_blr`, the same algorithm, at rtol 1e-3 /
atol 1e-5; the plain attention against the Pallas flash attention in
interpret mode and the JAX `ref.attention_ref` at the tolerances of
tests/test_kernels.py (2e-5 in float32, 5e-2 in bfloat16); the plain
RG-LRU scan against the JAX associative-scan `ref.rglru_scan_ref` at 1e-5.
Inputs are made with seeded numpy and fed to both."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bayes as jbayes
from repro.kernels import bayes_fit as jkernels
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.store import compute as jcompute
from repro_torch.kernels import _build
from repro_torch.kernels import bayes_fit as tkernels
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as trglru
from repro_torch.store import compute as tcompute

FIT_TOL = dict(rtol=5e-3, atol=5e-4)
# the plain fit and the reference's batched fit_blr run the same float32
# algorithm; over 30 fixed-point steps beta_prec drifts to about 1.5e-4
# relative on 10-point tasks, every other leaf stays within 1e-4
BATCH_TOL = dict(rtol=1e-3, atol=1e-5)
LEAVES = ("mu", "sigma", "beta_prec", "x_mu", "x_sd", "y_mu", "y_sd")


def _posteriors(q, seed):
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(q, 2, 2)) * 0.3
    post = {"mu": rng.normal(size=(q, 2)),
            "sigma": np.ascontiguousarray(lo @ lo.transpose(0, 2, 1)),
            "beta_prec": rng.uniform(0.5, 50.0, q),
            "x_mu": rng.uniform(0.0, 5.0, q),
            "x_sd": rng.uniform(0.1, 3.0, q),
            "y_mu": rng.uniform(10.0, 5000.0, q),
            "y_sd": rng.uniform(1.0, 100.0, q)}
    return rng.uniform(0.0, 10.0, q), post


def _buffers(t, seed, lo=3, hi=11):
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(0.1, 5.0, k) for k in rng.integers(lo, hi + 1, t)]
    ys = [rng.uniform(5, 50) + rng.uniform(1, 10) * x
          + rng.normal(0, 0.05, len(x)) for x in xs]
    return xs, ys


def _batch(x, post):
    """The predictive's packed rows of (x, post), on the CPU."""
    return tkernels.pack_predict("cpu", x, post)


# Q values off any tile multiple: the port pads nothing (the reference
# padded to _PREDICT_TILE = 1024 only to avoid recompiles)
@pytest.mark.parametrize("q", [0, 1, 7, 1023, 1025, 4099])
def test_bayes_predict_plain_bitwise_vs_predict_blr_np(q):
    x, post = _posteriors(q, seed=q)
    mean, std = ops.bayes_predict(_batch(x, post)).unbind(1)
    want_mean, want_std = jbayes.predict_blr_np(post, x)
    assert mean.shape == (q,) and std.shape == (q,)
    assert np.array_equal(mean.numpy(), want_mean)
    assert np.array_equal(std.numpy(), want_std)


@pytest.mark.parametrize("q", [5, 1000, 2500])
def test_bayes_predict_plain_vs_pallas_interpret(q):
    x, post = _posteriors(q, seed=100 + q)
    mean, std = ops.bayes_predict(_batch(x, post)).unbind(1)
    jm, js = jkernels.bayes_predict(
        jnp.asarray(x, jnp.float32),
        {k: jnp.asarray(v, jnp.float32) for k, v in post.items()},
        interpret=True)
    # float32 kernel vs float64 plain version: a few float32 ulps of the
    # outputs' scale
    np.testing.assert_allclose(np.asarray(jm), mean.numpy(),
                               rtol=2e-6, atol=2e-6 * np.abs(mean.numpy()).max())
    np.testing.assert_allclose(np.asarray(js), std.numpy(),
                               rtol=2e-6, atol=2e-6 * np.abs(std.numpy()).max())


def test_predict_stacked_bitwise_vs_reference():
    x, post = _posteriors(777, seed=3)
    got = tcompute.predict_stacked(x, post, device="cpu")
    want = jcompute.predict_stacked(x, post)
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and np.array_equal(g, w)


# (T, max points): task counts off the Pallas block of 128, ragged masks
@pytest.mark.parametrize("t,hi", [(1, 5), (64, 10), (130, 10), (257, 40)])
def test_bayes_fit_plain_vs_pallas_and_ref(t, hi):
    x, y, m = jkernels.pad_ragged(*_buffers(t, seed=t, hi=hi))
    got = ops.bayes_fit(torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(m))
    pallas = jkernels.bayes_fit_ragged(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(m), interpret=True)
    oracle = jref.bayes_fit_ref(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(m))
    for leaf in pallas:
        g = got[leaf].numpy()
        assert g.shape == np.shape(pallas[leaf]), leaf
        np.testing.assert_allclose(g, np.asarray(pallas[leaf]), **FIT_TOL,
                                   err_msg=leaf)
        np.testing.assert_allclose(g, np.asarray(oracle[leaf]), **BATCH_TOL,
                                   err_msg=leaf)


def test_bayes_fit_padded_rows_are_no_ops():
    """A fully masked row fits to a finite default posterior and leaves
    the other rows exactly as they fit alone."""
    x, y, m = jkernels.pad_ragged(*_buffers(9, seed=5))
    pad = np.zeros((3, x.shape[1]), np.float32)
    alone = ops.bayes_fit(*(torch.from_numpy(a) for a in (x, y, m)))
    padded = ops.bayes_fit(*(torch.from_numpy(np.concatenate([a, pad]))
                             for a in (x, y, m)))
    for leaf, v in alone.items():
        assert torch.equal(padded[leaf][:9], v), leaf
        assert bool(torch.isfinite(padded[leaf][9:]).all()), leaf
    assert torch.equal(padded["n"][9:], torch.ones(3))


def test_fit_stacked_vs_reference():
    x, y, m = jkernels.pad_ragged(*_buffers(50, seed=8, hi=20))
    got = tcompute.fit_stacked(x, y, m, device="cpu")
    want = jcompute.fit_stacked(x, y, m)
    assert set(got) == set(want)
    for leaf, w in want.items():
        assert got[leaf].dtype == np.float64
        np.testing.assert_allclose(got[leaf], w, **BATCH_TOL, err_msg=leaf)


@pytest.mark.parametrize("lengths,min_cols,col_bucket", [
    ([3, 10, 64], 2, 64),
    ([1, 65, 7], 2, 64),
    ([4, 4], 2, 1),
    ([], 2, 64),
    ([5, 2, 9], 16, 8),
])
def test_pad_ragged_byte_identical(lengths, min_cols, col_bucket):
    rng = np.random.default_rng(len(lengths) + min_cols)
    xs = [rng.uniform(0, 5, k) for k in lengths]
    ys = [rng.uniform(0, 50, k) for k in lengths]
    got = tkernels.pad_ragged(xs, ys, min_cols, col_bucket)
    want = jkernels.pad_ragged(xs, ys, min_cols, col_bucket)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_pad_ragged_rejects_mismatched_rows():
    with pytest.raises(ValueError):
        tkernels.pad_ragged([np.ones(3)], [np.ones(2)])


def test_cuda_wrappers_refuse_cpu_tensors():
    """The launch wrappers take CUDA tensors only: a CPU tensor is refused
    before any build or launch (the CPU goes through kernels.ops)."""
    x, post = _posteriors(4, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        tkernels.bayes_predict(_batch(x, post))
    z = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tkernels.bayes_fit(z, z, z)
    assert tkernels.bayes_predict.launches == 0
    assert tkernels.bayes_fit.launches == 0


def test_ops_refuse_other_devices():
    z = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.bayes_fit(z, z, z)


def _qkv(shape_q, kh, dtype, seed):
    b, s, h, hd = shape_q
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shp).astype(np.float32)
               for shp in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))
    if dtype == "bfloat16":        # round once, then both packages read it
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                   for a in (q, k, v))
    return q, k, v


def _port_attention(q, k, v, dtype, window):
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    return out.float().numpy()


# the sweep of tests/test_kernels.py::test_flash_attention_sweep
@pytest.mark.parametrize("b,s,h,kh,hd", [
    (1, 128, 4, 4, 32),      # MHA
    (2, 128, 4, 2, 32),      # GQA 2:1
    (1, 256, 8, 1, 64),      # MQA
    (1, 128, 4, 2, 128),     # MXU-width head dim
])
@pytest.mark.parametrize("window", [0, 64])
def test_attention_plain_vs_pallas_interpret_and_ref(b, s, h, kh, hd, window):
    q, k, v = _qkv((b, s, h, hd), kh, "float32", seed=b * s + h + kh + hd)
    got = _port_attention(q, k, v, "float32", window)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                  impl="interpret")
    oracle = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=2e-5, atol=2e-5)


# S off every tile multiple: the Pallas wrapper asserts tile multiples (a
# TPU tiling limit), so these are held against the JAX ref alone
@pytest.mark.parametrize("s,window", [(200, 0), (200, 48), (37, 16)])
def test_attention_plain_ragged_vs_ref(s, window):
    q, k, v = _qkv((2, s, 4, 64), 1, "float32", seed=s + window)
    got = _port_attention(q, k, v, "float32", window)
    want = jref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_attention_plain_bf16_vs_pallas_interpret_and_ref():
    """The case of tests/test_kernels.py::test_flash_attention_bf16."""
    q, k, v = _qkv((1, 128, 4, 64), 2, "bfloat16", seed=0)
    got = _port_attention(q, k, v, "bfloat16", 0)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    for want in (jops.flash_attention(jq, jk, jv, impl="interpret"),
                 jref.attention_ref(jq, jk, jv)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=5e-2, atol=5e-2)


# the shapes of tests/test_kernels.py::test_rglru_scan_sweep (whose Pallas
# interpret run fails under the installed JAX: pl.store is gone), and one
# from a zero state, as at prefill
@pytest.mark.parametrize("b,t,w,zero_h0", [
    (1, 256, 128, False), (2, 512, 256, False), (1, 128, 384, False),
    (2, 100, 64, True)])
def test_rglru_scan_plain_vs_ref(b, t, w, zero_h0):
    rng = np.random.default_rng(b * t + w)
    a = rng.uniform(0.7, 0.999, (b, t, w)).astype(np.float32)
    gx = (rng.standard_normal((b, t, w)) * 0.1).astype(np.float32)
    h0 = np.zeros((b, w), np.float32) if zero_h0 else \
        rng.standard_normal((b, w)).astype(np.float32)
    got = ops.rglru_scan(*(torch.from_numpy(x) for x in (a, gx, h0)))
    want = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(gx),
                               jnp.asarray(h0))
    assert got.dtype == torch.float32 and got.shape == (b, t, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_lm_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q, q)
    a = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        trglru.rglru_scan(a, a, torch.zeros(1, 4))
    assert tflash.flash_attention.launches == 0
    assert trglru.rglru_scan.launches == 0


def test_library_path_tracks_sources_and_flags(monkeypatch, tmp_path):
    """Every source builds without multiply-add contraction (the bitwise
    kernels need it), and the library's name carries a hash of the flags
    and of the sources, so a changed flag or an edited source never loads
    a stale build."""
    assert "--fmad=false" in _build.NVCC_FLAGS
    names = ("flash_attention", "rglru_scan")
    before = {n: _build.library_path(n) for n in names}
    assert len(set(before.values())) == len(names)
    monkeypatch.setattr(_build, "NVCC_FLAGS", tuple(
        "--fmad=true" if f == "--fmad=false" else f
        for f in _build.NVCC_FLAGS))
    for name, path in before.items():
        assert _build.library_path(name) != path
    monkeypatch.undo()
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    assert {n: _build.library_path(n) for n in names} == before
    with open(csrc / "rglru_scan.cu", "a") as f:
        f.write("\n")
    assert _build.library_path("rglru_scan") != before["rglru_scan"]
    assert _build.library_path("flash_attention") == before["flash_attention"]


# --- the bf16 kernel's shape arithmetic (no CUDA library is built) ----------

H100_SMEM_OPTIN = 232448        # cudaDevAttrMaxSharedMemoryPerBlockOptin


# flash_smem_bytes in csrc/flash_attention.cu, q and k of head dim hd and
# v of hd_v: (2 * hd + stages * (hd + hd_v)) * 64 * 2 + 1024 + 128
@pytest.mark.parametrize("hd,hd_v,stages,want", [
    (64, 64, 4, 83072), (128, 128, 4, 164992), (256, 256, 2, 197760),
    (192, 128, 4, 214144)])
def test_flash_smem_bytes_fits_and_equals_the_c_formula(hd, hd_v, stages,
                                                        want):
    assert (hd, hd_v) in tflash.FWD_PAIRS
    assert tflash.flash_stages(hd) == stages
    assert tflash.flash_smem_bytes(hd, hd_v, stages) == want
    assert want <= H100_SMEM_OPTIN
    # one more stage at hd = 256 and at MLA's pair would not fit
    if hd in (256, 192):
        assert tflash.flash_smem_bytes(hd, hd_v, stages + 1) \
            > H100_SMEM_OPTIN


def test_flash_head_dim_pairs():
    """Both passes take the equal pairs and MLA's (192, 128)."""
    assert set(tflash.FWD_PAIRS) == {(d, d) for d in tflash.HEAD_DIMS} \
        | {(192, 128)}
    assert tflash.BWD_PAIRS == tflash.FWD_PAIRS


@pytest.mark.parametrize("dtype,h,kh,route", [
    (torch.bfloat16, 16, 1, "wgmma_heads"),    # RecurrentGemma-9B: MQA
    (torch.bfloat16, 16, 2, "wgmma_heads"),    # GQA, group 8
    (torch.bfloat16, 16, 8, "wgmma_heads"),    # GQA, group 2
    (torch.bfloat16, 16, 16, "wgmma_tiles"),   # MHA
    (torch.bfloat16, 6, 2, "wgmma_tiles"),     # GQA, group 3
    (torch.bfloat16, 12, 4, "wgmma_tiles"),
    (torch.bfloat16, 128, 128, "wgmma_tiles"),  # DeepSeek-V2's expanded MLA
    (torch.float32, 16, 1, "f32"),
])
def test_flash_route_by_shape(dtype, h, kh, route):
    assert tflash.flash_route(dtype, h, kh) == route
    assert route in tflash.ROUTES


def _hidden_padded(sq, skv, causal, window, pad):
    """ref.band_mask, with `pad` more key columns past skv, all hidden."""
    from repro_torch.kernels import ref
    vis = torch.zeros((sq, skv + pad), dtype=torch.bool)
    vis[:, :skv] = ref.band_mask(sq, skv, causal, window)
    return vis


# windows about the tile (0, 1, 63, 64, 65) and ones wide enough for full
# tiles that start off the 64-key grid, next to the diagonal (127, 128)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 64, 130, 200])
@pytest.mark.parametrize("window", [0, 1, 63, 64, 65, 127, 128])
def test_flash_tile_plan_against_band_mask(window, s, causal):
    """A tile the plan calls full is all visible, one it skips all
    hidden, a masked one mixed (keys past S hidden); the walked tiles of
    each consumer cover every visible pair exactly once.  Both pairings:
    one query tile a block (heads) and two (tiles)."""
    bq = bk = 64
    vis = _hidden_padded(s, s, causal, window, bk)
    for consumers in (1, 2):
        plan = tflash.flash_tile_plan(s, s, causal, window, bq, bk,
                                      consumers)
        seen = torch.zeros_like(vis, dtype=torch.int32)
        for q_lo, q_hi, j0, kind in plan:
            sub = vis[q_lo:q_hi, j0:j0 + bk]
            assert sub.shape == (q_hi - q_lo, bk)
            want = ("full" if bool(sub.all()) else
                    "skip" if not bool(sub.any()) else "masked")
            assert kind == want, (consumers, q_lo, j0)
            if kind != "skip":
                seen[q_lo:q_hi, j0:j0 + bk] += 1
        assert bool((seen[vis] == 1).all())
        assert int(seen.max()) <= 1


# the new kernel's edge shapes: a group of 3 (the tiles pairing), a window
# of exactly one tile and one key more, S off the tile, hd = 64
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("window", [64, 65])
def test_attention_plain_edge_shapes_vs_ref(dtype, tol, window):
    q, k, v = _qkv((1, 130, 6, 64), 2, dtype, seed=window)
    got = _port_attention(q, k, v, dtype, window)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jref.attention_ref(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
