"""The port's xLSTM (mLSTM in both forms, sLSTM) against the JAX package,
on the CPU.

`get_reduced_config("xlstm-125m")` in float32 (2 layers: one mLSTM, one
sLSTM; d_model 64, 2 heads, chunk 8): the JAX package makes the weights,
`lm_params_from_jax` carries them across, and the same numpy-made inputs
go through both packages.  Held: `mlstm_apply_seq` and its cache in each
branch of its form choice (chunked at S 32; the recurrent form at S 30,
not a multiple of the chunk, and at S 8, one chunk), the port's chunked
form against its own recurrent form, `slstm_apply_seq` and its cache,
both decodes over a filled cache and the model's decode over
`init_decode_cache`'s zeros (sLSTM's `sn` ones), the model's prefill
logits and caches, its loss and every gradient leaf under both forms and
remat "none" and "full", three train steps, teacher-forced decode,
`serve` and the launcher.  No full-size weights are made: the full
config's parameters are counted from shapes alone.

Tolerances (float32; the packages sum in other orders), those of
tests/test_torch_mla.py: outputs and caches rtol 1e-5 / atol 1e-6,
gradients rtol 1e-4 / atol 1e-5, logits (and the prefill's caches,
downstream of whole blocks) 1e-4, decode against the forward 2e-3
(tests/test_models_smoke.py:86), the chunked form against the recurrent
one 5e-3 (tests/test_models_smoke.py:106-118), master weights after three
steps rtol 1e-5 / atol 1e-5 as tests/test_torch_train.py holds them."""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import transformer as jtf
from repro.models import xlstm as jx
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttf
from repro_torch.models import xlstm as tx
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

ARCH = "xlstm-125m"
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
FORMS_TOL = dict(rtol=5e-3, atol=5e-3)
MASTER_TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-3       # greedy tokens compared where the top-2 margin is wider


def _cfgs(**kw):
    return (dataclasses.replace(jconfigs.get_reduced_config(ARCH),
                                dtype="float32", **kw),
            dataclasses.replace(tconfigs.get_reduced_config(ARCH),
                                dtype="float32", **kw))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol,
                               err_msg=what)


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _model(seed, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _block_weights(init_j, seed, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jp = init_j(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _torch_tree(jax.tree.map(np.asarray, jp))


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _same_cache(got, want, tol):
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert got[key].dtype == torch.float32, key
        _close(got[key], want[key], tol, key)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_param_count_exact_from_shapes_is_the_reference_count():
    """130,798,896 parameters, from meta tensors and jax.eval_shape alone;
    every xLSTM leaf at the reference's shape and dtype, w_if, bias,
    w_slstm and w_rec float32 under bf16."""
    cfg = tconfigs.get_config(ARCH)
    assert cfg.mlstm_impl == "chunked" and cfg.mlstm_chunk == 128
    assert ttf.param_count_exact(cfg) == jtf.param_count_exact(
        jconfigs.get_config(ARCH)) == 130_798_896
    meta = ttf.init_params(0, cfg, device="meta")
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                    jconfigs.get_config(ARCH)))
    want = dict(jax.tree_util.tree_leaves_with_path(shapes))
    got = dict(jax.tree_util.tree_leaves_with_path(meta))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
    mix = meta["cycles"]
    for blk, key in (("b0", "w_if"), ("b0", "bias"), ("b1", "w_slstm"),
                     ("b1", "w_rec"), ("b1", "bias")):
        assert mix[blk]["mix"][key].dtype == torch.float32, (blk, key)
    assert mix["b0"]["mix"]["wqkv"].dtype == torch.bfloat16


def test_block_init_biases_are_the_reference_biases():
    """The biases are constants, not draws: mLSTM's zeros(nh) then
    linspace(3, 6, nh), sLSTM's [0]*2d, [4]*d, [0]*d, equal to the
    reference's; the port's own weights are finite at the reference's
    scales."""
    jcfg, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    m = tx.mlstm_init(gen, tcfg)
    s = tx.slstm_init(gen, tcfg)
    jm = jx.mlstm_init(jax.random.PRNGKey(0), jcfg)
    js = jx.slstm_init(jax.random.PRNGKey(0), jcfg)
    assert np.array_equal(m["bias"].numpy(), np.asarray(jm["bias"]))
    assert np.array_equal(s["bias"].numpy(), np.asarray(js["bias"]))
    for mine, ref in ((m, jm), (s, js)):
        for key, leaf in mine.items():
            if key == "out_norm":
                assert torch.equal(leaf["scale"], torch.ones_like(
                    leaf["scale"]))
                continue
            assert tuple(leaf.shape) == ref[key].shape, key
            assert bool(torch.isfinite(leaf).all()), key
            if key != "bias":
                sd = float(np.asarray(ref[key]).std())
                assert 0.8 * sd < float(leaf.std()) < 1.25 * sd, key


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunked", [(32, True), (30, False), (8, False)],
                         ids=["chunked S 32", "scan S 30 (ragged)",
                              "scan S 8 (one chunk)"])
def test_mlstm_apply_seq_and_its_cache_match_reference(s, chunked,
                                                       monkeypatch):
    """mlstm_impl "chunked" at chunk 8: the chunked form only where S is a
    multiple of the chunk longer than one chunk (counted), the recurrent
    form otherwise; the output and the cache (C, n, m, the conv window)
    against the reference's."""
    jcfg, tcfg, jp, tp = _block_weights(jx.mlstm_init, 5,
                                        mlstm_impl="chunked")
    calls = []
    inner = tx._mlstm_chunked
    monkeypatch.setattr(tx, "_mlstm_chunked",
                        lambda *a: calls.append(1) or inner(*a))
    x = _x(2, s, jcfg.d_model, 8)
    jout, jcache = jx.mlstm_apply_seq(jp, jcfg, jnp.asarray(x),
                                      make_cache=True)
    tout, tcache = tx.mlstm_apply_seq(tp, tcfg, torch.from_numpy(x),
                                      make_cache=True)
    assert len(calls) == int(chunked)
    assert tout.shape == (2, s, jcfg.d_model)
    _close(tout, jout, OUT_TOL, "out")
    assert set(tcache) == {"mc", "mn", "mm", "conv_m"}
    _same_cache(tcache, jcache, OUT_TOL)
    # the window is the last cw - 1 rows of xm, not a view of it
    assert tcache["conv_m"]._base is None


def test_chunked_form_matches_the_recurrent_form():
    """The port's two forms of one cell: the block at S 32 and the reduced
    model's logits at S 64, chunked against scan at 5e-3, as the
    reference holds its own two (tests/test_models_smoke.py:106-118)."""
    jcfg, tcfg, jp, tp = _block_weights(jx.mlstm_init, 6)
    x = torch.from_numpy(_x(2, 32, tcfg.d_model, 9))
    scan, sc = tx.mlstm_apply_seq(
        tp, dataclasses.replace(tcfg, mlstm_impl="scan"), x, True)
    chunk, cc = tx.mlstm_apply_seq(
        tp, dataclasses.replace(tcfg, mlstm_impl="chunked"), x, True)
    _close(chunk, scan.numpy(), FORMS_TOL, "block")
    # the two forms' stabilizers differ (m from 0 against from -1e30): the
    # state they carry is C and n scaled by exp(-m), one state in two scales
    for key in ("mc", "mn"):
        expand = (...,) + (None,) * (sc[key].dim() - 2)
        _close(cc[key] * torch.exp(cc["mm"])[expand],
               (sc[key] * torch.exp(sc["mm"])[expand]).numpy(), FORMS_TOL,
               key)
    _, tcfg = _cfgs()
    _, _, _, tp = _model(3)
    tok = torch.from_numpy(_tokens(2, 64, tcfg.vocab_size, 4))
    with torch.no_grad():
        a, _ = ttf.forward(tp, dataclasses.replace(tcfg, mlstm_impl="scan"),
                           {"tokens": tok})
        b, _ = ttf.forward(tp, dataclasses.replace(tcfg,
                                                   mlstm_impl="chunked"),
                           {"tokens": tok})
    _close(b, a.numpy(), FORMS_TOL, "logits")


def test_mlstm_decode_over_a_filled_cache_matches_reference():
    """Prefill 13 rows (the recurrent form), then 3 decode steps over its
    cache: each output and the new cache against the reference's."""
    jcfg, tcfg, jp, tp = _block_weights(jx.mlstm_init, 7)
    x = _x(2, 16, jcfg.d_model, 10)
    _, jc = jx.mlstm_apply_seq(jp, jcfg, jnp.asarray(x[:, :13]), True)
    _, tc = tx.mlstm_apply_seq(tp, tcfg, torch.from_numpy(x[:, :13]), True)
    for pos in range(13, 16):
        jout, jc = jx.mlstm_decode(jp, jcfg, jnp.asarray(x[:, pos:pos + 1]),
                                   jc, jnp.asarray(pos))
        tout, tc = tx.mlstm_decode(tp, tcfg,
                                   torch.from_numpy(x[:, pos:pos + 1]), tc,
                                   pos)
        assert tout.shape == (2, 1, jcfg.d_model)
        _close(tout, jout, OUT_TOL, f"out {pos}")
        _same_cache(tc, jc, OUT_TOL)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def test_slstm_apply_seq_and_its_cache_match_reference():
    jcfg, tcfg, jp, tp = _block_weights(jx.slstm_init, 11)
    x = _x(2, 24, jcfg.d_model, 12)
    jout, jcache = jx.slstm_apply_seq(jp, jcfg, jnp.asarray(x), True)
    tout, tcache = tx.slstm_apply_seq(tp, tcfg, torch.from_numpy(x), True)
    assert tout.shape == (2, 24, jcfg.d_model)
    _close(tout, jout, OUT_TOL, "out")
    assert set(tcache) == {"sc", "sn", "sh", "sm"}
    _same_cache(tcache, jcache, OUT_TOL)


def test_slstm_decode_over_a_filled_cache_matches_reference():
    jcfg, tcfg, jp, tp = _block_weights(jx.slstm_init, 13)
    x = _x(2, 12, jcfg.d_model, 14)
    _, jc = jx.slstm_apply_seq(jp, jcfg, jnp.asarray(x[:, :9]), True)
    _, tc = tx.slstm_apply_seq(tp, tcfg, torch.from_numpy(x[:, :9]), True)
    for pos in range(9, 12):
        jout, jc = jx.slstm_decode(jp, jcfg, jnp.asarray(x[:, pos:pos + 1]),
                                   jc, jnp.asarray(pos))
        tout, tc = tx.slstm_decode(tp, tcfg,
                                   torch.from_numpy(x[:, pos:pos + 1]), tc,
                                   pos)
        _close(tout, jout, OUT_TOL, f"out {pos}")
        _same_cache(tc, jc, OUT_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_init_decode_cache_matches_reference_layout():
    """Every leaf's shape, dtype and value: mLSTM's C, n, m float32 and its
    conv window in the parameter dtype; sLSTM's states zeros but sn
    ones."""
    jcfg, tcfg = _cfgs()
    jc = jtf.init_decode_cache(jcfg, 2, 24)
    tc = ttf.init_decode_cache(tcfg, 2, 24, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jc)
    tl = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tc)))
    assert len(tl) == len(jl)
    for path, leaf in jl:
        assert tl[path].shape == leaf.shape, path
        assert tl[path].dtype == leaf.dtype, path
        assert np.array_equal(tl[path], np.asarray(leaf)), path
    assert tc["cycles"]["b0"]["mc"].shape == (1, 2, 2, 64, 64)
    assert bool((tc["cycles"]["b1"]["sn"] == 1).all())


def test_decode_over_the_zeros_cache_matches_reference():
    """decode_step from `init_decode_cache` (sLSTM's sn ones, not the
    sequence form's zeros) for 6 tokens, each step's logits and the cache
    against the reference's decode_step from its own zeros cache."""
    jcfg, tcfg, jp, tp = _model(2)
    tok = _tokens(2, 6, tcfg.vocab_size, 15)
    jc = jtf.init_decode_cache(jcfg, 2, 6)
    tc = ttf.init_decode_cache(tcfg, 2, 6, device="cpu")
    for pos in range(6):
        step = tok[:, pos:pos + 1]
        jlog, jc = jtf.decode_step(jp, jcfg, jnp.asarray(step), jc,
                                   jnp.asarray(pos))
        tlog, tc = ttf.decode_step(tp, tcfg, torch.from_numpy(step), tc, pos)
        _close(tlog, jlog, LOGIT_TOL, f"position {pos}")
    jl = dict(jax.tree_util.tree_leaves_with_path(jc))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: t.numpy(), tc)):
        _close(leaf, jl[path], LOGIT_TOL, jax.tree_util.keystr(path))


@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_forward_prefill_matches_reference(impl):
    jcfg, tcfg, jp, tp = _model(1, mlstm_impl=impl)
    tok = _tokens(2, 40, tcfg.vocab_size, seed=5)
    jlog, _, jcache = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(tok)},
                                  mode="prefill")
    tlog, taux, tcache = ttf.forward(tp, tcfg,
                                     {"tokens": torch.from_numpy(tok)},
                                     mode="prefill")
    assert tlog.shape == (2, 40, 256) and float(taux) == 0.0
    _close(tlog, jlog, LOGIT_TOL, "logits")
    jl = jax.tree_util.tree_leaves_with_path(jcache)
    tl = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tcache)))
    assert len(tl) == len(jl) == 8
    for path, leaf in jl:       # downstream of whole blocks: the logits'
        _close(tl[path], leaf, LOGIT_TOL, jax.tree_util.keystr(path))


@pytest.mark.parametrize("impl,remat", [("scan", "none"), ("scan", "full"),
                                        ("chunked", "none"),
                                        ("chunked", "full")])
def test_loss_and_every_gradient_leaf_match_jax(impl, remat):
    """The loss and every gradient leaf within GRAD_TOL of
    jax.value_and_grad of the reference's loss under the same form and
    remat, at S 32 (4 chunks); every mLSTM and sLSTM leaf non-zero (the
    detached maxima stop no gradient they should pass)."""
    jcfg, tcfg, jp, tp = _model(1, mlstm_impl=impl, remat=remat)
    rng = np.random.default_rng(12)
    batch = {k: rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                        for k, v in batch.items()}),
        has_aux=True)(jp)
    leaves = [leaf.detach().clone().requires_grad_()
              for leaf in topt.tree_leaves(tp)]
    params = tts._like_sorted(tp, iter(leaves))
    loss, _ = ttf.loss_fn(params, tcfg, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(grads) == 18
    for (path, jgl), g in zip(jleaves, grads):
        name = jax.tree_util.keystr(path)
        _close(g, jgl, GRAD_TOL, name)
        if "'mix'" in name:
            assert float(g.abs().max()) > 0, name


def _jgrads(cfg, p, batch):
    g = _jgrad(cfg)(p, {k: jnp.asarray(v) for k, v in batch.items()})
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(g)]


@functools.lru_cache(maxsize=None)
def _jgrad(cfg):
    return jax.jit(jax.grad(lambda q, b: jtf.loss_fn(q, cfg, b)[0]))


def _tgrads(cfg, p, batch):
    leaves = [leaf.detach().clone().requires_grad_()
              for leaf in topt.tree_leaves(p)]
    loss, _ = ttf.loss_fn(tts._like_sorted(p, iter(leaves)), cfg,
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    return [g.float().numpy() for g in torch.autograd.grad(loss, leaves)]


def _gap(got, want):
    return [float(np.linalg.norm(g - w) / np.linalg.norm(w))
            for g, w in zip(got, want)]


def _rounded(jp, tp):
    """The weights as cast_params rounds them to bf16, back in float32."""
    return (jax.tree.map(lambda w: w.astype(jnp.float32),
                         jts.cast_params(jp, jnp.bfloat16)),
            topt.tree_map(lambda w: w.float(),
                          tts.cast_params(tp, torch.bfloat16)))


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_bf16_gradients_against_the_rounding_control(width):
    """bf16 against float32 gradients (the chunked form), and the control:
    a float32 step on the weights rounded as cast_params rounds them.
    "reduced": the reduced config, B 2 x S 32.  "full": the card's check's
    shape (chip_smoke.xl_grad_checks), 2 layers (one mLSTM, one sLSTM) at
    full width, B 1 x S 512.  In the port and the reference alike every
    leaf meets chip_smoke.bf16_leaf_limits (5e-2, or 3x the control's gap
    where the control alone reaches 5e-2); the port's float32 gradients
    are the reference's.  At reduced width no control reaches 5e-2 and
    both packages are within 5e-2 everywhere; at full width the control
    does on the first layer's leaves, and the reference's own bf16
    gradients miss 5e-2 on exactly those leaves.  Each package's gaps are
    printed (pytest -s)."""
    if width == "full":
        jcfg, tcfg = (dataclasses.replace(c.get_config(ARCH), num_layers=2,
                                          dtype="float32")
                      for c in (jconfigs, tconfigs))
        jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        b, s = 1, 512
    else:
        jcfg, tcfg, jp, tp = _model(1, mlstm_impl="chunked")
        b, s = 2, 32
    assert tcfg.mlstm_impl == "chunked" and s % tcfg.mlstm_chunk == 0
    rng = np.random.default_rng(12)
    batch = {k: rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    jround, tround = _rounded(jp, tp)
    jf32, tf32 = _jgrads(jcfg, jp, batch), _tgrads(tcfg, tp, batch)
    assert max(_gap(tf32, jf32)) <= 1e-4
    names = [jax.tree_util.keystr(path) for path, _ in
             jax.tree_util.tree_leaves_with_path(jp)]
    tol = chip_smoke.GRAD_TOL["bfloat16"]
    for name, f32, control, bf16 in (
            ("reference", jf32, _jgrads(jcfg, jround, batch),
             _jgrads(dataclasses.replace(jcfg, dtype="bfloat16"),
                     jts.cast_params(jp, jnp.bfloat16), batch)),
            ("port", tf32, _tgrads(tcfg, tround, batch),
             _tgrads(dataclasses.replace(tcfg, dtype="bfloat16"),
                     tts.cast_params(tp, torch.bfloat16), batch))):
        control = dict(zip(names, _gap(control, f32)))
        bf_gap = dict(zip(names, _gap(bf16, f32)))
        limits = chip_smoke.bf16_leaf_limits(control)
        over = {k for k, g in bf_gap.items() if g > tol}
        print(f"{width} {name}: {{leaf: (bf16 gap, control gap)}} "
              f"{ {k: (round(bf_gap[k], 4), round(control[k], 4)) for k in names} }")
        assert all(bf_gap[k] <= limits[k] for k in names), (name, bf_gap)
        if width == "reduced":
            assert not over, (name, bf_gap)
        elif name == "reference":
            assert over and over == {k for k, c in control.items()
                                     if c >= tol}, (bf_gap, control)


def test_train_step_three_steps_match_jax():
    """Three AdamW steps at B 4 x S 32 (the chunked form) through
    make_train_step against the reference's jitted train step: the loss
    at rtol 1e-5 each step, 99.9 % of each master leaf within MASTER_TOL
    and every weight within 2 lr a step."""
    jcfg, tcfg, jp, tp = _model(1, mlstm_impl="chunked")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=6)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt.OptConfig(**kw)))
    tstep = tts.make_train_step(tcfg, topt.OptConfig(**kw))
    js = {"opt": jopt.init_opt_state(jp, jopt.OptConfig(**kw))}
    ts = {"opt": topt.init_opt_state(tp, topt.OptConfig(**kw))}
    rng = np.random.default_rng(21)
    for step in range(3):
        b = {k: _tokens(4, 32, tcfg.vocab_size, int(rng.integers(1 << 30)))
             for k in ("tokens", "labels")}
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == 3
    want = jax.tree_util.tree_leaves(js["opt"]["master"])
    got = topt.tree_leaves(ts["opt"]["master"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.isclose(g, w, **MASTER_TOL).mean() >= 0.999
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * kw["lr"] * 3)


@pytest.mark.parametrize("impl,s0", [("scan", 19), ("chunked", 24)])
def test_teacher_forced_decode_matches_reference_and_forward(impl, s0):
    """Prefill s0 tokens (chunked at 24: 3 chunks), then decode the rest
    of 32 teacher-forced, each step's logits against the reference's
    decode_step and the port's own forward over all 32 (the recurrent
    form's, the reference's decode contract)."""
    jcfg, tcfg, jp, tp = _model(4, mlstm_impl=impl)
    tok = _tokens(2, 32, tcfg.vocab_size, seed=6)
    with torch.no_grad():
        full, _ = ttf.forward(tp, dataclasses.replace(tcfg, mlstm_impl="scan"),
                              {"tokens": torch.from_numpy(tok)})
    _, _, jcache = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(tok[:, :s0])},
                               mode="prefill")
    _, _, tcache = ttf.forward(tp, tcfg,
                               {"tokens": torch.from_numpy(tok[:, :s0])},
                               mode="prefill")
    grown = tserve._grow(tcache, s0, 32 - s0)     # recurrent state: as is
    assert all(a is b for a, b in zip(topt.tree_leaves(grown),
                                      topt.tree_leaves(tcache)))
    jdecode = jax.jit(lambda c, t, pos: jtf.decode_step(jp, jcfg, t, c, pos))
    for pos in range(s0, 32):
        step = tok[:, pos:pos + 1]
        jlog, jcache = jdecode(jcache, jnp.asarray(step), jnp.asarray(pos))
        tlog, grown = ttf.decode_step(tp, tcfg, torch.from_numpy(step),
                                      grown, pos)
        _close(tlog, jlog, LOGIT_TOL, f"position {pos}")
        _close(tlog[:, 0], full[:, pos], DECODE_TOL, f"position {pos}")


@pytest.mark.parametrize("impl,prompt", [("scan", 12), ("chunked", 16)])
def test_serve_matches_reference_serve(impl, prompt):
    """The reference's own serve (8 tokens) against the port's on its
    weights: the tokens equal up to the first step whose reference top-2
    margin is at most MARGIN."""
    jcfg, tcfg = _cfgs(mlstm_impl=impl)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)   # jserve's weights
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    want, _ = jserve.serve(jcfg, 2, prompt, 8, seed=0)
    got = tserve.serve(tcfg, 2, prompt, 8, seed=0, device="cpu", params=tp)
    assert got.tokens.shape == want.shape == (2, 8)
    prompt_tok = tpipeline.make_batch(
        tpipeline.DataConfig(256, prompt + 8, 2, seed=0), 0)["tokens"][
        :, :prompt]
    t0 = np.asarray(jtf.forward(jp, jcfg, {"tokens": jnp.asarray(
        prompt_tok)})[0][:, -1])
    seq = np.concatenate([prompt_tok, t0.argmax(-1)[:, None], want[:, :-1]],
                         1)
    logits = np.asarray(jtf.forward(
        jp, dataclasses.replace(jcfg, mlstm_impl="scan"),
        {"tokens": jnp.asarray(seq)})[0][:, prompt:])
    top = np.sort(logits, -1)
    margin = top[..., -1] - top[..., -2]
    margin[:, 0] = np.minimum(margin[:, 0], np.diff(np.sort(t0, -1)[:, -2:],
                                                    axis=-1)[:, 0])
    for row in range(2):
        small = np.flatnonzero(margin[row] <= MARGIN)
        upto = small[0] if len(small) else 8
        if upto < 8:
            warnings.warn(f"serve, row {row}: the reference's top-2 margin "
                          f"at step {upto} is {margin[row, upto]:.2e}; steps "
                          f"{upto}.. not compared")
        assert np.array_equal(got.tokens[row, :upto], want[row, :upto]), row


def test_launch_train_runs_on_xlstm(tmp_path, capsys):
    """The launcher on the reduced config on the CPU: the Lotaru profile,
    12 steps with a checkpoint directory, finite losses that fall."""
    losses = ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--steps", "12", "--batch", "4", "--seq", "32",
                          "--lr", "3e-3", "--log-every", "4",
                          "--ckpt-dir", str(tmp_path / "run")])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert ttrain.main.stats["predicted_step_s"] > 0
    assert "[done]" in capsys.readouterr().out
