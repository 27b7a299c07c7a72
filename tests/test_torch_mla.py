"""The port's multi-head latent attention (MLA) and DeepSeek-V2 against the
JAX package, on the CPU.

`get_reduced_config("deepseek-v2-236b")` in float32 (qk 32 + 16, v 32,
kv_lora 32, 8 experts, top 2, a dense prefix layer and one MoE layer): the
JAX package makes the weights, `lm_params_from_jax` carries them across,
and the same numpy-made inputs go through both packages.  On the CPU the
expanded form's attention runs the plain version (`ref.attention_ref`, q
and k of head dim 48, v of 32), which is held here against the
reference's `chunked_causal_attention` at an unequal pair, with GQA and a
window too, forward and backward.  `mla_apply_seq` and its cache,
`mla_decode` over a filled cache (the absorbed form), the model's forward,
its loss and every gradient leaf (remat "none" and "full"), three train
steps under the config's remat "full" and int8 moments (one and two
microbatches), teacher-forced decode, `serve` and `init_decode_cache`,
each against the reference's.

Tolerances (float32; the packages sum in other orders), those of
tests/test_torch_moe.py: outputs rtol 1e-5 / atol 1e-6, gradients rtol
1e-4 / atol 1e-5, logits (and the prefill's caches, downstream of whole
blocks) 1e-4, decode against the forward 2e-3
(tests/test_models_smoke.py:86); the train steps' master weights within
rtol 1e-5 / atol 1e-5 and 2 lr, as tests/test_torch_train.py holds them,
where int8 moments leave those limits meaningful (see the test)."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax, train_state_from_jax
from repro_torch.data import pipeline as tpipeline
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

ARCH = "deepseek-v2-236b"
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
MASTER_TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-3       # greedy tokens compared where the top-2 margin is wider
S = 24


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


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jtf.init_params(jax.random.PRNGKey(3), jcfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# attention at an unequal head-dim pair
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kh,window", [(4, 0), (2, 0), (2, 5)],
                         ids=["MHA", "GQA", "GQA window 5"])
def test_attention_ref_at_an_unequal_pair_matches_chunked_attention(kh,
                                                                    window):
    """q and k of head dim 48, v of 32 (the reduced MLA's pair), 4 query
    heads over kh kv heads: the plain forward against the reference's
    `chunked_causal_attention` on head-expanded k and v (scaled by q's
    head dim, as MLA is), and the plain backward (dv at v's width) against
    its gradients."""
    b, s, h, hd, hd_v = 2, 19, 4, 48, 32
    rng = np.random.default_rng(kh * 10 + window)
    q, k, v, g = (rng.standard_normal(shp).astype(np.float32)
                  for shp in ((b, s, h, hd), (b, s, kh, hd),
                              (b, s, kh, hd_v), (b, s, h, hd_v)))
    rep = h // kh

    def jfn(jq, jk, jv):
        return jattn.chunked_causal_attention(
            jq, jnp.repeat(jk, rep, axis=2), jnp.repeat(jv, rep, axis=2),
            window=window)
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = ref.attention_fwd_ref(tq, tk, tv, causal=True, window=window)
    assert o.shape == (b, s, h, hd_v) and lse.shape == (b, h, s)
    _close(o, want, OUT_TOL, "out")
    _close(ref.attention_ref(tq, tk, tv, causal=True, window=window), want,
           OUT_TOL, "attention_ref")
    grads = ref.attention_bwd_ref(tq, tk, tv, o, torch.from_numpy(g), lse,
                                  causal=True, window=window)
    for name, got, jg, shp in zip("qkv", grads, jgrads,
                                  (q.shape, k.shape, v.shape)):
        assert got.shape == shp, name
        _close(got, jg, GRAD_TOL, f"d{name}")


def test_recording_forward_on_the_kernel_route_refuses_the_pair():
    """The kernel route (plain=False) at (48, 32), which the backward
    kernel lacks, raises NotImplementedError naming it before anything
    else: here before the launch wrapper would refuse a CPU tensor.  The
    CPU route at the same pair records and differentiates."""
    q = torch.randn(1, 8, 2, 48, requires_grad=True)
    k = torch.randn(1, 8, 2, 48, requires_grad=True)
    v = torch.randn(1, 8, 2, 32, requires_grad=True)
    with pytest.raises(NotImplementedError, match="flash_attention_bwd"):
        ops.FlashAttention.apply(q, k, v, True, 0, False)
    out = ops.flash_attention(q, k, v)
    assert out.shape == (1, 8, 2, 32) and out.grad_fn is not None
    out.sum().backward()
    assert v.grad.shape == v.shape and q.grad.shape == q.shape


# ---------------------------------------------------------------------------
# the MLA block
# ---------------------------------------------------------------------------
def _mla_weights(seed):
    jcfg, tcfg = _cfgs()
    jp = jattn.mla_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _torch_tree(jax.tree.map(np.asarray, jp))


def test_mla_apply_seq_and_its_cache_match_reference():
    jcfg, tcfg, jp, tp = _mla_weights(5)
    assert set(tp) == set(tattn.mla_init(None, tcfg, "meta"))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    jout, jcache = jattn.mla_apply_seq(jp, jcfg, jnp.asarray(x),
                                       jnp.asarray(pos), make_cache=True)
    tout, tcache = tattn.mla_apply_seq(tp, tcfg, torch.from_numpy(x),
                                       torch.from_numpy(pos.copy()),
                                       make_cache=True)
    assert tout.shape == (2, S, jcfg.d_model)
    _close(tout, jout, OUT_TOL, "out")
    assert set(tcache) == set(jcache) == {"c_kv", "k_rope", "slot_pos"}
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        _close(tcache[key], jcache[key], OUT_TOL, key)


def test_mla_decode_over_a_filled_cache_matches_reference():
    """The absorbed form over a cache of 20 slots: 13 filled by the
    prefill of the same weights, the new token's at 13, the rest empty
    (slot_pos -1); output and the new cache against the reference's."""
    jcfg, tcfg, jp, tp = _mla_weights(6)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 14, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))
    _, filled = jattn.mla_apply_seq(jp, jcfg, jnp.asarray(x[:, :13]),
                                    jnp.asarray(pos), make_cache=True)
    cache = {k: np.zeros((2, 20, v.shape[-1]), np.float32)
             for k, v in filled.items() if k != "slot_pos"}
    for k in cache:
        cache[k][:, :13] = np.asarray(filled[k])
    cache["slot_pos"] = np.full(20, -1, np.int32)
    cache["slot_pos"][:13] = np.arange(13)
    jout, jnew = jattn.mla_decode(jp, jcfg, jnp.asarray(x[:, 13:]),
                                  {k: jnp.asarray(v) for k, v in cache.items()},
                                  jnp.asarray(13))
    tcache = {k: torch.from_numpy(v) for k, v in cache.items()}
    tout, tnew = tattn.mla_decode(tp, tcfg, torch.from_numpy(x[:, 13:]),
                                  tcache, 13)
    _close(tout, jout, OUT_TOL, "out")
    for key in jnew:
        _close(tnew[key], jnew[key], OUT_TOL, key)
    assert torch.equal(tcache["slot_pos"], torch.from_numpy(cache["slot_pos"]))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_forward_prefill_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    assert set(tp["prefix"]["0"]) >= {"attn", "ffn"}
    assert tuple(tp["cycles"]["b0"]["attn"]["wkv_b"].shape) == (1, 32, 4, 64)
    tok = _tokens(2, 40, tcfg.vocab_size, seed=5)
    jlog, jaux, jcache = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(tok)},
                                     mode="prefill")
    tlog, taux, tcache = ttf.forward(tp, tcfg,
                                     {"tokens": torch.from_numpy(tok)},
                                     mode="prefill")
    assert tlog.shape == (2, 40, 512)
    _close(tlog, jlog, LOGIT_TOL, "logits")
    np.testing.assert_allclose(float(taux), float(jaux), **OUT_TOL)
    assert float(taux) > 0
    jl = jax.tree_util.tree_leaves_with_path(jcache)
    tl = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tcache)))
    assert len(tl) == len(jl)
    for path, leaf in jl:       # downstream of whole blocks: the logits'
        _close(tl[path], leaf, LOGIT_TOL, jax.tree_util.keystr(path))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_gradient_leaf_match_jax(model, remat):
    """remat "full" is DeepSeek-V2's own setting: the loss and every
    gradient leaf under it and under "none" within GRAD_TOL of
    jax.value_and_grad of the reference's loss under the same remat."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, remat=remat)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    rng = np.random.default_rng(12)
    batch = {k: rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                        for k, v in batch.items()}),
        has_aux=True)(jp)
    leaves = [leaf.detach().clone().requires_grad_()
              for leaf in topt.tree_leaves(tp)]
    params = tts._like_sorted(tp, iter(leaves))
    loss, met = ttf.loss_fn(params, tcfg, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                               rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(grads)
    for (path, jgl), g in zip(jleaves, grads):
        _close(g, jgl, GRAD_TOL, jax.tree_util.keystr(path))
    wkv = [g for (path, _), g in zip(jleaves, grads)
           if "wkv_b" in jax.tree_util.keystr(path)]
    assert len(wkv) == 2 and all(float(g.abs().max()) > 0 for g in wkv)


@pytest.mark.parametrize("nmb", [1, 2])
def test_train_step_three_steps_match_jax(model, nmb):
    """DeepSeek-V2's training setting, as the card runs it: remat "full"
    and int8 moments through `make_train_step`, three AdamW steps at B 4
    against the reference's jitted train step (one microbatch, as on the
    card, and two).  Each step starts from the reference's state before
    it (`train_state_from_jax`): the reference's int8 second moment rounds
    a block's small values to code 0, so the next step divides such a
    weight's first moment by little more than its new gradient, and a
    weight whose gradient is near zero moves by orders of magnitude more
    than lr; the packages' float32 rounding of that gradient moves it
    apart in proportion, and the states part after one such step.
    Held at each step: the loss at rtol 1e-5; every int8 code within one
    of the reference's and 99.9 % of them equal; 99.5 % of each master
    leaf within MASTER_TOL, and every weight whose reference step is at
    most 2 lr (Adam's bound with float32 moments) within 2 lr of it."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, remat="full", microbatches=nmb)
    tcfg = dataclasses.replace(tcfg, remat="full", microbatches=nmb)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=6, int8_state=True)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt.OptConfig(**kw)))
    tstep = tts.make_train_step(tcfg, topt.OptConfig(**kw))
    js = {"opt": jopt.init_opt_state(jp, jopt.OptConfig(**kw))}
    ts = {"opt": topt.init_opt_state(tp, topt.OptConfig(**kw))}
    lr = kw["lr"]
    rng = np.random.default_rng(20 + nmb)
    for step in range(3):
        if step:
            ts = train_state_from_jax(jax.tree.map(np.asarray, js), tcfg,
                                      int8_state=True, device="cpu")
        before = [np.asarray(w) for w in
                  jax.tree_util.tree_leaves(js["opt"]["master"])]
        b = {k: _tokens(4, S, tcfg.vocab_size, int(rng.integers(1 << 30)))
             for k in ("tokens", "labels")}
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == step + 1
        want = jax.tree.map(np.asarray, js["opt"])
        codes = 0
        for mom in ("m", "v"):
            jl = dict(jax.tree_util.tree_leaves_with_path(want[mom]))
            for (path, w), g in zip(jl.items(),
                                    topt.tree_leaves(ts["opt"][mom])):
                if g.dtype != torch.int8:
                    continue
                d = np.abs(g.numpy().astype(int) - w.astype(int))
                assert d.max() <= 1 and (d == 0).mean() >= 0.999, \
                    jax.tree_util.keystr(path)
                codes += 1
        assert codes > 0
        for g, w, w0 in zip(topt.tree_leaves(ts["opt"]["master"]),
                            jax.tree_util.tree_leaves(want["master"]),
                            before):
            g = g.numpy()
            assert np.isclose(g, w, **MASTER_TOL).mean() >= 0.995
            bounded = np.abs(w - w0) <= 2 * lr
            np.testing.assert_allclose(g[bounded], w[bounded], rtol=0,
                                       atol=2 * lr)


def test_teacher_forced_decode_matches_reference_and_forward():
    """Capacity factor 8.0 (no choice dropped; the reference's decode test
    excludes drops, tests/test_models_smoke.py:61-65).  Prefill 20 tokens,
    then decode 12 more teacher-forced through the absorbed form, each
    step's logits against the reference's decode_step and the port's own
    expanded-form forward."""
    jcfg, tcfg = _cfgs(capacity_factor=8.0)
    jp = jtf.init_params(jax.random.PRNGKey(4), jcfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tok = _tokens(2, 32, tcfg.vocab_size, seed=6)
    s0 = 20
    full, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)})
    _, _, jcache = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(tok[:, :s0])},
                               mode="prefill")
    _, _, tcache = ttf.forward(tp, tcfg,
                               {"tokens": torch.from_numpy(tok[:, :s0])},
                               mode="prefill")
    # the prefill's caches grown to the sequence, as both packages' serve
    # grows them
    jcache = jax.tree_util.tree_map_with_path(
        lambda path, l: _jgrow(path, l, s0, 32 - s0), jcache)
    tcache = tserve._grow(tcache, s0, 32 - s0)
    jdecode = jax.jit(lambda c, t, pos: jtf.decode_step(jp, jcfg, t, c, pos))
    for pos in range(s0, 32):
        step = tok[:, pos:pos + 1]
        jlog, jcache = jdecode(jcache, jnp.asarray(step), jnp.asarray(pos))
        tlog, tcache = ttf.decode_step(tp, tcfg, torch.from_numpy(step),
                                       tcache, pos)
        _close(tlog, jlog, LOGIT_TOL, f"position {pos}")
        _close(tlog[:, 0], full[:, pos], DECODE_TOL, f"position {pos}")


def _jgrow(path, leaf, prompt_len, gen):
    """The reference serve's `grow` on one leaf of a prefill cache."""
    key = path[-1].key
    if key == "slot_pos":
        pad = [(0, 0)] * leaf.ndim
        pad[-1] = (0, gen)
        return jnp.pad(leaf, pad, constant_values=-1)
    pad = [(0, 0)] * leaf.ndim
    pad[-2] = (0, gen)                        # c_kv, k_rope (..., S, r)
    return jnp.pad(leaf, pad)


def test_serve_matches_reference_serve():
    """The reference's own serve (prompt 12, 8 tokens) against the port's
    on its weights: the tokens equal up to the first step whose
    reference top-2 margin is at most MARGIN."""
    jcfg, tcfg = _cfgs()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)   # jserve's weights
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    want, _ = jserve.serve(jcfg, 2, 12, 8, seed=0)
    got = tserve.serve(tcfg, 2, 12, 8, seed=0, device="cpu", params=tp)
    assert got.tokens.shape == want.shape == (2, 8)
    prompt = tpipeline.make_batch(tpipeline.DataConfig(512, 20, 2, seed=0),
                                  0)["tokens"][:, :12]
    t0 = np.asarray(jtf.forward(jp, jcfg, {"tokens": jnp.asarray(prompt)})[0]
                    [:, -1])
    seq = np.concatenate([prompt, t0.argmax(-1)[:, None], want[:, :-1]], 1)
    logits = np.asarray(jtf.forward(jp, jcfg,
                                    {"tokens": jnp.asarray(seq)})[0][:, 12:])
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


def test_init_decode_cache_matches_reference_layout():
    jcfg, tcfg = _cfgs()
    jc = jtf.init_decode_cache(jcfg, 2, 24)
    tc = ttf.init_decode_cache(tcfg, 2, 24, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jc)
    tl = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tc)))
    assert len(tl) == len(jl)
    for path, leaf in jl:
        assert tl[path].shape == leaf.shape, path
        assert np.array_equal(tl[path], np.asarray(leaf)), path
    assert tl[(jax.tree_util.DictKey("prefix"), jax.tree_util.DictKey("0"),
               jax.tree_util.DictKey("c_kv"))].shape == (2, 24, 32)
