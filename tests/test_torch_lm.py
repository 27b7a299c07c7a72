"""The port's LM serving path against the JAX package, on the CPU.

RecurrentGemma at `get_reduced_config("recurrentgemma-9b")` in float32 (as
tests/test_models_smoke.py runs it): the JAX package makes the weights,
`repro_torch.convert.lm_params_from_jax` carries them across, and the
same tokens, made with seeded numpy, go through both packages.  On the
CPU the port's prefill runs the plain versions of its two kernels
(`ref.attention_ref`, `ref.rglru_scan_ref`), which tests/test_torch_kernels
holds against the JAX kernels' references.

Tolerances: 2e-5 on a block's output (float32, the kernels' tolerance;
the two packages sum in other orders), 1e-4 on logits.  Greedy tokens are
compared where the reference's top-2 logit margin exceeds 1e-3; past a
step with a smaller margin the two runs may rightly continue differently,
and the test says so.  Nothing here makes weights of the full-size
config: its parameter count is taken from shapes alone."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttf

ARCH = "recurrentgemma-9b"
BLOCK_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-3


def _cfgs():
    return (dataclasses.replace(jconfigs.get_reduced_config(ARCH),
                                dtype="float32"),
            dataclasses.replace(tconfigs.get_reduced_config(ARCH),
                                dtype="float32"))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), **tol, err_msg=what)


# ---------------------------------------------------------------------------
# configs, data, layers
# ---------------------------------------------------------------------------
def test_configs_are_the_reference_configs():
    assert tconfigs.ARCHS == ("recurrentgemma-9b", "smollm-360m")
    for arch in tconfigs.ARCHS:
        for name in ("get_config", "get_reduced_config"):
            t, j = getattr(tconfigs, name)(arch), getattr(jconfigs, name)(arch)
            # the port's one added field states what the reference's model
            # reads from the name (src/repro/models/transformer.py:205)
            fields = dataclasses.asdict(t)
            assert fields.pop("embed_scale") == j.name.startswith(
                "recurrentgemma")
            assert fields == dataclasses.asdict(j)
            assert t.layer_kinds() == j.layer_kinds()
            assert t.param_count() == j.param_count()
    with pytest.raises(KeyError, match="not yet ported"):
        tconfigs.get_config("mixtral-8x7b")


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_make_batch_matches_reference(seed, step):
    args = dict(vocab_size=512, seq_len=24, global_batch=3, seed=seed)
    t = tpipeline.make_batch(tpipeline.DataConfig(**args), step)
    j = jpipeline.make_batch(jpipeline.DataConfig(**args), step)
    for key in ("tokens", "labels"):
        assert t[key].dtype == j[key].dtype
        assert np.array_equal(t[key], j[key])


def test_param_count_exact_from_shapes_matches_reference():
    """Both counts come from shapes alone (meta tensors; jax.eval_shape):
    the full config's 8.6 B parameters are never allocated."""
    cfg = tconfigs.get_config(ARCH)
    assert ttf.param_count_exact(cfg) == jtf.param_count_exact(
        jconfigs.get_config(ARCH))


def test_layers_match_reference():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    _close(tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x), 1e-6),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-6), dict(rtol=1e-6, atol=1e-6), "rmsnorm")
    xh = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) + 1000, (2, 9))
    _close(tlayers.apply_rope(torch.from_numpy(xh),
                              torch.from_numpy(pos.copy()), tcfg),
           jlayers.apply_rope(jnp.asarray(xh), jnp.asarray(pos), jcfg),
           dict(rtol=1e-5, atol=1e-5), "apply_rope")
    ffn = {k: rng.standard_normal(s).astype(np.float32) * 0.1
           for k, s in (("wi", (128, 256)), ("wg", (128, 256)),
                        ("wdown", (256, 128)))}
    _close(tlayers.ffn_apply({k: torch.from_numpy(v) for k, v in ffn.items()},
                             tcfg, torch.from_numpy(x)),
           jlayers.ffn_apply({k: jnp.asarray(v) for k, v in ffn.items()},
                             jcfg, jnp.asarray(x)), BLOCK_TOL, "ffn_apply")
    _close(tlayers.softcap(torch.from_numpy(x * 50), 30.0),
           jlayers.softcap(jnp.asarray(x * 50), 30.0),
           dict(rtol=1e-6, atol=1e-5), "softcap")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _hidden(seed, s=40):
    return np.random.default_rng(seed).standard_normal(
        (2, s, 128)).astype(np.float32)


def test_rglru_apply_seq_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    x = _hidden(3)
    jout, jcache = jrglru.rglru_apply_seq(
        jax.tree.map(lambda a: a[0], jp["cycles"]["b0"]["mix"]), jcfg,
        jnp.asarray(x), make_cache=True)
    tout, tcache = trglru.rglru_apply_seq(
        ttf._cycle(tp["cycles"], 0)["b0"]["mix"], tcfg, torch.from_numpy(x),
        make_cache=True)
    _close(tout, jout, BLOCK_TOL, "out")
    assert set(tcache) == set(jcache)
    for key in jcache:
        _close(tcache[key], jcache[key], BLOCK_TOL, key)


@pytest.mark.parametrize("kind", ["local", "full"])
def test_attn_apply_seq_matches_reference(model, kind):
    """S = 40 past the window of 16: the local kind attends over the band
    and keeps a ring of 16 slots."""
    jcfg, tcfg, jp, tp = model
    x = _hidden(4)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    jout, jcache = jattn.attn_apply_seq(
        jax.tree.map(lambda a: a[0], jp["cycles"]["b2"]["attn"]), jcfg,
        kind, jnp.asarray(x), jnp.asarray(pos), make_cache=True)
    tout, tcache = tattn.attn_apply_seq(
        ttf._cycle(tp["cycles"], 0)["b2"]["attn"], tcfg, kind,
        torch.from_numpy(x), torch.from_numpy(pos.copy()), make_cache=True)
    _close(tout, jout, BLOCK_TOL, "out")
    assert set(tcache) == set(jcache)
    _close(tcache["k"], jcache["k"], BLOCK_TOL, "k")
    _close(tcache["v"], jcache["v"], BLOCK_TOL, "v")
    assert np.array_equal(tcache["slot_pos"].numpy(),
                          np.asarray(jcache["slot_pos"]))
    assert tcache["k"].shape[1] == (16 if kind == "local" else 40)


# ---------------------------------------------------------------------------
# the model: prefill, decode, serve
# ---------------------------------------------------------------------------
def test_forward_prefill_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    tok = _tokens(2, 40, tcfg.vocab_size, seed=5)
    jlog, jaux, jcache = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(tok)},
                                     mode="prefill")
    tlog, taux, tcache = ttf.forward(tp, tcfg,
                                     {"tokens": torch.from_numpy(tok)},
                                     mode="prefill")
    assert tlog.dtype == torch.float32 and tlog.shape == (2, 40, 512)
    _close(tlog, jlog, LOGIT_TOL, "logits")
    assert float(taux) == float(jaux) == 0.0
    jl = jax.tree_util.tree_leaves_with_path(jcache)
    tl = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tcache)))
    assert len(tl) == len(jl)
    for path, leaf in jl:
        _close(tl[path], leaf, BLOCK_TOL, jax.tree_util.keystr(path))


def test_teacher_forced_decode_past_the_window_matches_reference(model):
    """Prefill 20 tokens (past the window of 16: the ring holds the last
    16), then decode 20 more teacher-forced, the ring wrapping; every
    step's logits against the reference's decode_step."""
    jcfg, tcfg, jp, tp = model
    tok = _tokens(2, 40, tcfg.vocab_size, seed=6)
    s0 = 20
    _, _, jcache = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(tok[:, :s0])},
                               mode="prefill")
    _, _, tcache = ttf.forward(tp, tcfg,
                               {"tokens": torch.from_numpy(tok[:, :s0])},
                               mode="prefill")
    jdecode = jax.jit(lambda c, t, pos: jtf.decode_step(jp, jcfg, t, c, pos))
    for pos in range(s0, 40):
        step = tok[:, pos:pos + 1]
        jlog, jcache = jdecode(jcache, jnp.asarray(step), jnp.asarray(pos))
        tlog, tcache = ttf.decode_step(tp, tcfg, torch.from_numpy(step),
                                       tcache, pos)
        _close(tlog, jlog, LOGIT_TOL, f"position {pos}")


def _greedy_margins(jp, jcfg, prompt, generated):
    """The reference's logits, teacher-forced, at the positions that chose
    each generated token -> (argmax, top-2 margin), each (B, gen).  Serve
    returns the tokens after the prefill's own choice t0, so the sequence
    is prompt + t0 + generated[:-1], and step 0 also carries t0's margin."""
    def top2(logits):
        srt = np.sort(np.asarray(logits), axis=-1)
        return np.asarray(logits).argmax(-1), srt[..., -1] - srt[..., -2]

    t0, m0 = top2(jtf.forward(jp, jcfg, {"tokens": jnp.asarray(prompt)})[0]
                  [:, -1])
    seq = np.concatenate([prompt, t0[:, None], generated[:, :-1]], axis=1)
    logits, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(seq)})
    argmax, margin = top2(logits[:, prompt.shape[1]:])
    margin[:, 0] = np.minimum(margin[:, 0], m0)
    return argmax, margin


def _compare_tokens(got, want, margin, what):
    """Equal tokens at every step up to the first whose reference margin
    is at most MARGIN; after it the runs may rightly differ."""
    for row in range(got.shape[0]):
        small = np.flatnonzero(margin[row] <= MARGIN)
        upto = small[0] if len(small) else got.shape[1]
        if upto < got.shape[1]:
            warnings.warn(f"{what}, row {row}: the reference's top-2 margin "
                          f"at step {upto} is {margin[row, upto]:.2e} "
                          f"<= {MARGIN}; steps {upto}.. not compared")
        assert np.array_equal(got[row, :upto], want[row, :upto]), (row, upto)


def test_serve_matches_reference_serve(model):
    """The reference's own serve (prompt 12 inside the window, 8 tokens,
    so decode passes the window) against the port's on its weights."""
    jcfg, tcfg, _, _ = model
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)   # jserve's weights
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    want, _ = jserve.serve(jcfg, 2, 12, 8, seed=0)
    got = tserve.serve(tcfg, 2, 12, 8, seed=0, device="cpu", params=tp)
    assert got.tokens.shape == want.shape == (2, 8)
    assert got.decode_s.shape == (8,) and got.prefill_s > 0
    prompt = tpipeline.make_batch(tpipeline.DataConfig(512, 20, 2, seed=0),
                                  0)["tokens"][:, :12]
    argmax, margin = _greedy_margins(jp, jcfg, prompt, want)
    assert np.array_equal(argmax, want)       # the reference is greedy
    _compare_tokens(got.tokens, want, margin, "serve, prompt 12")


def test_serve_past_the_window_matches_reference_forward(model):
    """Prompt 24 past the window of 16, so the prefill leaves rings that
    decode wraps.  The reference's serve cannot decode there (it pads the
    ring's slot_pos and fails to broadcast), so each generated token is
    held against the reference forward's greedy choice on the same
    sequence."""
    jcfg, tcfg, jp, tp = model
    got = tserve.serve(tcfg, 2, 24, 8, seed=3, device="cpu", params=tp)
    prompt = tpipeline.make_batch(tpipeline.DataConfig(512, 32, 2, seed=3),
                                  0)["tokens"][:, :24]
    argmax, margin = _greedy_margins(jp, jcfg, prompt, got.tokens)
    _compare_tokens(got.tokens, argmax, margin, "serve, prompt 24")


def test_serve_main_prints_the_lotaru_line(capsys):
    toks = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "20", "--gen", "5"])
    assert toks.shape == (2, 5)
    out = capsys.readouterr().out
    assert "lotaru next-token prediction" in out and "prefill" in out


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


def test_lm_params_from_jax_checks_the_layout(model):
    jcfg, tcfg, jp, _ = model
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, final_norm={})
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_jax(bad, tcfg, "cpu")
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_jax(bad, tcfg, "cpu")
    bad = dict(tree, embed=tree["embed"].astype(np.float64))
    with pytest.raises(TypeError, match="dtype"):
        lm_params_from_jax(bad, tcfg, "cpu")


def test_unported_block_kinds_raise():
    _, tcfg = _cfgs()
    for kw in (dict(block_pattern=("mlstm",)), dict(num_experts=4, top_k=2),
               dict(cross_attn=True)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ttf.init_params(0, dataclasses.replace(tcfg, **kw), "cpu")
