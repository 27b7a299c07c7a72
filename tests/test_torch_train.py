"""The port's training path against the JAX package, on the CPU.

The reduced configs in float32 (`smollm-360m` with `pad_heads_multiple=4`,
3 heads padded to 4, `recurrentgemma-9b` at S = 40 past its window of
16, `mixtral-8x7b` alone and with a dense prefix layer and a shared
expert, `yi-6b`, `glm4-9b` and `starcoder2-15b`; the MoE's auxiliary loss
is in the loss); the JAX package makes the weights and
`repro_torch.convert` carries them across; the same tokens, made with
seeded numpy, go through both packages.  On the CPU the port's
attention and scan take their plain versions, forward and backward
(tests/test_torch_train_kernels.py holds those against the JAX
gradients).

Tolerances (float32; the two packages sum in other orders): the loss
rtol 1e-6; every gradient leaf rtol 1e-4 / atol 1e-5; master weights
after three train steps: at least 99.9 % of each leaf within rtol 1e-5 /
atol 1e-5, and every element within 2 lr a step (Adam divides a gradient
by its own running RMS, so a weight whose gradient is near zero moves by
up to lr whatever the gradient's size, and the gradients' float32
differences move a few such weights by a good part of lr);
the optimizer's pieces on the same gradients rtol 1e-6 / atol 1e-7 (lr,
dequantized moments), the int8 codes exact after one quantization and
within one code after three steps.
Pad heads' gradient rows are exactly zero in both packages.  The port
against itself (resume, padded heads) is held bitwise, and checkpoints
are compared leaf for leaf, bitwise."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import init_params as jinit
from repro.models import transformer as jtf
from repro.perf import roofline as jroof
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch.convert import (lm_params_from_jax, train_state_from_jax,
                                 train_state_to_jax)
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttf
from repro_torch.perf import roofline as troof
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MASTER_TOL = dict(rtol=1e-5, atol=1e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
# (arch, config changes, S)
PREFIX_SHARED = dict(first_dense_layers=1, dense_d_ff=192,
                     num_shared_experts=1)
MODELS = (("smollm-360m", dict(pad_heads_multiple=4), 24),
          ("recurrentgemma-9b", {}, 40),
          ("mixtral-8x7b", {}, 24),
          ("mixtral-8x7b", PREFIX_SHARED, 24),
          ("yi-6b", {}, 24),
          ("glm4-9b", {}, 24),
          ("starcoder2-15b", {}, 24))
MODEL_IDS = ("smollm-360m", "recurrentgemma-9b", "mixtral-8x7b",
             "mixtral-8x7b-prefix-shared", "yi-6b", "glm4-9b",
             "starcoder2-15b")


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_reduced_config(arch),
                                dtype="float32", **kw),
            dataclasses.replace(tconfigs.get_reduced_config(arch),
                                dtype="float32", **kw))


def _batch(cfg, s, b=2, seed=1, step=0):
    return jpipeline.make_batch(jpipeline.DataConfig(cfg.vocab_size, s, b,
                                                     seed=seed), step)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {"/".join(p): leaf for p, leaf in topt.tree_items(tree)}


@pytest.fixture(scope="module", params=MODELS, ids=MODEL_IDS)
def model(request):
    arch, kw, s = request.param
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = jinit(jax.random.PRNGKey(3), jcfg)
    tp = lm_params_from_jax(_np_tree(jp), tcfg, "cpu")
    return arch, jcfg, tcfg, jp, tp, s


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
def test_loss_and_every_gradient_leaf_match_jax(model):
    arch, jcfg, tcfg, jp, tp, s = model
    b = _batch(jcfg, s)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                        for k, v in b.items()}),
        has_aux=True)(jp)
    leaves = [leaf.detach().clone().requires_grad_()
              for leaf in topt.tree_leaves(tp)]
    params = tts._like_sorted(tp, iter(leaves))
    tl, tmet = ttf.loss_fn(params, tcfg, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
    grads = torch.autograd.grad(tl, topt.tree_leaves(params))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["ce"].detach()), float(jmet["ce"]),
                               rtol=1e-6)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(grads)
    for (path, jgl), g in zip(jleaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgl), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    if tcfg.padded_heads != tcfg.num_heads:
        flat = dict(zip(["/".join(p) for p, _ in topt.tree_items(params)],
                        grads))
        h = tcfg.num_heads
        jflat = {jax.tree_util.keystr(p): x for p, x in jleaves}
        for name, g in flat.items():
            if name.endswith("attn/wq"):
                assert not torch.any(g[..., h:, :])
                assert torch.all(g[..., :h, :].abs().amax((1, 3)) > 0)
            if name.endswith("attn/wo"):
                assert not torch.any(g[:, h:])
        assert not any(np.any(np.asarray(x)[..., h:, :])
                       for k, x in jflat.items() if k.endswith("['wq']"))


def test_cross_entropy_with_a_mask_matches_jax():
    from repro.models.layers import cross_entropy as jce
    from repro_torch.models.layers import cross_entropy as tce
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jce(jnp.asarray(logits), jnp.asarray(labels),
                   None if m is None else jnp.asarray(m))
        got = tce(torch.from_numpy(logits), torch.from_numpy(labels),
                  None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)


def test_padded_heads_equivalent_to_unpadded():
    """zero-padded attention heads == the unpadded model, in the port:
    logits bitwise (the pad heads never run)."""
    _, cfg0 = _cfgs("smollm-360m", pad_heads_multiple=0)
    cfg1 = dataclasses.replace(cfg0, pad_heads_multiple=4)
    p0 = ttf.init_params(5, cfg0, "cpu")
    p1 = ttf.init_params(5, cfg1, "cpu")

    def pad_like(a, b):
        if a.shape == b.shape:
            return a
        out = torch.zeros_like(b)
        out[tuple(slice(0, n) for n in a.shape)] = a
        return out
    p1 = topt.tree_map(pad_like, p0, p1)
    assert p1["cycles"]["b0"]["attn"]["wq"].shape[-2] == 4
    tok = torch.from_numpy(_batch(cfg0, 16)["tokens"])
    l0, _ = ttf.forward(p0, cfg0, {"tokens": tok})
    l1, _ = ttf.forward(p1, cfg1, {"tokens": tok})
    assert torch.equal(l0, l1)


def test_smollm_config_pads_15_heads_to_16():
    cfg = tconfigs.get_config("smollm-360m")
    assert (cfg.num_heads, cfg.padded_heads, cfg.num_kv_heads) == (15, 16, 5)
    p = ttf.init_params(0, cfg, device="meta")
    assert tuple(p["cycles"]["b0"]["attn"]["wq"].shape) == (32, 960, 16, 64)
    shapes = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0),
                                          jconfigs.get_config("smollm-360m")))
    assert ttf.param_count_exact(cfg) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_lr_schedule_matches_jax():
    oc = topt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    joc = jopt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(topt.lr_at(oc, step)),
                                   float(jopt.lr_at(joc, step)), **OPT_TOL)


def test_int8_moments_match_jax():
    rng = np.random.default_rng(1)
    for shape in ((8, 256), (3, 128), (5,), (4, 100)):
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        x.flat[0] = 0.5 * 3 / 127 * 7          # ties land on .5 exactly
        t, j = topt._q8(torch.from_numpy(x)), jopt._q8(jnp.asarray(x))
        assert (t["scale"] is None) == (j["scale"] is None)
        if j["scale"] is None:
            assert torch.equal(t["q"], torch.from_numpy(x))
            continue
        np.testing.assert_allclose(t["scale"].numpy(), np.asarray(j["scale"]),
                                   rtol=1e-7)
        assert t["q"].dtype == torch.int8
        np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
        np.testing.assert_allclose(topt._dq8(t).numpy(),
                                   np.asarray(jopt._dq8(j)), **OPT_TOL)


def test_round_is_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5])
    assert torch.round(x).tolist() == jnp.round(jnp.asarray(x.numpy())
                                                ).tolist()


def _opt_trees(rng):
    params = {"w": rng.standard_normal((4, 256)).astype(np.float32),
              "b": {"bias": rng.standard_normal(7).astype(np.float32),
                    "a": rng.standard_normal((3, 128)).astype(np.float32)}}
    grads = [topt.tree_map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32) * 0.3, params) for _ in range(3)]
    return params, grads


def test_global_norm_walks_the_reference_order():
    params, _ = _opt_trees(np.random.default_rng(2))
    assert [n for n, _ in topt.tree_items(params)] == [
        ("b", "a"), ("b", "bias"), ("w",)]
    got = topt.global_norm(topt.tree_map(torch.from_numpy, params))
    np.testing.assert_allclose(float(got), float(jopt.global_norm(params)),
                               rtol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
def test_adamw_three_steps_match_jax(int8):
    params, grads = _opt_trees(np.random.default_rng(3))
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=0.5,
              int8_state=int8)
    toc, joc = topt.OptConfig(**kw), jopt.OptConfig(**kw)
    ts = topt.init_opt_state(topt.tree_map(torch.from_numpy, params), toc)
    js = jopt.init_opt_state(jax.tree.map(jnp.asarray, params), joc)
    for g in grads:
        _, ts, tm = topt.adamw_update(topt.tree_map(torch.from_numpy, g), ts,
                                      toc)
        _, js, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, g), js, joc)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   **OPT_TOL)
    assert int(ts["step"]) == int(js["step"]) == 3
    want = _np_tree(js)
    for name, leaf in _flat(ts).items():
        w = want
        for part in name.split("/"):
            w = w[part]
        if leaf.dtype == torch.int8:       # a code may differ by one ulp
            assert np.abs(leaf.numpy().astype(int) - w.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(leaf.numpy(), w, **MASTER_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("int8", [False, True])
def test_sliced_update_is_bitwise_the_whole_leaf_update(int8, monkeypatch):
    """Leaves above `UPDATE_SLICE` elements are updated a slice of rows at
    a time: with the limit at 512 elements (a (3, 5, 256) leaf in slices
    of 2 rows, a ragged (40, 100) one, whose int8 moments stay float32, in
    slices of 5, a bfloat16 gradient among them), three steps leave the
    master, m and v bitwise what the whole-leaf update leaves."""
    rng = np.random.default_rng(11)
    params = {"big": rng.standard_normal((3, 5, 256)).astype(np.float32),
              "ragged": rng.standard_normal((40, 100)).astype(np.float32),
              "small": rng.standard_normal((2, 128)).astype(np.float32)}
    grads = [topt.tree_map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32) * 0.3, params) for _ in range(3)]
    oc = topt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                        clip_norm=0.5, int8_state=int8)
    sliced = []
    whole_update = topt._update_in_slices

    def counted(*a, **k):
        sliced.append(a[1].shape)
        return whole_update(*a, **k)
    monkeypatch.setattr(topt, "_update_in_slices", counted)

    def run(limit):
        monkeypatch.setattr(topt, "UPDATE_SLICE", limit)
        st = topt.init_opt_state(topt.tree_map(torch.from_numpy, params), oc)
        for g in grads:
            g = topt.tree_map(torch.from_numpy, g)
            g["big"] = g["big"].bfloat16()
            _, st, _ = topt.adamw_update(g, st, oc)
        return st
    want = _flat(run(1 << 30))
    assert not sliced
    got = _flat(run(512))
    assert sorted(set(sliced)) == [(3, 5, 256), (40, 100)]
    assert len(sliced) == 6
    assert got.keys() == want.keys()
    for name, leaf in got.items():
        assert leaf.dtype == want[name].dtype, name
        assert torch.equal(leaf, want[name]), name


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nmb", [1, 2])
def test_train_step_three_steps_match_jax(model, nmb):
    arch, jcfg, tcfg, jp, tp, s = model
    jcfg = dataclasses.replace(jcfg, microbatches=nmb)
    tcfg = dataclasses.replace(tcfg, microbatches=nmb)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=6)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt.OptConfig(**kw)))
    tstep = tts.make_train_step(tcfg, topt.OptConfig(**kw))
    js = {"opt": jopt.init_opt_state(jp, jopt.OptConfig(**kw))}
    ts = {"opt": topt.init_opt_state(tp, topt.OptConfig(**kw))}
    for step in range(3):
        b = _batch(jcfg, s, b=4, step=step)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    want = jax.tree_util.tree_leaves(js["opt"]["master"])
    got = topt.tree_leaves(ts["opt"]["master"])
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        close = np.isclose(g, w, **MASTER_TOL)
        assert close.mean() >= 0.999
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * kw["lr"] * 3)


@pytest.mark.parametrize("n", [2, 3])
def test_microbatch_split_matches_jax_with_mrope_positions(n):
    """Tokens, labels (B, S) and M-RoPE positions (3, B, S), B = 6: every
    microbatch equal to the reference's, rows i, n + i, ... of each key."""
    rng = np.random.default_rng(n)
    b, s = 6, 5
    batch = {"tokens": rng.integers(0, 100, (b, s), dtype=np.int32),
             "labels": rng.integers(0, 100, (b, s), dtype=np.int32),
             "positions": rng.integers(0, 50, (3, b, s), dtype=np.int32)}
    want = jts._split_microbatches({k: jnp.asarray(v)
                                    for k, v in batch.items()}, n)
    got = tts._split_microbatches({k: torch.from_numpy(v)
                                   for k, v in batch.items()}, n)
    assert len(got) == n
    for i, mb in enumerate(got):
        assert set(mb) == set(batch)
        for k, v in mb.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k][i]))
        np.testing.assert_array_equal(mb["positions"].numpy(),
                                      batch["positions"][:, i::n])
        np.testing.assert_array_equal(mb["tokens"].numpy(),
                                      batch["tokens"][i::n])


def test_cast_params_keeps_the_reference_fp32_leaves():
    _, tcfg = _cfgs("recurrentgemma-9b")
    master = topt.init_opt_state(ttf.init_params(0, tcfg, "cpu"),
                                 topt.OptConfig())["master"]
    cast = tts.cast_params(master, torch.bfloat16)
    for (path, c), (_, m) in zip(topt.tree_items(cast),
                                 topt.tree_items(master)):
        keep = path[-1] in tts._KEEP_FP32
        assert c.dtype == (torch.float32 if keep else torch.bfloat16), path
        assert (c is m) == keep


def test_train_resume_bitwise_equivalent():
    """6 steps straight == 3, checkpoint, restore, 3 (the port alone)."""
    _, cfg = _cfgs("smollm-360m")
    oc = topt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=6)
    step_fn = tts.make_train_step(cfg, oc)

    def run(state, lo, hi):
        losses = []
        for s in range(lo, hi):
            b = tpipeline.make_batch(tpipeline.DataConfig(cfg.vocab_size, 16,
                                                          2, seed=0), s)
            state, m = step_fn(state, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
            losses.append(float(m["loss"]))
        return state, losses

    s_a, losses_a = run(tts.init_train_state(0, cfg, oc, "cpu"), 0, 6)
    s_b, l1 = run(tts.init_train_state(0, cfg, oc, "cpu"), 0, 3)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        tckpt.save_checkpoint(d, 3, s_b)
        like = tts.init_train_state(1, cfg, oc, "cpu")
        step, s_c, _ = tckpt.restore_checkpoint(d, like)
    assert step == 3
    s_c, l2 = run(s_c, 3, 6)
    assert losses_a == l1 + l2
    for a, c in zip(topt.tree_leaves(s_a), topt.tree_leaves(s_c)):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def states():
    """The same train state in both packages (SmolLM reduced, one AdamW
    step so the moments are not zero)."""
    jcfg, tcfg = _cfgs("smollm-360m")
    joc = jopt.OptConfig(warmup_steps=1, total_steps=4)
    js = {"opt": jopt.init_opt_state(jinit(jax.random.PRNGKey(2), jcfg),
                                     joc)}
    b = _batch(jcfg, 8)
    js, _ = jax.jit(jts.make_train_step(jcfg, joc))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    return jcfg, tcfg, js, train_state_from_jax(_np_tree(js), tcfg,
                                                device="cpu")


def _equal_trees(t_state, j_state):
    got = _flat(t_state)
    want = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(j_state)}
    assert set(got) == set(want)
    for k, x in got.items():
        w = want[k]
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16).numpy().view(np.uint16)
            w = w.view(np.uint16)
        else:
            x = x.numpy()
        assert x.dtype == w.dtype and np.array_equal(x, w), k


def test_checkpoints_cross_both_ways(states, tmp_path):
    jcfg, tcfg, js, ts = states
    tckpt.save_checkpoint(str(tmp_path / "t"), 5, ts, {"arch": "x"})
    step, got, meta = jckpt.restore_checkpoint(str(tmp_path / "t"), js)
    assert step == 5 and meta == {"arch": "x", "step": 5}
    _equal_trees(ts, got)
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, js)
    like = train_state_from_jax(_np_tree(js), tcfg, device="cpu")
    step, got, _ = tckpt.restore_checkpoint(str(tmp_path / "j"), like)
    assert step == 7
    _equal_trees(got, js)
    # the files hold the same keys, dtypes and bytes
    with np.load(tmp_path / "t" / "ckpt_00000005.npz") as a, \
            np.load(tmp_path / "j" / "ckpt_00000007.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__meta__":
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_bf16_leaves_round_trip_across_packages(tmp_path):
    jcfg, tcfg = _cfgs("smollm-360m")
    jp = jinit(jax.random.PRNGKey(4), dataclasses.replace(jcfg,
                                                          dtype="bfloat16"))
    jckpt.save_checkpoint(str(tmp_path), 1, {"p": jp})
    like = {"p": lm_params_from_jax(_np_tree(jp), dataclasses.replace(
        tcfg, dtype="bfloat16"), "cpu")}
    _, got, _ = tckpt.restore_checkpoint(str(tmp_path), like)
    _equal_trees(got, {"p": jp})
    tckpt.save_checkpoint(str(tmp_path / "t"), 2, got)
    _, back, _ = jckpt.restore_checkpoint(str(tmp_path / "t"), {"p": jp})
    _equal_trees(got, back)


def test_corrupt_checkpoint_falls_back_and_gc_keeps_three(states, tmp_path):
    _, _, _, ts = states
    d = str(tmp_path)
    for step in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(d, step, ts)
    assert sorted(os.listdir(d)) == [f"ckpt_{s:08d}.npz" for s in (3, 4, 5)]
    assert tckpt.latest_step(d) == 5
    with open(os.path.join(d, "ckpt_00000005.npz"), "wb") as f:
        f.write(b"not a checkpoint")
    step, _, _ = tckpt.restore_checkpoint(d, ts)
    assert step == 4
    assert tckpt.restore_checkpoint(str(tmp_path / "none"), ts) is None


def test_async_checkpointer_copies_before_its_thread(states, tmp_path):
    _, _, _, ts = states
    state = topt.tree_map(lambda x: x.clone(), ts)
    ck = tckpt.AsyncCheckpointer(str(tmp_path))
    ck.save(9, state, {"arch": "a"})
    for leaf in topt.tree_leaves(state):      # the caller moves on at once
        leaf.zero_()
    ck.wait()
    _, got, meta = tckpt.restore_checkpoint(str(tmp_path), ts)
    assert meta["arch"] == "a"
    for a, b in zip(topt.tree_leaves(got), topt.tree_leaves(ts)):
        assert torch.equal(a, b)


def test_train_state_converts_both_ways(states):
    jcfg, tcfg, js, ts = states
    _equal_trees(ts, js)
    back = train_state_to_jax(ts)
    _equal_trees(ts, back)
    j8 = {"opt": jopt.init_opt_state(jinit(jax.random.PRNGKey(0), jcfg),
                                     jopt.OptConfig(int8_state=True))}
    t8 = train_state_from_jax(_np_tree(j8), tcfg, int8_state=True,
                              device="cpu")
    _equal_trees(t8, j8)
    bad = _np_tree(js)
    bad["opt"]["m"] = j8["opt"]["m"]
    with pytest.raises(ValueError):
        train_state_from_jax(bad, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# data, the launcher, the roofline
# ---------------------------------------------------------------------------
def test_data_iterator_resumes_at_a_step():
    dc = tpipeline.DataConfig(vocab_size=300, seq_len=8, global_batch=2,
                              seed=4)
    it = tpipeline.data_iterator(dc, start_step=3)
    for step in (3, 4, 5):
        got = next(it)
        want = jpipeline.make_batch(jpipeline.DataConfig(300, 8, 2, seed=4),
                                    step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
    it.close()


def test_byte_tokenizer_matches_reference():
    t, j = tpipeline.ByteTokenizer(), jpipeline.ByteTokenizer()
    s = "lotaru predicts runtimes: äöü"
    np.testing.assert_array_equal(t.encode(s), j.encode(s))
    assert t.decode(t.encode(s)) == s == j.decode(j.encode(s))
    assert t.vocab_size == j.vocab_size == 256


def test_launch_train_runs_resumes_and_learns(tmp_path, capsys):
    d = str(tmp_path)
    args = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--log-every", "10",
            "--ckpt-dir", d]
    losses = tlaunch.main(args + ["--steps", "20"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[lotaru] predicted step time ")
    assert "young-daly ckpt interval" in out[0]
    assert [line.split()[:2] for line in out[1:3]] == [["step", "10"],
                                                        ["step", "20"]]
    assert out[-1].startswith("[done] loss first->last: ")
    assert len(losses) == 20 and losses[-1] < losses[0]
    assert tckpt.latest_step(d) == 20
    more = tlaunch.main(args + ["--steps", "24", "--skip-profile"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[resume] restored step 20"
    assert len(more) == 4 and tlaunch.main.stats["start"] == 20
    none = tlaunch.main(args + ["--steps", "24", "--skip-profile"])
    assert none == [] and capsys.readouterr().out.splitlines()[-1].startswith(
        "[done] restored step 24 of 24")


def test_roofline_matches_reference():
    assert troof.model_flops(3.6e8, 16384, "train") == jroof.model_flops(
        3.6e8, 16384, "train")
    assert troof.model_flops(3.6e8, 100, "serve") == jroof.model_flops(
        3.6e8, 100, "serve")
    for t, n, d, s in ((1000, 100, 4, 48), (300, 30, 10, 16)):
        a = troof.decision_plane_roofline(t, n, d, s)
        b = jroof.decision_plane_roofline(t, n, d, s)
        assert (a.flops, a.hbm_bytes) == (b.flops, b.hbm_bytes)
        assert a.t_compute == a.flops / 989e12
        assert a.t_memory == a.hbm_bytes / 3.35e12
    kw = dict(arch="a", shape="s", mesh="m", flops_per_dev=2e15,
              hbm_bytes_per_dev=1e12, coll_bytes_per_dev=1e9,
              model_flops_per_dev=1e15, n_chips=1)
    a, b = troof.RooflineTerms(**kw), jroof.RooflineTerms(**kw)
    assert a.useful_flops_ratio == b.useful_flops_ratio
    assert a.t_collective == 1e9 / (18 * 50e9)
    assert set(a.to_dict()) == set(b.to_dict())


def test_memory_lean_functions_match_autograd_of_their_ops():
    """rmsnorm, the rotary embedding and the cross-entropy run as autograd
    Functions that keep less for their backward: forward bitwise the same
    ops, gradients within 1e-6 of autograd of those ops in float32 (the
    analytic form rounds elsewhere), and the loss's backward passes
    gradcheck in float64."""
    from repro_torch.models import layers as tl
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 96), generator=g).requires_grad_()
    sc = (torch.rand(96, generator=g) + 0.5).requires_grad_()
    gy = torch.randn((2, 5, 96), generator=g)

    def plain_norm(x, sc):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + 1e-6) * sc).to(x.dtype)
    got, want = tl.rmsnorm({"scale": sc}, x, 1e-6), plain_norm(x, sc)
    assert got.grad_fn.name().startswith("_RMSNorm") and torch.equal(got,
                                                                    want)
    for a, b in zip(torch.autograd.grad(got, (x, sc), gy),
                    torch.autograd.grad(want, (x, sc), gy)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)

    _, cfg = _cfgs("smollm-360m")
    xr = torch.randn((2, 5, 3, 32), generator=g).requires_grad_()
    pos = torch.arange(5).expand(2, 5)
    got = tl.apply_rope(xr, pos, cfg)
    with torch.no_grad():
        assert torch.equal(got, tl.apply_rope(xr, pos, cfg))
    inv = tl.rope_freqs(32, 1.0, cfg.rope_theta)
    ang = pos.float()[..., None] * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = xr[..., :16], xr[..., 16:]
    want = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    assert torch.equal(got, want)
    gr = torch.randn((2, 5, 3, 32), generator=g)
    torch.testing.assert_close(torch.autograd.grad(got, xr, gr)[0],
                               torch.autograd.grad(want, xr, gr)[0],
                               rtol=1e-6, atol=1e-6)

    lg = torch.randn((2, 4, 9), generator=g, dtype=torch.float64)
    lab = torch.randint(0, 9, (2, 4), generator=g)
    m = (torch.rand((2, 4), generator=g) < 0.6).double()
    for mask in (None, m, torch.zeros_like(m)):
        assert torch.autograd.gradcheck(          # the loss casts to float32
            lambda t: tl._CrossEntropy.apply(t, lab, mask),
            (lg.clone().requires_grad_(),))
    loss = tl.cross_entropy(lg.float().requires_grad_(), lab, m.float())
    assert loss.grad_fn.name().startswith("_CrossEntropy")
