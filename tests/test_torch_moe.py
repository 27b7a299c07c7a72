"""The port's mixture of experts and `cfg.remat` against the JAX package,
on the CPU.

`models/moe.py` at the reduced Mixtral's widths (d 128, 4 experts, top 2,
expert width 256) in float32: the JAX package makes the weights, the
same numpy-made inputs go through both packages.  `capacity` equal for S
in 1..64; `moe_apply`'s output, auxiliary loss and every gradient leaf
(router, experts, shared expert, x) within GRAD_TOL of
`jax.value_and_grad`, for SwiGLU and GELU, with and without a shared
expert, at capacity factor 0.5 (choices dropped) and 8.0 (none dropped),
the routed experts equal to the reference's.  The reduced Mixtral's
decode past its window against the reference's `decode_step`, and
against the port's own forward.  `remat` "dots" and "full": loss and
gradients bitwise "none"'s, each within GRAD_TOL of the reference's
`jax.checkpoint`-wrapped gradients; what each mode recomputes in the
backward; no autograd Function of the port keeps a tensor outside
`save_for_backward`.

Tolerances (float32; the packages sum in other orders): outputs and aux
rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5 (as
tests/test_torch_train.py), logits 1e-4, decode against forward 2e-3
(tests/test_models_smoke.py:86)."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

ARCH = "mixtral-8x7b"
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
TIE = 1e-5          # a top-k gap under this makes routing a coin toss
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


def _smallest_gap(probs: np.ndarray, k: int) -> float:
    """The smallest gap between neighbours among each row's k + 1 largest
    probabilities: the margin by which the top-k set and its order are
    decided."""
    top = -np.sort(-probs, axis=-1)[..., : k + 1]
    return float(np.min(top[..., :-1] - top[..., 1:]))


# ---------------------------------------------------------------------------
# capacity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_capacity_matches_reference(cf):
    for e, k in ((4, 2), (8, 2), (160, 6)):
        jcfg, tcfg = _cfgs(capacity_factor=cf, num_experts=e, top_k=k)
        for s in range(1, 65):
            assert tmoe.capacity(tcfg, s) == jmoe.capacity(jcfg, s), (e, k, s)
    assert tmoe.capacity(tcfg, 1) == 1


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [0.5, 8.0])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("ffn", ["swiglu", "gelu"])
def test_moe_apply_and_every_gradient_match_jax(ffn, shared, cf):
    jcfg, tcfg = _cfgs(ffn_kind=ffn, num_shared_experts=shared,
                       capacity_factor=cf)
    jp = jmoe.moe_init(jax.random.PRNGKey(7), jcfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)

    # routing: the same experts, in the same order, as the reference's
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jp["router"], -1))
    gap = _smallest_gap(probs, jcfg.top_k)
    print(f"smallest top-{jcfg.top_k} gap {gap:.3e}")
    assert gap >= TIE, (f"a near-tie in the router (gap {gap:.3e} < {TIE}): "
                        f"the two packages may rightly route differently, "
                        f"so the comparison below means nothing")
    tp = _torch_tree(jax.tree.map(np.asarray, jp))
    _, _, t_i = tmoe.route(tp, tcfg, torch.from_numpy(x))
    _, j_i = jax.lax.top_k(jnp.asarray(probs), jcfg.top_k)
    assert np.array_equal(t_i.numpy(), np.asarray(j_i))
    # the capacity's drops: some at 0.5, none at 8.0
    keep = tmoe.slots(t_i, jcfg.num_experts) < tmoe.capacity(tcfg, S)
    kept = torch.bincount(t_i.reshape(2, -1)[keep],
                          minlength=jcfg.num_experts)
    assert keep.shape == (2, S * jcfg.top_k)
    assert (int((~keep).sum()) > 0) == (cf < 1.0), int((~keep).sum())
    assert bool((kept <= 2 * tmoe.capacity(tcfg, S)).all())

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, jcfg, xx)
        return jnp.sum(y * r) + aux, (y, aux)
    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    leaves = [leaf.requires_grad_() for leaf in topt.tree_leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_()
    ty, taux = tmoe.moe_apply(tp, tcfg, xt)
    grads = torch.autograd.grad((ty * torch.from_numpy(r)).sum() + taux,
                                leaves + [xt])
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **OUT_TOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), **OUT_TOL)
    jleaves = jax.tree_util.tree_leaves_with_path(jgp)
    assert len(jleaves) == len(leaves)
    for (path, jg), g in zip(jleaves, grads[:-1]):
        np.testing.assert_allclose(_np(g), np.asarray(jg), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(_np(grads[-1]), np.asarray(jgx), **GRAD_TOL,
                               err_msg="x")
    assert float(grads[0].abs().max()) > 0          # the router learns


def test_moe_decode_runs_every_choice_at_capacity_one():
    """At S = 1 the capacity is 1 and a token's top-k experts are
    distinct, so no choice is dropped: decode equals the dense mixture."""
    jcfg, tcfg = _cfgs()
    tp = _torch_tree(jax.tree.map(np.asarray, jmoe.moe_init(
        jax.random.PRNGKey(2), jcfg)))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 1, tcfg.d_model)).astype(np.float32))
    y, _ = tmoe.moe_apply(tp, tcfg, x)
    _, top_p, top_i = tmoe.route(tp, tcfg, x)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    want = torch.zeros_like(x)
    for j in range(tcfg.top_k):
        e = top_i[:, 0, j]
        h = torch.nn.functional.silu(torch.einsum(
            "bd,bdf->bf", x[:, 0], tp["we_g"][e])) * torch.einsum(
            "bd,bdf->bf", x[:, 0], tp["we_i"][e])
        want[:, 0] += top_p[:, 0, j, None] * torch.einsum(
            "bf,bfd->bd", h, tp["we_down"][e])
    np.testing.assert_allclose(_np(y), _np(want), **OUT_TOL)


# ---------------------------------------------------------------------------
# the reduced Mixtral: decode past the window
# ---------------------------------------------------------------------------
VARIANTS = (("mixtral", {}),
            ("dense prefix, shared expert",
             dict(first_dense_layers=1, dense_d_ff=192, num_shared_experts=1)))


@pytest.mark.parametrize("kw", [v[1] for v in VARIANTS],
                         ids=[v[0] for v in VARIANTS])
def test_decode_past_the_window_matches_reference_and_forward(kw):
    """Capacity factor 8.0 (no choice dropped; the reference's decode test
    excludes drops the same way, tests/test_models_smoke.py:61-65).  The
    reference's ring-cache shape: B 2, prefill 31 tokens past the window
    of 16, then decode teacher-forced to 40, each step's logits against
    the reference's decode_step and the port's own forward."""
    jcfg, tcfg = _cfgs(capacity_factor=8.0, **kw)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    if kw:
        assert set(tp["prefix"]["0"]) >= {"ffn"}
        assert tuple(tp["prefix"]["0"]["ffn"]["wi"].shape) == (128, 192)
    tok = np.random.default_rng(6).integers(0, tcfg.vocab_size,
                                            (2, 40)).astype(np.int32)
    s0 = 31
    full, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)})
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
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **LOGIT_TOL,
                                   err_msg=f"position {pos}")
        np.testing.assert_allclose(_np(tlog[:, 0]), _np(full[:, pos]),
                                   **DECODE_TOL, err_msg=f"position {pos}")


# ---------------------------------------------------------------------------
# cfg.remat
# ---------------------------------------------------------------------------
def _grads(tp, tcfg, batch):
    leaves = [leaf.detach().clone().requires_grad_()
              for leaf in topt.tree_leaves(tp)]
    params = tts._like_sorted(tp, iter(leaves))
    loss, met = ttf.loss_fn(params, tcfg, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    return loss.detach(), met, torch.autograd.grad(loss, leaves)


@pytest.fixture(scope="module")
def remat_model():
    """The reduced Mixtral with a dense prefix layer and a shared expert,
    3 layers (a prefix and two cycles), S 32."""
    kw = dict(first_dense_layers=1, dense_d_ff=192, num_shared_experts=1,
              num_layers=3)
    jcfg, tcfg = _cfgs(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(4), jcfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(9)
    batch = {k: rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    return jcfg, tcfg, jp, tp, batch, _grads(tp, tcfg, batch)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_is_bitwise_none_and_matches_jax_checkpoint(remat_model, remat):
    jcfg, tcfg, jp, tp, batch, (l0, _, g0) = remat_model
    jcfg = dataclasses.replace(jcfg, remat=remat)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    loss, met, grads = _grads(tp, tcfg, batch)
    assert torch.equal(loss, l0)
    assert all(torch.equal(a, b) for a, b in zip(grads, g0))
    assert float(met["aux"]) > 0
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                        for k, v in batch.items()}),
        has_aux=True)(jp)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                               rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(grads)
    for (path, jgl), g in zip(jleaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgl), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_recomputes_what_its_policy_does_not_save(remat_model, remat):
    """The backward's products, counted by op against "none"'s: "dots"
    recomputes the expert products (bmm, a batch dimension) and no 2-d
    product (mm, the outputs it saves); "full" recomputes both."""
    _, tcfg, _, tp, batch, _ = remat_model
    counts = {}
    for mode in ("none", remat):
        leaves = [leaf.detach().clone().requires_grad_()
                  for leaf in topt.tree_leaves(tp)]
        params = tts._like_sorted(tp, iter(leaves))
        loss, _ = ttf.loss_fn(params, dataclasses.replace(tcfg, remat=mode),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()})
        with _OpCount() as ops:
            torch.autograd.grad(loss, leaves)
        counts[mode] = ops.n
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    more_mm = counts[remat][mm] - counts["none"][mm]
    more_bmm = counts[remat][bmm] - counts["none"][bmm]
    assert counts["none"][mm] > 0 and counts["none"][bmm] > 0
    assert (more_mm > 0) == (remat == "full") and more_mm >= 0
    assert more_bmm > 0


def test_no_function_keeps_a_tensor_on_ctx():
    """Every autograd Function of the port on the path (attention, scan,
    rmsnorm, rotary, the loss) keeps what its backward needs through
    save_for_backward: a tensor kept as a plain ctx attribute would
    outlive a checkpointed region and undo remat's saving."""
    for arch in (ARCH, "recurrentgemma-9b"):
        _, tcfg = _cfgs() if arch == ARCH else (None, dataclasses.replace(
            tconfigs.get_reduced_config(arch), dtype="float32"))
        tp = topt.tree_map(lambda t: t.requires_grad_(),
                           ttf.init_params(1, tcfg, "cpu"))
        tok = torch.from_numpy(np.random.default_rng(1).integers(
            0, tcfg.vocab_size, (2, 20)))
        loss, _ = ttf.loss_fn(tp, tcfg, {"tokens": tok, "labels": tok})
        seen, stack, names = set(), [loss.grad_fn], set()
        while stack:
            node = stack.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            if hasattr(node, "saved_tensors"):     # a custom Function
                names.add(type(node).__name__)
                kept = [k for k, v in vars(node).items()
                        if isinstance(v, torch.Tensor)]
                assert not kept, (type(node).__name__, kept)
            stack.extend(fn for fn, _ in node.next_functions)
        want = {"_RMSNormBackward", "_RopeBackward", "_CrossEntropyBackward"}
        want.add("FlashAttentionBackward")
        if arch != ARCH:
            want.add("RGLRUScanBackward")
        assert want <= names, names
