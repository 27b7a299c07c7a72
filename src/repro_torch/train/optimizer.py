"""AdamW with fp32 master weights, global-norm clipping and optional
block-wise int8 moments (8-bit Adam), the counterpart of the JAX package's
`train/optimizer.py` on torch tensors.

Trees are nested dicts of tensors; a moment leaf stored in int8 is a dict
{"q": int8 tensor, "scale": float32 tensor or None}.  Leaves are walked in
the reference's order, `jax.tree.leaves`' (dict keys sorted), so the
global norm sums its per-leaf squares in the reference's order.  The
update runs eagerly, leaf by leaf, and writes the master weights and the
float32 moments in place (the reference builds new arrays; here that would
hold two copies of the optimizer state at once); int8 moments are stored
anew.  Every value is the reference's expression, rounded at the same
places: `torch.round` and `jnp.round` both round half to even.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Tuple

import torch

Tree = Any
_BLOCK = 128


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    int8_state: bool = False


def lr_at(oc: OptConfig, step) -> torch.Tensor:
    """linear warmup -> cosine decay to min_lr_ratio; a float32 scalar on
    `step`'s device (a tensor) or the CPU."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(oc.warmup_steps, 1)
    prog = (step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps,
                                          1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return oc.lr * torch.where(step < oc.warmup_steps, warm, cos)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def is_moment_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def tree_items(tree: Tree, prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) in `jax.tree_util`'s order: dict keys sorted, None
    skipped (a leaf-less node, as an int8 moment's absent scale)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (str(k),))
        return
    yield prefix, tree


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over the tensor leaves of `tree` (and the same places of
    `rest`); None stays None; dict order is `tree`'s."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# int8 block-quantized moment storage
# ---------------------------------------------------------------------------
def _q8(x: torch.Tensor) -> dict:
    """block-wise (last dim, block 128) symmetric int8 quantization: `q`
    keeps the parameter's shape (int8), `scale` has a (n_blocks,) trailing
    dim; a tiny or ragged leaf stays float32 with scale None."""
    shp = tuple(x.shape)
    if not shp or shp[-1] % _BLOCK != 0:
        return {"q": x, "scale": None}
    xb = x.reshape(shp[:-1] + (shp[-1] // _BLOCK, _BLOCK))
    scale = torch.amax(torch.abs(xb), dim=-1) / 127.0
    q = torch.round(xb / torch.clamp_min(scale[..., None], 1e-20))
    return {"q": q.to(torch.int8).reshape(shp), "scale": scale}


def _dq8(s: dict) -> torch.Tensor:
    if s["scale"] is None:
        return s["q"]
    shp = tuple(s["q"].shape)
    xb = s["q"].to(torch.float32).reshape(
        shp[:-1] + (shp[-1] // _BLOCK, _BLOCK))
    return (xb * s["scale"][..., None]).reshape(shp)


def _moment_store(x: torch.Tensor, int8: bool):
    return _q8(x) if int8 else x


def _moment_load(s, int8: bool) -> torch.Tensor:
    return _dq8(s) if int8 else s


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def init_opt_state(params: Tree, oc: OptConfig) -> dict:
    """{"step": int32 0, "master": float32 copies, "m", "v": zeros (or
    their int8 form)} on the parameters' device."""
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    m = tree_map(lambda p: _moment_store(
        torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        oc.int8_state), params)
    v = tree_map(lambda p: _moment_store(
        torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        oc.int8_state), params)
    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "master": master, "m": m, "v": v}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in the reference's order, of each
    leaf's sum of float32 squares."""
    sums = [torch.sum(torch.square(leaf.to(torch.float32)))
            for leaf in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _walk(grads, master, m, v, fn):
    """fn(g, master, m, v) at each gradient leaf (a moment dict is a leaf
    of the moments' trees) -> the trees of its (master, m, v) results."""
    if isinstance(grads, dict):
        out = {k: _walk(grads[k], master[k], m[k], v[k], fn) for k in grads}
        return tuple({k: o[i] for k, o in out.items()} for i in range(3))
    return fn(grads, master, m, v)


@torch.no_grad()
def adamw_update(grads: Tree, opt_state: dict, oc: OptConfig):
    """One AdamW step (decoupled weight decay) -> (new master tree, new
    state, {"grad_norm", "lr"}).  The float32 master and moments are
    updated in place and returned as the new state's leaves."""
    step = opt_state["step"] + 1
    lr = lr_at(oc, step)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(oc.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - oc.b1 ** stepf
    bc2 = 1 - oc.b2 ** stepf

    def upd(g, master, m_s, v_s):
        g = g.to(torch.float32) * scale
        m = _moment_load(m_s, oc.int8_state)
        v = _moment_load(v_s, oc.int8_state)
        if oc.int8_state:
            m = oc.b1 * m + (1 - oc.b1) * g
            v = oc.b2 * v + (1 - oc.b2) * g * g
        else:
            m.mul_(oc.b1).add_((1 - oc.b1) * g)
            v.mul_(oc.b2).add_((1 - oc.b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        master.sub_(lr * (mh / (torch.sqrt(vh) + oc.eps)
                          + oc.weight_decay * master))
        return (master, _moment_store(m, oc.int8_state),
                _moment_store(v, oc.int8_state))

    new_master, new_m, new_v = _walk(grads, opt_state["master"],
                                     opt_state["m"], opt_state["v"], upd)
    new_state = {"step": step, "master": new_master, "m": new_m, "v": new_v}
    return new_master, new_state, {"grad_norm": gnorm, "lr": lr}
