"""Batched serving driver: prefill + KV-cache / recurrent-state decode,
closed by Lotaru's prediction of the next token's latency (a Bayesian
linear regression over the measured decode steps), the counterpart of the
JAX package's `launch/serve.py`.

Any architecture of `repro_torch.configs.ARCHS`: RecurrentGemma-9B,
Yi-6B, GLM-4-9B, StarCoder2-15B, Mixtral-8x7B and DeepSeek-V2-236B
(whose 93 GB and 472 GB of bf16 weights do not fit one card whole: cut
their depth with `configs.base.replace(cfg, num_layers=...)` and call
`serve`) and SmolLM-360M.  On a card, prefill runs the hand-written CUDA
`flash_attention` in every attention layer (MLA's expanded form at head
dims 192 and 128) and `rglru_scan` in every RG-LRU layer; the MoE's
routing and expert products and decode (MLA's absorbed form) run plain
tensor code.  Usage:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
      [--reduced] [--batch 2 --prompt-len 4096 --gen 16] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core import bayes
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import init_params
from repro_torch.train.train_step import make_decode_step, make_prefill_step


class Served(NamedTuple):
    tokens: np.ndarray        # (B, gen) generated token ids
    decode_s: np.ndarray      # (gen,) host seconds of each decode step
    prefill_s: float          # host seconds of the prefill


# a full-length cache's leaves by their sequence axis: k, v (..., S, K, hd);
# MLA's c_kv (..., S, kv_lora) and k_rope (..., S, rope)
_SEQ_AXIS = {"k": -3, "v": -3, "c_kv": -2, "k_rope": -2}


def _grow(cache, prompt_len: int, gen: int):
    """Pad full-length caches (k and v, or MLA's c_kv and k_rope, and
    slot_pos, as long as the prompt) by `gen` positions along their
    sequence axis, slot_pos with -1; windowed rings shorter than the
    prompt keep their size, and so does recurrent state.  (The reference
    pads every slot_pos, a ring's too, and then fails to decode a prompt
    longer than the window; the port grows slot_pos only with its k, v.)"""
    if "slot_pos" in cache and cache["slot_pos"].shape[-1] == prompt_len:
        grown = dict(cache)
        for key in (k for k in _SEQ_AXIS if k in cache):
            leaf, ax = cache[key], _SEQ_AXIS[key]
            pad = list(leaf.shape)
            pad[ax] = gen
            grown[key] = torch.cat([leaf, leaf.new_zeros(pad)], dim=ax)
        pad = list(cache["slot_pos"].shape)
        pad[-1] = gen
        grown["slot_pos"] = torch.cat(
            [cache["slot_pos"], cache["slot_pos"].new_full(pad, -1)], -1)
        return grown
    return {k: _grow(v, prompt_len, gen) if isinstance(v, dict) else v
            for k, v in cache.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0,
          device=DEFAULT_DEVICE, params: Optional[dict] = None) -> Served:
    """Prefill `batch` prompts of `prompt_len` tokens (the reference's
    synthetic tokens for `seed`), then decode `gen` tokens greedily.
    Weights are made on the device from `seed` unless `params` are given
    (e.g. carried from the JAX package by `repro_torch.convert`)."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(seed, cfg, dev)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    dc = DataConfig(cfg.vocab_size, prompt_len + gen, batch, seed=seed)
    tokens = torch.from_numpy(make_batch(dc, 0)["tokens"]).to(dev)
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens[:, :prompt_len]})
        cache = _grow(cache, prompt_len, gen)
        tok = torch.argmax(logits, -1)[:, None]
        _sync(dev)
        prefill_s = time.perf_counter() - t0

        out_tokens, lat = [], []
        for i in range(gen):
            t0 = time.perf_counter()
            logits, cache = decode(params, tok, cache, prompt_len + i)
            tok = torch.argmax(logits, -1)[:, None]
            _sync(dev)
            lat.append(time.perf_counter() - t0)
            out_tokens.append(tok[:, 0].cpu().numpy())
    return Served(np.stack(out_tokens, 1).astype(np.int32), np.asarray(lat),
                  prefill_s)


def lotaru_next_token(lat: np.ndarray, device=DEFAULT_DEVICE):
    """Lotaru's posterior over decode latency against the step index,
    fitted on every step but the first (which pays one-time costs), and its
    predictive (mean, std) in seconds for the next step."""
    dev = resolve_device(device)
    x = torch.arange(len(lat), dtype=torch.float32, device=dev)[1:]
    y = torch.as_tensor(lat, dtype=torch.float32, device=dev)[1:]
    post = bayes.fit_blr(x, y)
    mean, std = bayes.predict_blr(
        post, torch.tensor(float(len(lat)), device=dev))
    return float(mean), float(std)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    out = serve(cfg, args.batch, args.prompt_len, args.gen, args.seed,
                args.device)
    mean, std = lotaru_next_token(out.decode_s, args.device)
    print(f"generated {out.tokens.shape} tokens; prefill "
          f"{out.prefill_s * 1e3:.2f}ms; median decode latency "
          f"{np.median(out.decode_s) * 1e3:.2f}ms; lotaru next-token "
          f"prediction {mean * 1e3:.2f}ms (+-{std * 1e3:.2f})")
    return out.tokens


if __name__ == "__main__":
    main()
