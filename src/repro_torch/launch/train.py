"""End-to-end training launcher, the counterpart of the JAX package's
`launch/train.py`, with the same flags, printed lines and return value.

Lotaru on the training side:
  1. local profiling: the train step at four downsampled batch sizes, each
     timed between `torch.cuda.synchronize` calls on a card, and a fit of
     Lotaru's Bayesian linear model of step time on tokens;
  2. the posterior step time (mean and uncertainty) sets the Young-Daly
     checkpoint interval and the ETA;
  3. checkpoints are atomic and resumable (automatic resume on restart),
     so a node failure costs at most one interval.

On a card every attention layer runs the hand-written `flash_attention`
forward and backward kernels and every RG-LRU layer `rglru_scan`'s; on the
CPU (`--device cpu`) their plain versions.  Usage:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      [--reduced --device cpu] --steps 100 --batch 4 --seq 128 \\
      --ckpt-dir /tmp/run1

`main` returns the losses of the steps it ran; `main.stats` keeps the
run's Lotaru prediction, Young-Daly interval, profile points and per-step
host seconds.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core import bayes
from repro_torch.data.pipeline import DataConfig, data_iterator, make_batch
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import init_params
from repro_torch.sched.elastic import checkpoint_every_n_steps
from repro_torch.train.checkpoint import AsyncCheckpointer, restore_checkpoint
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _on(batch, dev: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def profile_step_time(cfg, oc, batch: int, seq: int, n_points: int = 4,
                      device=DEFAULT_DEVICE):
    """Lotaru local profiling: measure the step at reduced token counts and
    fit runtime ~ tokens.  Returns (posterior, points)."""
    dev = resolve_device(device)
    step = make_train_step(cfg, oc)
    xs, ys = [], []
    for fr in np.geomspace(0.25, 1.0, n_points):
        b = max(1, int(batch * fr))
        data = _on(make_batch(DataConfig(cfg.vocab_size, seq, b, seed=7), 0),
                   dev)
        state = {"opt": init_opt_state(init_params(0, cfg, dev), oc)}
        state, _ = step(state, data)                 # warm
        _sync(dev)
        t0 = time.perf_counter()
        state, _ = step(state, data)
        _sync(dev)
        xs.append(b * seq)
        ys.append(time.perf_counter() - t0)
        del state, data
    post = bayes.fit_blr(torch.tensor(xs, dtype=torch.float32, device=dev),
                         torch.tensor(ys, dtype=torch.float32, device=dev))
    return ({k: v.cpu().numpy() for k, v in post.items()},
            list(zip(xs, ys)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-cost-s", type=float, default=2.0)
    ap.add_argument("--node-mtbf-h", type=float, default=24.0)
    ap.add_argument("--n-nodes", type=int, default=1)
    ap.add_argument("--skip-profile", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_reduced_config(args.arch) if args.reduced else get_config(
        args.arch)
    cfg = dataclasses.replace(cfg, remat="none", microbatches=1)
    oc = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                   total_steps=args.steps, int8_state=cfg.int8_opt_state)
    stats = {"predicted_step_s": None, "predicted_std_s": None,
             "profile": [], "step_s": []}
    main.stats = stats

    ckpt_interval = max(args.steps // 5, 10)
    if not args.skip_profile:
        post, pts = profile_step_time(cfg, oc, args.batch, args.seq,
                                      device=dev)
        mean, std = bayes.predict_blr(
            {k: torch.from_numpy(v) for k, v in post.items()},
            torch.tensor(float(args.batch * args.seq)))
        mean, std = float(mean), float(std)
        ckpt_interval = checkpoint_every_n_steps(
            mean, args.ckpt_cost_s, args.node_mtbf_h * 3600, args.n_nodes)
        eta_s = args.steps * mean
        stats.update(predicted_step_s=mean, predicted_std_s=std,
                     profile=pts)
        print(f"[lotaru] predicted step time {mean*1e3:.1f}ms "
              f"(+-{std*1e3:.1f}ms)  ETA {eta_s/60:.1f}min  "
              f"young-daly ckpt interval {ckpt_interval} steps", flush=True)
    stats["ckpt_interval"] = ckpt_interval

    step_fn = make_train_step(cfg, oc)
    state = {"opt": init_opt_state(init_params(42, cfg, dev), oc)}

    start = 0
    ck = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck:
        restored = restore_checkpoint(args.ckpt_dir, state)
        if restored is not None:
            start, state, meta = restored
            print(f"[resume] restored step {start}", flush=True)
    stats["start"] = start

    dc = DataConfig(cfg.vocab_size, args.seq, args.batch, seed=0)
    it = data_iterator(dc, start_step=start)
    t0 = time.perf_counter()
    losses = []
    for step in range(start, args.steps):
        t_step = time.perf_counter()
        batch = _on(next(it), dev)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))          # waits for the step
        stats["step_s"].append(time.perf_counter() - t_step)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            dt = (time.perf_counter() - t0) / max(step + 1 - start, 1)
            print(f"step {step+1:5d}  loss {losses[-1]:.4f}  "
                  f"{dt*1e3:7.1f} ms/step", flush=True)
        if ck and (step + 1) % ckpt_interval == 0:
            ck.save(step + 1, state, {"arch": args.arch})
    if ck:
        ck.save(args.steps, state, {"arch": args.arch})
        ck.wait()
    if losses:
        print(f"[done] loss first->last: {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}", flush=True)
    else:       # restored at --steps: the reference fails on losses[0]
        print(f"[done] restored step {start} of {args.steps}: no step left "
              f"to run", flush=True)
    return losses


main.stats = {}

if __name__ == "__main__":
    main()
