#!/usr/bin/env python3
"""Where the attention backward's time goes, on an NVIDIA card.

    python3 bwd_passes.py [--variants base,no_exp,no_score,no_acc] [--reps 20]

Times `flash_attention_bwd`'s bf16 route (csrc/flash_attention_bwd.cu) at
the two training paths' shapes (chip_smoke.train_attention_cases: SmolLM-
360M's B 8 x S 2048, 15 heads over 5, hd 64, causal; RecurrentGemma-9B's
B 1 x S 4096, 16 heads over 1, hd 256, window 2048), inputs from a seed:
the launch's CUDA-event time back to back and each pass's device time
under torch.profiler (the rows pass, dK/dV, the head splits' sum, dQ).
Each variant is the source built again with knock-out flags, all builds
started together: `base` as the port builds it, `no_exp` without the ex2
of P, `no_score` without the score products, `no_acc` without the
accumulation products (LOTARU_BWD_NO_* in the source).  A knock-out gives
wrong gradients; `base` is held to its plain version at the kernel limit
(rtol 1e-2, atol 4e-3).  Variants run in turns, twice.  Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGS = {"base": [], "no_exp": ["-DLOTARU_BWD_NO_EXP"],
         "no_score": ["-DLOTARU_BWD_NO_SCORE"],
         "no_acc": ["-DLOTARU_BWD_NO_ACC"]}
SHAPES = (("smollm", 8, 2048, 15, 5, 64, 0),
          ("recurrentgemma", 1, 4096, 16, 1, 256, 2048))


def build(variants):
    from repro_torch.kernels import _build
    src = os.path.join(_build.CSRC_DIR, "flash_attention_bwd.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    jobs = []
    for name in variants:
        so = os.path.join(_build.BUILD_DIR,
                          f"libflash_attention_bwd_{name}.so")
        jobs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *FLAGS[name], "-o", so,
             src], stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    libs = {}
    for name, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {name}:\n{err.decode()}")
        lib = ctypes.CDLL(so)
        lib.lotaru_flash_attention_bwd.argtypes = \
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        lib.lotaru_flash_attention_bwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="base,no_exp,no_score,no_acc")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    variants = args.variants.split(",")
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this script measures the backward on it")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ref
    libs = build(variants)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[bwd] {smi}")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, b, s, h, kh, hd, w in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                   for shape in ((b, s, h, hd), (b, s, kh, hd),
                                 (b, s, kh, hd)))
        o, lse = flash.flash_attention(q, k, v, causal=True, window=w,
                                       with_lse=True)
        do = torch.randn(o.shape, generator=gen, device=dev).bfloat16()
        want = ref.attention_bwd_ref(q, k, v, o, do, lse, causal=True,
                                     window=w)
        grads = [torch.empty_like(x) for x in (q, k, v)]
        scratch = torch.empty(flash.bwd_scratch_floats(
            q.dtype, b, s, s, h, kh, hd, sms), device=dev)
        for rnd in range(2):
            for name in variants:
                lib = libs[name]
                ptrs = [x.data_ptr() for x in (q, k, v, o, do, lse, scratch,
                                               *grads)]

                def run():
                    rc = lib.lotaru_flash_attention_bwd(
                        *ptrs, 1, b, s, s, h, kh, hd, hd, 1, w,
                        torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        sys.exit(f"{name} launch failed with CUDA error {rc}")
                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                line = ""
                if name == "base":
                    ratio = max(float(((g.float() - x.float()).abs()
                                       / (4e-3 + 1e-2 * x.float().abs()))
                                      .max()) for g, x in zip(grads, want))
                    if ratio > 1.0:
                        sys.exit(f"base outside 1e-2/4e-3 of the plain "
                                 f"version at {label}: {ratio}")
                    line = f"; |err| / (atol + rtol |want|) {ratio:.4f}"
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                for _ in range(args.reps):
                    run()
                e1.record()
                torch.cuda.synchronize()
                ms = e0.elapsed_time(e1) / args.reps
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        run()
                    torch.cuda.synchronize()
                passes = {}
                for e in prof.key_averages():
                    if e.self_device_time_total <= 0:
                        continue
                    key = next((n for n in ("bwd_rows", "dkdv_reduce",
                                            "dkdv_", "dq_")
                                if n in e.key), e.key[:32])
                    passes[key] = round(passes.get(key, 0.0)
                                        + e.self_device_time_total / 1e4, 4)
                print(f"[bwd] {label} B={b} S={s} H={h} K={kh} hd={hd} "
                      f"window={w} {name} (round {rnd}): {ms:.4f} ms a "
                      f"launch; by pass (ms) {passes}{line}")


if __name__ == "__main__":
    main()
