#!/usr/bin/env python3
"""Where one step of the shared-route HEFT sweep waits, on an NVIDIA card.

    python3 sweep_clocks.py [--tasks 1000] [--nodes 100] [--slots 48]

Builds `src/repro_torch/kernels/csrc/decision_plane.cu` a second time with
-DLOTARU_SWEEP_CLOCKS, so that the shared-route kernel adds up clock64()
cycles per phase of each step for every warp, and runs it on the replan
round of chip_smoke.py (the 1000-task x 100-node problem at q = 0.95) and
on its chain case.  Prints, per case, the cycles of a step by phase (mean
over the steps; the warp at the median and the slowest warp), the total
cycles against the CUDA-event time of the same launch, and the time of the
uninstrumented kernel beside it.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("ready+loads", "gap search", "warp argmin", "barrier",
          "block argmin", "transfer+insert", "store+fold")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tasks", type=int, default=1000)
    ap.add_argument("--nodes", type=int, default=100)
    ap.add_argument("--slots", type=int, default=48)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this script measures the sweep kernel on it")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import decision_plane as plane
    from repro_torch.sched import fused

    src = os.path.join(_build.CSRC_DIR, "decision_plane.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "libdecision_plane_clocks.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                    "-DLOTARU_SWEEP_CLOCKS", "-o", so, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lotaru_eft_sweep.argtypes = ([p] * 3 + [i] + [p] * 5 + [i] * 4
                                     + [p] * 7 + [p])
    lib.lotaru_eft_sweep.restype = i
    lib.lotaru_sweep_clocks.argtypes = [p]
    lib.lotaru_sweep_clocks.restype = i

    dev = torch.device("cuda", 0)
    dag, nodes, svc = cs.replan_problem(args.tasks, args.nodes, 0, dev)
    W = fused.cost_view(svc, dag, nodes, cs.PLAN_QUANTILE)
    ctx = fused._context(dag, nodes, {})
    order = fused._rank_order(fused._device_ranks([ctx], [W]))[0]
    st = ctx.on_device(dev)
    cases = {"replan": [W, order, st["dep_rows"], st["gb8"], st["zeros"],
                        st["avail0"], st["same"], st["gbps_min"]],
             "chain": [torch.from_numpy(v).to(dev)
                       for v in cs.sweep_cases()["chain"]]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[clocks] {smi}")
    for name, a in cases.items():
        t, n = a[0].shape
        s = args.slots
        assert plane.sweep_route(t, n, s, a[2].shape[1],
                                 plane.smem_optin(0)) == "shared"
        outs = [torch.empty((t + 1, n), dtype=torch.float64, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.zeros(t + 1, dtype=torch.int32, device=dev),
                torch.zeros(t + 1, dtype=torch.float64, device=dev),
                torch.zeros(t + 1, dtype=torch.float64, device=dev)]
        call = a[:3] + [a[2].shape[1]] + a[3:] + [t, n, s, 0, None, None]
        timed = cs.raw_launch("eft_sweep", call + outs, lib)
        plain = cs.raw_launch("eft_sweep", call + outs, plane._lib())
        ms = cs.time_ms(timed, reps=5)
        plain_ms = cs.time_ms(plain, reps=5)
        timed()
        torch.cuda.synchronize()
        clocks = np.zeros(32 * len(PHASES) + 1, np.int64)
        assert lib.lotaru_sweep_clocks(clocks.ctypes.data) == 0
        nw = -(-n * (4 if n <= 128 else 2 if n <= 256 else 1) // 32)
        per = clocks[:32 * len(PHASES)].reshape(32, len(PHASES))[:nw] / t
        order = np.argsort(per.sum(axis=1))
        total = int(clocks[-1])
        print(f"[clocks] {name} T={t} N={n} S={s}: {total} cycles, "
              f"{total / t:.1f} a step; instrumented {ms!r} ms "
              f"({total / (ms * 1e6):.3f} GHz if all), kernel without the "
              f"clocks {plain_ms!r} ms")
        for label, w in (("median warp", order[nw // 2]),
                         ("slowest warp", order[-1])):
            print(f"[clocks] {name} {label} {int(w)}: " + ", ".join(
                f"{ph} {c:.1f}" for ph, c in zip(PHASES, per[w])))


if __name__ == "__main__":
    main()
