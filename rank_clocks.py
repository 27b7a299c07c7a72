#!/usr/bin/env python3
"""Where the upward-rank kernel's time goes, on an NVIDIA card.

    python3 rank_clocks.py [--tasks 1000] [--nodes 100] [--lanes 32]

Runs the shared route of `upward_rank` (csrc/decision_plane.cu) on the
replan problem's DAG (`chip_smoke.replan_dag`, seed 0, at one lane; seeds
32 on at --lanes lanes) and on a chain of --tasks tasks, W uniform in
[1, 100) from a seed, at cluster sizes 1, 2, 4, 8 and 16: each launch
bitwise the plain version, its CUDA-event time with the L2 flushed, and
the global route's (PR 28's kernel) beside it.  Then it builds the source
a second time with -DLOTARU_RANK_CLOCKS, so that thread 0 of each block of
lane 0 records clock64() at the ends of its phases, and prints, at
`rank_config`'s cluster size, each worker's cycles (tables issued, W
staging and row sums over all tiles, sums sent) and the leader's (rows
described, the workers' sums in, the walk, its cycles in wide levels and
in narrow runs, the output).  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CLUSTERS = (1, 2, 4, 8, 16)
# cycles: durations for W staging and the row sums (all tiles), else from
# the kernel's start; the leader (a cluster of more than one) stages and
# sums nothing, a worker has only the first four
PHASES = ("tables issued", "W staging", "row sums", "sums sent",
          "rows described", "sums in", "walked", "written", "wide levels",
          "narrow runs")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tasks", type=int, default=1000)
    ap.add_argument("--nodes", type=int, default=100)
    ap.add_argument("--lanes", type=int, default=32)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this script measures the rank kernel on it")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import decision_plane as plane
    from repro_torch.kernels import ref
    from repro_torch.sched import fused
    from repro_torch.sched.cluster import TARGET_MACHINES
    from repro_torch.workflow.simulator import random_cluster

    src = os.path.join(_build.CSRC_DIR, "decision_plane.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "libdecision_plane_rank_clocks.so")
    build = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS,
                              "-DLOTARU_RANK_CLOCKS", "-o", so, src],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    p, i = ctypes.c_void_p, ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[rank] {smi}")

    dev = torch.device("cuda", 0)
    nodes = random_cluster(np.random.default_rng(0), list(TARGET_MACHINES),
                           n_nodes=args.nodes)
    rng = np.random.default_rng(1)

    def lanes(dags):
        ctxs = [fused._PlanContext(d, nodes) for d in dags]
        Ws = [torch.from_numpy(rng.uniform(1.0, 100.0, (len(c.order),
                                                        args.nodes))).to(dev)
              for c in ctxs]
        return Ws, [c.on_device(dev)["rank"] for c in ctxs]

    cases = {
        "replan B=1": lanes([cs.replan_dag(np.random.default_rng(0),
                                           args.tasks)]),
        f"replan B={args.lanes}": lanes([
            cs.replan_dag(np.random.default_rng(32 + k), args.tasks)
            for k in range(args.lanes)]),
        "chain B=1": lanes([cs.chain_dag(args.tasks)]),
    }
    optin, sms = plane.smem_optin(0), plane.sm_count(0)
    for name, (Ws, tabs) in cases.items():
        want = ref.upward_rank_ref([w.cpu() for w in Ws],
                                   [t.to("cpu") for t in tabs])[0].numpy()
        cfg = plane.rank_config(max(t.T for t in tabs),
                                max(t.E for t in tabs),
                                max(t.L for t in tabs), args.nodes, len(Ws),
                                optin, sms)
        times = {}
        for c in CLUSTERS + ("global",):
            fn = (cs.rank_launch(Ws, tabs, "global") if c == "global"
                  else cs.rank_launch(Ws, tabs, "shared", c))
            rc = fn.unchecked()
            torch.cuda.synchronize()
            if rc:
                times[c] = f"refused (CUDA error {rc})"
                continue
            same = np.array_equal(fn.rank.cpu().numpy().view(np.int64),
                                  want.view(np.int64))
            cs.check(same and not fn.bad.any(),
                     f"{name} cluster {c}: not bitwise the plain version")
            times[c] = cs.time_ms(fn, reps=10)
        print(f"[rank] {name} T={args.tasks} N={args.nodes} levels "
              f"{max(t.L for t in tabs)}: ms with the L2 flushed by "
              f"cluster size {times} (bitwise the plain version); "
              f"rank_config: cluster {cfg['cluster']}, tile rows "
              f"{cfg['tile_rows']}, {cfg['smem_bytes']} B a block")

    _, err = build.communicate()
    if build.returncode:
        sys.exit(f"nvcc failed:\n{err.decode()}")
    lib = ctypes.CDLL(so)
    lib.lotaru_upward_rank.argtypes = [p, p] + [i] * 7 + [p] * 4
    lib.lotaru_upward_rank.restype = i
    lib.lotaru_rank_clocks.argtypes = [p]
    lib.lotaru_rank_clocks.restype = i
    for name, (Ws, tabs) in cases.items():
        fn = cs.rank_launch(Ws, tabs, "shared", lib=lib)
        ms = cs.time_ms(fn, reps=5)
        fn()
        torch.cuda.synchronize()
        clocks = np.zeros(plane.RANK_CLUSTERS[-1] * len(PHASES), np.int64)
        cs.check(lib.lotaru_rank_clocks(clocks.ctypes.data) == 0,
                 "reading the rank clocks failed")
        cfg = fn.config
        per = clocks.reshape(-1, len(PHASES))[:cfg["cluster"]]
        lead = per[0]
        levels = tabs[0].L
        widths = np.diff(tabs[0].level_ptr.cpu().numpy())
        wide = int((widths > 32).sum())
        print(f"[rank] {name} instrumented: {ms!r} ms, cluster "
              f"{cfg['cluster']}; lane 0 has {levels} levels, "
              f"{int((widths <= 32).sum())} of at most 32 rows; leader: "
              + ", ".join(f"{ph} {int(c)}" for ph, c in zip(PHASES, lead))
              + f"; walk {(lead[6] - lead[5]) / max(levels, 1):.1f} cycles "
              f"a level ({lead[8] / max(wide, 1):.1f} a wide level, "
              f"{lead[9] / max(levels - wide, 1):.1f} a narrow one); "
              f"{lead[7] / (ms * 1e6):.3f} GHz if the leader's cycles were "
              f"the event time")
        for b, row in enumerate(per[1:], start=1):
            print(f"[rank] {name} block {b}: " + ", ".join(
                f"{ph} {int(c)}" for ph, c in zip(PHASES[:4], row)))


if __name__ == "__main__":
    main()
