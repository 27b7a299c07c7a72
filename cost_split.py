#!/usr/bin/env python3
"""Where a warm `cost_view` spends its time, on an NVIDIA card, for the
port in this checkout or in another checkout of it.

    python3 cost_split.py [--src DIR] [--rounds 20]

Builds the replan problem of chip_smoke.py (1000 tasks x 100 nodes, seed
0) with the port under --src (default: this checkout's src/), runs
`cost_view` three times at q = 0.95 to warm it, then --rounds rounds of
the whole `cost_view` (host clock, the card synchronised) followed by the
same work piece by piece, each piece synchronised:

  * a port whose `fused_cost` takes a `CostBatch` (`pack_cost`): the
    pieces of `chip_smoke.cost_view_split` (the topological order, sync,
    the node corrections, the store's gather into the pinned slab, its
    copy up, the resident static factors, the launch);
  * a port whose `fused_cost` takes per-leaf tensors and a factor matrix
    (before the cost slab): the DAG's topological order, sync (the
    binding's sync, the snapshot, the keys and inputs), the store's
    gather into new arrays, the host factor matrix (`factor_matrix`, the
    node corrections included), the nine pageable copies up, the launch.

Each round's W is checked bitwise against `cost_view`'s.  Then one warm
`cost_view` under torch.profiler: its host-to-device copies and fused_cost
kernels.  Prints medians and quartiles and the card's name and power
limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
QUANTILE = 0.95
PIECES = ("order_s", "sync_s", "gather_s", "factors_s", "copy_s",
          "launch_s")


def per_leaf_split(svc, dag, nodes, quantile) -> dict:
    """The pieces of a `cost_view` that takes per-leaf operands and a
    host factor matrix, run as it runs them."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.sched.fused import cost_view
    from repro_torch.sched.plane import quantile_z
    from repro_torch.store.compute import LEAVES
    t = [time.perf_counter()]
    order = dag.topo_order()
    names = [n.name for n in nodes]
    tasks = [dag.tasks[u].task_name for u in order]
    t.append(time.perf_counter())
    binding = svc._binding
    binding.sync()
    snap = svc.store.snapshot()
    keys = [binding.key_str(k) for k in tasks]
    x = np.asarray([dag.tasks[u].input_gb for u in order], np.float64)
    t.append(time.perf_counter())
    post = snap.gather(keys)
    t.append(time.perf_counter())
    f = binding.factor_matrix(tasks, names)
    t.append(time.perf_counter())
    dev = svc.device
    xd = torch.from_numpy(x).to(dev)
    pd = {leaf: torch.from_numpy(np.ascontiguousarray(post[leaf])).to(dev)
          for leaf in LEAVES}
    fd = torch.from_numpy(np.ascontiguousarray(f, np.float64)).to(dev)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    W = ops.fused_cost(xd, pd, fd, quantile_z(quantile))
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    want = cost_view(svc, dag, nodes, quantile)
    if not torch.equal(W.view(torch.int64), want.view(torch.int64)):
        raise SystemExit("the per-leaf pieces differ from cost_view")
    return dict(zip(PIECES, [b - a for a, b in zip(t, t[1:])]))


def profiled(fn) -> dict:
    """Host-to-device copies and fused_cost kernels of one call of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"h2d": 0, "fused_cost": 0, "device_events": 0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        out["device_events"] += 1
        out["h2d"] += e.name.startswith("Memcpy HtoD")
        out["fused_cost"] += "fused_cost_kernel" in e.name
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this script times the port on a GPU")
    import chip_smoke
    from repro_torch.kernels import decision_plane
    from repro_torch.sched.fused import cost_view
    slab = hasattr(decision_plane, "pack_cost")
    dev = torch.device("cuda", 0)
    dag, nodes, svc = chip_smoke.replan_problem(chip_smoke.PLAN_TASKS,
                                                chip_smoke.PLAN_NODES, 0, dev)
    for _ in range(3):
        cost_view(svc, dag, nodes, QUANTILE)
    torch.cuda.synchronize()
    whole, splits = [], []
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        cost_view(svc, dag, nodes, QUANTILE)
        torch.cuda.synchronize()
        whole.append(time.perf_counter() - t0)
        splits.append(chip_smoke.cost_view_split(svc, dag, nodes, QUANTILE)[0]
                      if slab else per_leaf_split(svc, dag, nodes, QUANTILE))
    copies = profiled(lambda: cost_view(svc, dag, nodes, QUANTILE))
    q = lambda v: [float(np.percentile(v, p)) for p in (25, 50, 75)]
    form = "cost slab" if slab else "per-leaf operands"
    print(f"[cost_split] {src} ({form}), {chip_smoke.PLAN_TASKS} x "
          f"{chip_smoke.PLAN_NODES}, q={QUANTILE}, {args.rounds} warm rounds")
    print(f"[cost_split] whole cost_view s (quartiles): {q(whole)}")
    for k in splits[0]:
        print(f"[cost_split] {k} (quartiles): {q([s[k] for s in splits])}")
    med = sum(float(np.median([s[k] for s in splits])) for k in splits[0])
    print(f"[cost_split] sum of the pieces' medians {med!r} s; one warm "
          f"cost_view under the profiler: {copies}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])


if __name__ == "__main__":
    main()
