#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Lotaru (`src/repro_torch`) on one NVIDIA
card, end to end, and hold every kernel against its plain version.

    python3 chip_smoke.py

Phases (each fails loudly; nothing is caught):
  1. build   — nvcc builds the hand-written kernels from the checkout.
  2. kernels — `bayes_predict` at 2**20 random posteriors, bitwise against
               its plain version evaluated on the CPU in float64 (and against
               core.bayes.predict_blr_np); `bayes_fit` on 65,536 ragged
               buffers of 3-64 points, within rtol 5e-3 / atol 5e-4 of its
               plain version (the batched fit_blr) on the CPU.
  3. paper   — the paper's pipeline for the five nf-core workflows, training
               sets 0 and 1, Lotaru-G/A/W: profile, fit, predict to the
               target machines, HEFT on a 20-node cluster, simulate.  Held
               against the same run on device="cpu" (MPE within 1e-3
               relative) and, with the posteriors carried across, bitwise.
  4. fleet   — the 1000-task x 100-node replan round (predict_matrix, a
               100,000-query predict_batch, HEFT), then a fleet refit of
               65,536 buffers in one bayes_fit launch, stored under 64
               tenants and served per tenant.
  5. report  — per-kernel launches on the main path (phases 3-4), errors,
               and times at the main path's shapes beside their bounds:
               CUDA events over back-to-back launches through the C entry
               point (`ms`, the kernel), through the Python wrapper
               (`wrapper_ms`, what a caller pays) and of the plain version
               on the card (`plain_ms`).  `tol_ratio` is the worst
               |got - want| / (atol + rtol * |want|) over all outputs: at
               most 1 is within the stated tolerance.

The last three lines are the `kernels` JSON, the card's name and power
limit, and the `ok` JSON.  The script exits non-zero, printing no result,
without a CUDA card or without the package beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data sheet peaks (dense, no sparsity), used for the bounds
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12          # non-tensor float32
H100_FP64_FLOPS = 34e12          # non-tensor float64

FIT_TOL = dict(rtol=5e-3, atol=5e-4)
# cuSOLVER's batched eigvalsh (inside the plain fit) refuses a batch of
# 32,768 or more on an H100 (CUSOLVER_STATUS_INVALID_VALUE); 16,384 runs
PLAIN_FIT_CHUNK = 16384
N_FLEET = 65536
N_TENANTS = 64
Q_PREDICT_CHECK = 1 << 20
MPE_REL_TOL = 1e-3
TASK_TYPES = ("bwa", "idx", "dedup", "qc", "merge", "report")


def plain_fit_chunked(x, y, mask) -> dict:
    """The plain batched fit over row slices of PLAIN_FIT_CHUNK tasks, so
    that it runs on the card at the fleet's size."""
    import torch
    from repro_torch.kernels import ref
    parts = [ref.bayes_fit_ref(x[i:i + PLAIN_FIT_CHUNK],
                               y[i:i + PLAIN_FIT_CHUNK],
                               mask[i:i + PLAIN_FIT_CHUNK])
             for i in range(0, x.shape[0], PLAIN_FIT_CHUNK)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# inputs (numpy, seeded)
# ---------------------------------------------------------------------------
def random_posteriors(rng: np.random.Generator, q: int):
    """q gathered posterior rows (float64) and query inputs."""
    lo = rng.normal(size=(q, 2, 2)) * 0.3
    post = {"mu": rng.normal(size=(q, 2)),
            "sigma": np.ascontiguousarray(lo @ lo.transpose(0, 2, 1)),
            "beta_prec": rng.uniform(0.5, 50.0, q),
            "x_mu": rng.uniform(0.0, 5.0, q),
            "x_sd": rng.uniform(0.1, 3.0, q),
            "y_mu": rng.uniform(10.0, 1000.0, q),
            "y_sd": rng.uniform(1.0, 100.0, q)}
    return rng.uniform(0.0, 10.0, q), post


def fleet_buffers(rng: np.random.Generator, t: int):
    """t ragged observation buffers of 3-64 (input GB, runtime s) points:
    linear runtimes with 5% multiplicative noise."""
    lengths = rng.integers(3, 65, t)
    base = rng.uniform(2.0, 30.0, t)
    slope = rng.uniform(1.0, 60.0, t)
    xs, ys = [], []
    for k, b, s in zip(lengths, base, slope):
        x = rng.uniform(0.05, 4.0, k)
        xs.append(x)
        ys.append((b + s * x) * (1.0 + rng.normal(0.0, 0.05, k)))
    return xs, ys


def replan_problem(n_tasks: int, n_nodes: int, seed: int, device):
    """The replan round of benchmarks/replan_latency.py (`_build`), built
    with the port: six task types fitted on local traces, a random
    n_nodes cluster and an n_tasks random DAG.  Same seeds, same inputs."""
    from repro_torch.core.microbench import simulate_microbench
    from repro_torch.core.predictor import LotaruPredictor
    from repro_torch.core.traces import TraceRow
    from repro_torch.online import PredictionService
    from repro_torch.sched.cluster import LOCAL, TARGET_MACHINES
    from repro_torch.workflow.dag import TaskInstance, WorkflowDAG
    from repro_torch.workflow.simulator import random_cluster
    rng = np.random.default_rng(seed)
    traces = []
    for j, t in enumerate(TASK_TYPES):
        traces += [TraceRow("wf", t, "local", s, 2.0 + j + (15.0 + 6 * j) * s)
                   for s in np.linspace(0.05, 0.4, 6)]
    lot = LotaruPredictor("G", local_bench=simulate_microbench(LOCAL, 1),
                          device=device)
    lot.fit(traces)
    nodes = random_cluster(rng, list(TARGET_MACHINES), n_nodes=n_nodes)
    benches = {n.name: simulate_microbench(n, 1) for n in nodes}
    svc = PredictionService(lot, benches, device=device)
    dag = WorkflowDAG("replan")
    for i in range(n_tasks):
        deps = [f"t{j}" for j in range(i)
                if rng.random() < min(3.0 / max(i, 1), 0.5)]
        dag.add(TaskInstance(f"t{i}", TASK_TYPES[i % len(TASK_TYPES)],
                             "replan", float(rng.uniform(0.05, 4.0)),
                             output_gb=float(rng.uniform(0.0, 2.0)),
                             deps=deps))
    return dag, nodes, svc


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median over `reps` of CUDA-event time per call across `inner`
    back-to-back calls, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build("bayes")
    print(f"[build] {os.path.relpath(path, ROOT)} in "
          f"{time.perf_counter() - t0:.3f} s")
    with open(path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")


def phase_kernels(dev, fleet) -> dict:
    import torch
    from repro_torch.core.bayes import predict_blr_np
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import ref
    out = {}
    rng = np.random.default_rng(11)
    x, post = random_posteriors(rng, Q_PREDICT_CHECK)
    xc = torch.from_numpy(x)
    pc = {k: torch.from_numpy(v) for k, v in post.items()}
    mean, std = kernels.bayes_predict(xc.to(dev),
                                      {k: v.to(dev) for k, v in pc.items()})
    torch.cuda.synchronize()
    mean, std = mean.cpu(), std.cpu()
    p_mean, p_std = ref.bayes_predict_ref(xc, pc)
    n_mean, n_std = predict_blr_np(post, x)
    err = max(float((mean - p_mean).abs().max()),
              float((std - p_std).abs().max()))
    bitwise = torch.equal(mean, p_mean) and torch.equal(std, p_std)
    host = (np.array_equal(mean.numpy(), n_mean)
            and np.array_equal(std.numpy(), n_std))
    print(f"[kernels] bayes_predict Q={Q_PREDICT_CHECK}: bitwise vs plain "
          f"(CPU float64) {bitwise}, vs predict_blr_np {host}, max |err| "
          f"{err!r}")
    check(bitwise, "bayes_predict differs from its plain version")
    check(host, "bayes_predict differs from core.bayes.predict_blr_np")
    out["bayes_predict"] = (err, 0.0)

    xb, yb, mb = fleet
    got = kernels.bayes_fit(*(torch.from_numpy(a).to(dev)
                              for a in (xb, yb, mb)))
    torch.cuda.synchronize()
    got = {k: v.cpu() for k, v in got.items()}
    want = ref.bayes_fit_ref(*(torch.from_numpy(a) for a in (xb, yb, mb)))
    errs, ratios = {}, {}
    for leaf, w in want.items():
        g = got[leaf]
        check(bool(torch.isfinite(g).all()), f"bayes_fit {leaf} not finite")
        diff = (g - w).abs()
        errs[leaf] = float(diff.max())
        ratios[leaf] = float((diff / (FIT_TOL["atol"]
                                      + FIT_TOL["rtol"] * w.abs())).max())
    ok = all(r <= 1.0 for r in ratios.values()) and all(
        torch.allclose(got[leaf], w, **FIT_TOL) for leaf, w in want.items())
    print(f"[kernels] bayes_fit T={xb.shape[0]} N={xb.shape[1]} vs plain "
          f"(CPU): within 5e-3/5e-4 {ok}, max |err| per leaf {errs}, "
          f"|err| / (atol + rtol |want|) per leaf {ratios}")
    check(ok, "bayes_fit outside rtol 5e-3 / atol 5e-4 of its plain version")
    out["bayes_fit"] = (max(errs.values()), max(ratios.values()))
    return out


def paper_experiment(wf: str, ts: int, device):
    """benchmarks/common.build_experiment for the Lotaru variants, on the
    port and the given device."""
    from repro_torch.core.microbench import (app_benchmark_runtime,
                                             simulate_microbench)
    from repro_torch.core.predictor import LotaruPredictor
    from repro_torch.sched.cluster import LOCAL, TARGET_MACHINES
    from repro_torch.workflow.generator import (GroundTruth, WORKFLOW_TASKS,
                                                build_workflow)
    from repro_torch.workflow.profiling import local_profiling
    gt = GroundTruth(wf, seed=0)
    traces, _ = local_profiling(wf, gt, training_set=ts)
    local = simulate_microbench(LOCAL, seed=1)
    benches = {n.name: simulate_microbench(n, seed=1)
               for n in TARGET_MACHINES}
    app_bench = {}
    for m in WORKFLOW_TASKS[wf]:
        b = {"local": app_benchmark_runtime(m.cpu_frac, LOCAL, LOCAL)}
        for n in TARGET_MACHINES:
            b[n.name] = app_benchmark_runtime(m.cpu_frac, n, LOCAL)
        app_bench[m.name] = b
    preds = {
        "lotaru-g": LotaruPredictor("G", local_bench=local, device=device),
        "lotaru-a": LotaruPredictor("A", local_bench=local,
                                    app_bench=app_bench, device=device),
        "lotaru-w": LotaruPredictor("W", local_bench=local, device=device)}
    for p in preds.values():
        p.fit(traces)
    return gt, build_workflow(wf, 0), benches, preds


def paper_round(gt, dag, benches, pred, cluster_seed: int):
    """predict_rows to the target machines, then HEFT + simulation on a
    20-node cluster.  -> (MPE %, rows array, makespan, schedule)."""
    from repro_torch.online import PredictionService
    from repro_torch.sched.cluster import TARGET_MACHINES
    from repro_torch.sched.heft import heft_schedule_matrix
    from repro_torch.sched.plane import PredictionMatrix
    from repro_torch.workflow.simulator import execute_schedule, random_cluster
    targets = [benches[n.name] for n in TARGET_MACHINES]
    tasks = list(dag.tasks.values())
    rows = pred.predict_rows(tasks, targets, dag.name)
    actual = np.asarray([gt.runtime(t.task_name, t.input_gb, n, t.uid)
                         for t in tasks for n in TARGET_MACHINES])
    got = np.asarray([[r.predicted_s, r.lower_s, r.upper_s] for r in rows])
    mpe = 100.0 * float(np.median(np.abs(got[:, 0] - actual) / actual))
    nodes = random_cluster(np.random.default_rng(cluster_seed),
                           list(TARGET_MACHINES), n_nodes=20)
    svc = PredictionService(pred, benches, device=pred.device)
    entries = [(u, t.task_name, t.input_gb) for u, t in dag.tasks.items()]
    sched = heft_schedule_matrix(dag, nodes,
                                 PredictionMatrix.from_service(svc, entries,
                                                               nodes))

    def true_rt(uid, node):
        t = dag.tasks[uid]
        return gt.runtime(t.task_name, t.input_gb, node, uid)
    res = execute_schedule(dag, sched, nodes, true_rt)
    return mpe, got, res.makespan, sched


def same_schedule(a, b) -> bool:
    return (a.assignment == b.assignment and a.order == b.order
            and a.est == b.est)


def phase_paper(dev) -> None:
    from repro_torch.convert import predictor_from_state, predictor_state
    from repro_torch.workflow.generator import WORKFLOWS
    for wf in WORKFLOWS:
        for ts in (0, 1):
            gt, dag, benches, preds = paper_experiment(wf, ts, dev)
            _, _, _, cpu_preds = paper_experiment(wf, ts, "cpu")
            seed = 100 + 2 * WORKFLOWS.index(wf) + ts
            line = []
            for meth, pred in preds.items():
                mpe, rows, span, sched = paper_round(gt, dag, benches, pred,
                                                     seed)
                check(np.isfinite(rows).all() and rows.shape[1] == 3,
                      f"{wf}/{ts}/{meth}: non-finite predictions")
                cmpe, _, cspan, _ = paper_round(gt, dag, benches,
                                                cpu_preds[meth], seed)
                check(abs(mpe - cmpe) <= MPE_REL_TOL * abs(cmpe),
                      f"{wf}/{ts}/{meth}: MPE {mpe} on the card vs {cmpe} "
                      f"on the CPU")
                carried = predictor_from_state(predictor_state(pred), "cpu")
                _, crows, cspan2, csched = paper_round(gt, dag, benches,
                                                       carried, seed)
                check(np.array_equal(rows, crows),
                      f"{wf}/{ts}/{meth}: predict_batch not bitwise equal "
                      f"to the CPU run on the same posteriors")
                check(same_schedule(sched, csched) and span == cspan2,
                      f"{wf}/{ts}/{meth}: schedule differs from the CPU "
                      f"run on the same posteriors")
                line.append(f"{meth} MPE {mpe:.4f}% (cpu {cmpe:.4f}%) "
                            f"makespan {span:.1f} s (cpu {cspan:.1f} s)")
            print(f"[paper] {wf} ts={ts}: " + "; ".join(line))


def phase_fleet(dev, fleet) -> dict:
    from repro_torch.convert import predictor_from_state
    from repro_torch.core.microbench import simulate_microbench
    from repro_torch.online import PredictionQuery, PredictionService
    from repro_torch.sched.cluster import LOCAL, TARGET_MACHINES
    from repro_torch.sched.heft import heft_schedule_matrix
    from repro_torch.sched.plane import PredictionMatrix
    from repro_torch.store import PosteriorStore
    from repro_torch.store.compute import LEAVES, fit_stacked

    # -- replan round, 1000 tasks x 100 nodes -------------------------------
    dag, nodes, svc = replan_problem(1000, 100, 0, dev)
    entries = [(u, t.task_name, t.input_gb) for u, t in dag.tasks.items()]
    queries = [PredictionQuery(t.task_name, n.name, t.input_gb)
               for t in dag.tasks.values() for n in nodes]
    t0 = time.perf_counter()
    mat = PredictionMatrix.from_service(svc, entries, nodes)
    t1 = time.perf_counter()
    flat = svc.predict_batch(queries)
    t2 = time.perf_counter()
    sched = heft_schedule_matrix(dag, nodes, mat)
    t3 = time.perf_counter()
    check(flat.shape == (len(queries), 3) and np.isfinite(flat).all(),
          "predict_batch: bad shape or non-finite values")
    check(np.array_equal(flat[:, 0].reshape(mat.means.shape), mat.means),
          "predict_batch disagrees with predict_matrix")
    cpu = PredictionService(svc.predictor, dict(svc.benches), device="cpu")
    check(np.array_equal(cpu.predict_batch(queries), flat),
          "predict_batch on the card differs from the CPU run")
    cmat = PredictionMatrix.from_service(cpu, entries, nodes)
    check(same_schedule(heft_schedule_matrix(dag, nodes, cmat), sched),
          "1000x100 schedule differs from the CPU run")
    print(f"[fleet] replan 1000x100: predict_matrix {t1 - t0:.4f} s, "
          f"predict_batch (Q={len(queries)}) {t2 - t1:.4f} s, HEFT "
          f"{t3 - t2:.4f} s, predicted makespan "
          f"{sched.predicted_makespan:.1f} s")

    # -- fleet refit: one bayes_fit launch, 64 tenants ----------------------
    xb, yb, mb = fleet
    t0 = time.perf_counter()
    post = fit_stacked(xb, yb, mb, device=dev)
    t1 = time.perf_counter()
    for leaf, v in post.items():
        check(np.isfinite(v).all(), f"fleet refit: {leaf} not finite")
    per = N_FLEET // N_TENANTS
    store = PosteriorStore()
    store.put_many([(f"t{i // per:02d}/fleet/task{i % per:04d}",
                     {leaf: post[leaf][i] for leaf in LEAVES})
                    for i in range(N_FLEET)])
    t2 = time.perf_counter()
    local = simulate_microbench(LOCAL, 1)
    benches = {n.name: simulate_microbench(n, 1) for n in TARGET_MACHINES}
    n_queries, serve_s = 0, 0.0
    for ten in range(N_TENANTS):
        rows = range(ten * per, (ten + 1) * per)
        state = {"variant": "G", "threshold": 0.75,
                 "local_bench": {f: getattr(local, f) for f in
                                 ("name", "cpu", "mem", "io_read",
                                  "io_write")},
                 "app_bench": {},
                 "models": {f"task{i % per:04d}": {
                     "correlated": True,
                     "posterior": {k: post[k][i] for k in post},
                     "median_s": float(np.median(yb[i][mb[i] > 0])),
                     "spread_s": 1.0, "cpu_fraction": 0.5,
                     "fit_x": None, "fit_y": None} for i in rows}}
        pred = predictor_from_state(state, dev)
        qs = [PredictionQuery(f"task{i % per:04d}", n.name,
                              float(xb[i, 0]) * 2.0)
              for i in rows for n in TARGET_MACHINES[:4]]
        s0 = time.perf_counter()
        out = PredictionService(pred, benches, store=store,
                                tenant=f"t{ten:02d}",
                                workflow="fleet",
                                device=dev).predict_batch(qs)
        serve_s += time.perf_counter() - s0
        n_queries += len(qs)
        ref_out = PredictionService(predictor_from_state(state, "cpu"),
                                    benches, device="cpu").predict_batch(qs)
        check(np.array_equal(out, ref_out),
              f"tenant t{ten:02d}: served predictions differ from the CPU")
    print(f"[fleet] refit T={N_FLEET} N={xb.shape[1]}: fit_stacked "
          f"{t1 - t0:.4f} s, put_many under {N_TENANTS} tenants "
          f"{t2 - t1:.4f} s (generation {store.generation}), "
          f"{n_queries} queries served per tenant in {serve_s:.4f} s")
    return {"replan_queries": queries, "replan_service": svc}


def bounds_predict(q: int) -> tuple:
    """Least time for q predictive queries: 96 B read + 16 B written per
    query; 20 float64 operations per query."""
    t_bytes = q * 112 / H100_BYTES_PER_S * 1e3
    t_ops = q * 20 / H100_FP64_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bounds_fit(mask: np.ndarray) -> tuple:
    """Least time for one batched fit: x, y, mask read once (12 B per
    cell), 13 float32 outputs per task written once; per valid point about
    18 operations of standardization and Gram plus 5 per fixed-point
    residual (30 iterations), per task about 50 scalar operations per
    iteration."""
    t, n = mask.shape
    t_bytes = (t * n * 12 + t * 13 * 4) / H100_BYTES_PER_S * 1e3
    ops = float(mask.sum()) * (18 + 30 * 5) + t * (30 * 50 + 40)
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def raw_launch(name: str, args):
    """A callable that launches kernel `name` through its C entry point
    with fixed arguments (tensors become pointers; the current stream is
    appended): back-to-back calls of it time the kernel, not the wrapper's
    checks and allocations."""
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    fn = getattr(kernels._lib(), f"lotaru_{name}")
    full = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args] + [torch.cuda.current_stream().cuda_stream]

    def launch():
        rc = fn(*full)
        check(rc == 0, f"{name} launch failed with CUDA error {rc}")
    return launch


def time_predict(x, post) -> dict:
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import ref
    from repro_torch.store.compute import LEAVES
    out = [torch.empty_like(x), torch.empty_like(x)]
    launch = raw_launch("bayes_predict", [x] + [post[k] for k in LEAVES]
                        + out + [x.shape[0]])
    return {"ms": time_ms(launch),
            "wrapper_ms": time_ms(lambda: kernels.bayes_predict(x, post)),
            "plain_ms": time_ms(lambda: ref.bayes_predict_ref(x, post),
                                reps=5)}


def phase_report(dev, launches, errors, fleet, fleet_out) -> list:
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.store import TaskKey
    svc = fleet_out["replan_service"]
    queries = fleet_out["replan_queries"]
    post = svc.store.snapshot().gather(
        [TaskKey(svc.tenant, svc.workflow, q.task) for q in queries])
    x = torch.tensor([q.input_gb for q in queries], dtype=torch.float64,
                     device=dev)
    pc = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
          for k, v in post.items()}
    q = x.shape[0]
    pt = time_predict(x, pc)
    p_bound, p_by = bounds_predict(q)

    xb, post_big = random_posteriors(np.random.default_rng(11),
                                     Q_PREDICT_CHECK)
    big = time_predict(torch.from_numpy(xb).to(dev),
                       {k: torch.from_numpy(v).to(dev)
                        for k, v in post_big.items()})
    big_bound, _ = bounds_predict(Q_PREDICT_CHECK)
    print(f"[report] bayes_predict Q={q}: {pt} bound {p_bound!r} ms")
    print(f"[report] bayes_predict Q={Q_PREDICT_CHECK}: {big} bound "
          f"{big_bound!r} ms")

    fx, fy, fm = (torch.from_numpy(a).to(dev) for a in fleet)
    t, n = fx.shape
    fout = [torch.empty(t, k, device=dev) for k in (2, 4, 1, 1, 1, 1, 1, 1,
                                                    1)]
    launch = raw_launch("bayes_fit", [fx, fy, fm, t, n] + fout)
    f_ms = time_ms(launch)
    f_wrapper = time_ms(lambda: kernels.bayes_fit(fx, fy, fm))
    f_plain = time_ms(lambda: plain_fit_chunked(fx, fy, fm), reps=3,
                      inner=1)
    f_bound, f_by = bounds_fit(fleet[2])
    print(f"[report] bayes_fit T={t} N={n}: ms {f_ms!r}, wrapper_ms "
          f"{f_wrapper!r}, plain_ms {f_plain!r}, bound {f_bound!r} ms")
    src = "src/repro_torch/kernels/csrc/bayes.cu"
    return [
        {"name": "bayes_fit", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/bayes_fit.py:94",
         "launches": launches["bayes_fit"],
         "max_abs_err": errors["bayes_fit"][0],
         "tolerance": "rtol 5e-3 atol 5e-4",
         "tol_ratio": errors["bayes_fit"][1], "ms": f_ms, "plain_ms": f_plain,
         "bound_ms": f_bound, "bound_by": f_by, "library_ms": None,
         "wrapper_ms": f_wrapper,
         "shape": f"T={fleet[0].shape[0]} N={fleet[0].shape[1]}"},
        {"name": "bayes_predict", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/bayes_fit.py:343",
         "launches": launches["bayes_predict"],
         "max_abs_err": errors["bayes_predict"][0], "tolerance": "bitwise",
         "tol_ratio": errors["bayes_predict"][1], "ms": pt["ms"],
         "plain_ms": pt["plain_ms"], "bound_ms": p_bound, "bound_by": p_by,
         "library_ms": None, "wrapper_ms": pt["wrapper_ms"],
         "shape": f"Q={q}"},
    ]


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"the port is not beside this script ({SRC}/repro_torch)")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: this script drives the port on a GPU")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels.bayes_fit import pad_ragged
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain fit's Gram
    torch.backends.cudnn.allow_tf32 = False         # products in full fp32
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase_build()
    fleet = pad_ragged(*fleet_buffers(np.random.default_rng(7), N_FLEET))
    errors = phase_kernels(dev, fleet)

    kernels.bayes_fit.launches = 0
    kernels.bayes_predict.launches = 0
    phase_paper(dev)
    fleet_out = phase_fleet(dev, fleet)
    launches = {"bayes_fit": kernels.bayes_fit.launches,
                "bayes_predict": kernels.bayes_predict.launches}
    print(f"[launches] main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    report = phase_report(dev, launches, errors, fleet, fleet_out)
    print(f"[chip_smoke] {time.perf_counter() - t_start:.1f} s in all")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(json.dumps({"kernels": report}))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
