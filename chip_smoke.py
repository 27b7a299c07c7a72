#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Lotaru (`src/repro_torch`) on one NVIDIA
card, end to end, and hold every kernel against its plain version.

    python3 chip_smoke.py

Phases (each fails loudly; nothing is caught):
  1. build   — nvcc builds the hand-written kernels from the checkout, one
               process per source, all started together; ptxas' registers
               and spills per kernel, and the fit kernel's route, grid,
               dynamic shared memory and blocks an SM at N = 64, 37, 1024.
  2. kernels — `bayes_predict` on packed batches (`pack_predict`) bitwise
               against core.bayes.predict_blr_np at 2**20 random posteriors,
               and against its plain version evaluated on the CPU in float64
               at the main path's Q (1, 140, 1000, 33,800, 100,000, 2**20;
               ragged last tiles) in both output forms: interleaved, and
               scattered into 38 planes' resident rows through the slab's
               target table; `bayes_fit` on 65,536 ragged
               buffers of 3-64 points, within rtol 5e-3 / atol 5e-4 of its
               plain version (the batched fit_blr) on the CPU, and so on
               low-noise rows, T = 1037, N = 37, N = 1024 (rows staged a
               chunk at a time), one-point and fully masked rows and
               operands off a 16-byte boundary, each line with its
               tol_ratio and the kernel's route and launch shape; `fused_cost`
               on a cost slab (`pack_cost`) and a static factor matrix on
               the card, at 1000 x 100 random posteriors (with rows under
               the 1e-3 mean floor and rows whose var_s is <= 0), 1037 x
               7, 1 x 1 and 1000 x 101, z = 0 and z(0.95), bitwise
               against its plain version on the CPU.
  3. paper   — the paper's pipeline for the five nf-core workflows, training
               sets 0 and 1, Lotaru-G/A/W: profile, fit, predict to the
               target machines, HEFT on a 20-node cluster, simulate.  Held
               against the same run on device="cpu" (MPE within 1e-3
               relative) and, with the posteriors carried across, bitwise.
  4. fleet   — the 1000-task x 100-node replan round (predict_matrix, a
               100,000-query predict_batch, HEFT), then a fleet refit of
               65,536 buffers in one bayes_fit launch, stored under 64
               tenants and served per tenant.
  5. plan    — the same replan round through HEFT placement on the card:
               `cost_view` (one cost slab up, one fused_cost launch over
               it and the resident static factors) and
               `fused_heft_schedule(engine="device")` (one upward_rank and
               one eft_sweep launch per round, the rank order sorted on the
               card), cold and warm (rank_cache reused), at q = None
               and 0.95 and as a constrained replan; each schedule
               identical to the host `heft_schedule_matrix`, and every
               sweep on the shared route (state in shared memory).  A
               warm round piece by piece, after the launch counts are
               read: `cost_view`'s split (order, sync, node corrections,
               the store's gather into the pinned slab, its copy up, the
               resident factors, the launch) and the placement's.  Then
               the sweep kernel against its plain version on the CPU: a
               round whose slot retry doubles S from 4 (shared route), and
               direct launches, each on the route it must take: S = 48
               (shared), S = 192 at N = 100 (307 KB of interval stacks:
               global), a pack padded with masked rows (shared), 1500
               nodes (more nodes than a block has threads: global), a
               chain in which every task depends on the one placed just
               before it, and a pack of exact ties across warps of nodes
               (both shared).
  6. ingest  — the online write path on the card.  The workflow loop: the
               replan problem's predictor wrapped in
               `OnlinePredictor(device="cuda")`, fed 8 batches of local and
               remote completions through `observe_many` (every fold group
               one `nig_fold` launch), then re-predicted (predict_batch)
               and re-placed (`cost_view` + `fused_heft_schedule(engine=
               "device")`).  Its `export_state` must equal that of a CPU
               port predictor driven by the scalar `observe`, and the
               predictions and schedule the CPU run's.  The fleet fold:
               an OnlinePredictor over the 65,536 fleet posteriors takes
               1-8 local completions per task in one `observe_many`; its
               state must equal the CPU numpy fold's, and `nig_fold` on
               the fold's ragged slab must be bitwise its plain version on
               the CPU, and so on an ingest group (6 x 42), one row, a tile
               whose last rows hold nothing, T = 1037 and a tile with rows
               longer than a block's shared budget (walked from global
               memory; each line counts them).
  7. plane   — the resident decision plane on the card: the replan
               problem's predictor wrapped in `OnlinePredictor(device=
               "cuda")`, a `FusedPlane` over it, and rounds of
               `plane.schedule(engine="device")` at q = 0.95: cold, warm
               with nothing moved (no predictive launch, no factor matrix,
               no new W), then one after each of phase 6's ingest batches
               (one `bayes_predict` launch over the dirty rows, one
               `upward_rank`, one `eft_sweep`; no host copy of W in any
               round).  Each round's matrix bitwise
               `PredictionMatrix.from_service` on a fresh service, each
               schedule identical to `heft_schedule_matrix`.  Each round's
               split (sync and gather, predict, scale and cost, ranks,
               sweep, rebuild) from a replay on a second plane, in turns
               with the old `cost_view` + `fused_heft_schedule` round on
               the same state, and that round's `cost_view` split (order,
               sync, node corrections, gather, copy up, factors, launch).
  8. replan  — many workflows a round: 32 DAGs of the replan problem's
               generator (1000 tasks) on its 100-node cluster and 6 DAGs
               of 300 tasks on a second, 30-node cluster (the reference
               benchmark's megabatch, benchmarks/fused_plane.py:50), each
               a `FusedPlane` over one `OnlinePredictor(device="cuda")`,
               all 38 in one `replan_many` a round at q = 0.95: cold, warm
               with nothing moved, then one after each of phase 6's first
               two batches.  A round: one `bayes_predict` launch when rows
               moved and none when none did, one `upward_rank` and one
               `eft_sweep_many` launch a cluster, no host copy of W.  Every
               schedule identical to replicas' replayed `replan_many` and
               per-request `plane.schedule(engine="device")`, and in the
               cold round to `heft_schedule_matrix`; each round's split
               (sync and gather, predict, scale and cost, ranks, sweep and
               rebuild) beside the 38 per-request rounds on the same state.
               Then `upward_rank` bitwise `_PlanContext.ranks` and its plain
               version on the replan DAG, a 1000-task chain, a fan, a DAG
               whose levels alternate between more and at most 32 rows
               (the shared route), a lane whose tables overflow shared
               memory and the replan lane's tables off a 16-byte boundary
               (the global route), one lane a launch and in two mixed-T
               launches, each launch's route counted; a NaN lane among
               finite ones flagged alone; and `eft_sweep_many` bitwise its
               plain version on the CPU for lanes of T 1000, 850, 700 and
               300, four tie packs, the first at S = 4, and two lanes on
               1500 nodes (the global route, a launch a lane); the second
               cluster replanned from 4 interval columns (a slot retry on
               the shared route).  After every path's checks, the plane's
               warm round (20 pairs) and this cell's (10 pairs), on fresh
               planes after a cold round, are timed with the rank launch
               on its own route and forced onto the global route (PR 28's
               kernel and launch), in turns.  Before them, under
               torch.profiler on fresh planes: a plane's and the 38
               workflows' dirty row sync (`FusedPlane.sync`,
               `sync_planes`) make one copy up, one bayes_predict kernel
               and no index_copy; the whole dirty round after the next
               batch one bayes_predict kernel and no index_copy; a fold
               one copy each way and one nig_fold kernel; a warm
               `cost_view` one copy up and one fused_cost kernel.
  9. adaptive — in-flight rescheduling and speculation through
               `execute_adaptive` with the port's
               `OnlineReschedulingPlanner` (its `FusedPlane` and service
               on the card, `engine="device"`): every completion one
               scalar `observe` and one `bayes_predict` over the frontier;
               a re-plan one `bayes_predict` for the running tasks, the
               plane's dirty rows in one more, the frontier sub-DAG's cost
               view taken on the card from the resident scaled pair, one
               `upward_rank` and one `eft_sweep` (no host copy of W).
               First the paper scenario of benchmarks/online_adaptation.py
               (the five workflows on the five target machines, true
               speeds drifted by class): static, adaptive and oracle
               makespans.  Then the 1000 x 100 replan problem, true
               runtimes the CPU service's mean x the drift x a seeded
               lognormal (sigma 0.1), 8 % stragglers x 5, speculation at
               q 0.95 every 15 s, a cooldown of 25 completions.  Every
               `SimResult` identical to the port's CPU run (numpy engine)
               over the same posteriors, and `RescheduleStats`, the
               plane's counters and `predicted_cost_quantile` (q 0.95,
               minute billing) of the last schedule equal; one
               `upward_rank` and one `eft_sweep` a device round.  Printed:
               the run's host time, a completion's without a re-plan, and
               a re-plan's split (sub-DAG and context, running tasks'
               estimate, ready rows, plane sync, cost view, ranks, sweep
               and copy back, rebuild, the rest).
 10. refresh — the maintenance plane: the 65,536 fleet posteriors as 64
               tenants of 1,024 tasks, each an `OnlinePredictor(device=
               "cuda")` bound to one store, fed its share of phase 6's
               fleet completions and synced in one generation; one
               `FleetRefresher.refresh()`: one `bayes_fit` launch, one
               store generation, its split (due, snapshot, pad, fit,
               apply, put_many, cursor); then a `FusedPlane` over tenant
               t00 re-predicts the rows the publish dirtied in one
               `bayes_predict` launch.  The store's rows within rtol 1e-4
               / atol 1e-5 of the same refresh on device="cpu".
 11. checkpoint — the store's durability and shipping and the batch-window
               frontend on the refresh fleet's store (64 tenants x 1,024
               tasks, 65,536 rows in 128 blocks of 512): a full `save`,
               `restore` and `resume` of all 64 tenants (fresh predictors
               built as `refresh_fleet` builds them), each tenant's 256
               seeded queries bitwise the pre-restart answers, every row
               bitwise, and a `FusedPlane.schedule(engine="device")` over
               t00 (1,024 tasks on 100 nodes) identical before and after
               (every row re-predicted cold, none warm); an ingest batch
               of 250 completions in t00-t03 and `save(incremental=True,
               keep_last=2)` writing exactly the blocks whose generation
               moved, the older generation restoring the pre-ingest
               answers and the live one the post-ingest ones; a passive
               replica bootstrapped by `export_blocks(-1)` and then sent
               the delta (only the moved blocks), `predict_stacked` of all
               rows on it bitwise the primary's; `export_namespaces` of 8
               tenants into a live store holding other rows, resumed, its
               answers bitwise the source's; `AsyncPredictionFrontend` on
               benchmarks/service_throughput.py's 4,096 queries in 16
               callers: a manual flush one `bayes_predict` launch at
               Q = 4,096, then 5 auto-flush rounds of 16 threads (fewer
               dispatches than the 80 caller batches), once more with
               `predict_batch` on the main thread and a `FleetRefresher`
               (attached through `refresher=`) fitting 2,048 due tasks of
               the migrated store on its own thread; every caller's array
               bitwise `predict_batch` of its queries in a quiet run; then
               `run_local_microbench(device=...)`.  The `[checkpoint]` and
               `[frontend]` lines carry host-clock times, bytes on disk
               and queries a second, each beside the card's name and
               power limit.
 12. serve   — the sharded serving tier (`repro_torch.serve`) over the
               refresh fleet (64 tenants x 1,024 tasks), placed by a
               `ShardMap` on three shards s0-s2 on the card, each with its
               frontend (window 2 ms), oplog and checkpoint directory.  In
               one event loop: the shards cold-booted in-process
               (`boot_shard`) and driven by the port's `ServingClient`: 5
               rounds of 16 concurrent workers' `predict_many` (the
               checkpoint phase's frontend queries, 4,096 a round, a
               worker's 256 of one tenant) and a `predict_matrix` of t00
               on the target machines, every answer bitwise an in-process
               `PredictionService` on the card over the same posteriors;
               8 `observe_many` batches of 250 completions, acks dense
               per shard, one COW generation a drain (`health`), every
               tenant's `digest` over the wire equal to an in-process
               predictor fed the same completions; `queue_full` from a
               shard of max_pending_batches=1 as `QueueFullError`; a
               client on a stale map healed by `wrong_shard`; a `refresh`
               RPC to t00's shard after `every_n` + 8 completions on two
               of its tasks: one `bayes_fit` launch, the state bitwise an
               in-process `FleetRefresher`'s.  A
               `ReplicaServer` on the card fed by a `ReplicaShipper` from
               t00's shard: the bootstrap, a delta of only the moved
               blocks, `predict_base` bitwise the primary, a read past
               `max_generation_lag` refused, no ship error; each install
               frame's bytes as shipped and, of the same payload, under
               the JSON fallback, all under `MAX_FRAME`.
               A fourth shard added with `RebalanceCoordinator.add_shard`
               and removed again, each under a predict worker (answers
               bitwise) and an observe worker (every acked observation in
               the digests).  Then the three shards as processes of the
               port's `ShardSupervisor` (`--device cuda`, the bootstrap
               `serve_bootstrap` reading the fleet posterior from an npz):
               observed, checkpointed, observed again, one SIGKILLed and
               failed over (restore, resume, replay) and readmitted
               (`with_address`): digests bit-identical, the replay count
               the acks past the checkpoint, predictions bitwise, SIGKILL
               to READY within 30 s.  The children's launches are not
               counted by the parent.
 13. lm      — the LM serving slice.  Full-size RecurrentGemma-9B
               (bfloat16, weights made on the card from a seed) served
               through `repro_torch.launch.serve`: B = 2 prompts of 4096
               tokens (past the 2048 window, so the rings wrap), 16
               generated tokens; prefill time and prompt tokens/s, decode
               ms/step and tokens/s, peak device memory (beside the
               earlier mma.sync kernel's), the Lotaru next-token line,
               and exactly one `flash_attention` launch per local-attention
               layer (12, all on the wgmma kernel's heads pairing) and one
               `rglru_scan` per RG-LRU layer (26).  Before it, each kernel against its
               plain version on the card: `rglru_scan` bitwise at (2,
               4096, 4096) from h0 != 0; `flash_attention`'s C shape
               formulas against their Python mirrors, then the kernel at
               the path's shape in bfloat16 (5e-2 and rtol 1e-2 / atol
               4e-3) and float32 (2e-5), and at the edges: ragged S at
               B = 2 (1000 and 4097), windows 0, 1 and 64, not causal,
               GQA groups 8, 2 and 3, MHA, hd 64 and 128.  After it, at
               full width with the depth cut
               to one (r, r, l) cycle in float32: prefill logits on the
               card against the port's CPU run on the same weights (1e-4),
               and prefill of S = 2100 against prefill of S - 1 plus one
               decode step (2e-3); then one prefill and 4 decode steps
               under torch.profiler (device time by kernel, busy share).
 14. train   — the training slice.  Before it, the backward kernels
               against their plain versions on the card: `flash_attention`
               with lse bitwise the forward without it (its lse within
               rtol 1e-5 / atol 1e-4 of the plain one); `flash_attention_bwd`
               at SmolLM-360M's shape (B 8, S 2048, 15 heads over 5, hd 64,
               causal) and RecurrentGemma-9B's (B 1, S 4096, 16 over 1, hd
               256, window 2048) and the forward's edges, bf16 at 5e-2 and
               rtol 1e-2 / atol 4e-3, f32 at 2e-5, bitwise across two
               launches; `rglru_scan_bwd` bitwise its plain version and
               across two launches.  Then SmolLM-360M at full size through
               `repro_torch.launch.train.main` (B 8, S 2048): the Lotaru
               profile and prediction, 30 AdamW steps with a checkpoint
               directory (step median, tokens/s, model-flop utilisation
               against `perf.roofline`, peak memory, the prediction beside
               the measured median, the Young-Daly interval); a child run
               killed after its first
               checkpoint and main restarted on its directory (resumed at
               the saved step, losses within 1e-3 of the uninterrupted
               run's, bitwise or not); one step's loss and every gradient
               leaf, kernel route against plain route on the card, for
               SmolLM (2 layers) and RecurrentGemma-9B (one cycle, S 4096)
               at full width in bf16 (5e-2) and f32 (1e-4), every
               real-head and RG-LRU leaf non-zero, pad rows exactly zero;
               each forward and backward kernel launched once per layer a
               step.  After every path's checks, one step under
               torch.profiler (busy share, the top kernels, the attention
               kernels' sums).
 15. report  — per-kernel launches on the main path (phases 3-14, each
               path with the counts set to 0 just before it), errors, and
               times at the main path's shapes beside their bounds: CUDA events
               around one call with the L2 flushed before it, through the
               C entry point (`ms`, the kernel; for the sweep also the
               global route at S = 192, `global_ms`), through the Python
               wrapper (`wrapper_ms`, what a caller pays) and of the plain
               version on the card (`plain_ms`); `warm_ms` is the kernel
               back to back on the same operands.  For the fold also
               `observe_many`'s split (kernel, copies, host) and the host
               numpy fold at the same size.  For `flash_attention` also
               `library_ms`: one SDPA call over the same band as a boolean
               mask (kv heads expanded before it, untimed), and the
               achieved TFLOP/s of `ms` and `warm_ms`.  For
               `bayes_predict` also the times at Q = 1, at the paper path's
               median Q, at 1,000, at 100,000 and at 2**20, the launch
               floor (the time at 100,000 less the slope to 2**20), an
               empty kernel's times beside it (at one block and at the
               Q = 100,000 grid), the main path's launches by Q, the
               host's side of its operand at the main path's Q (filling
               the slab in pinned memory, filling it with the one copy
               up, and for reference eight pageable copies of the same
               leaves) and
               one scattering launch into 38 planes (Q = 33,800).  For
               `fused_cost` also `pack_ms`, packing its cost slab and the
               copy up.  For
               `upward_rank` (at one lane) and
               `eft_sweep_many` (at 32 lanes) also the other lane count,
               and beside the ranks the host ranks they replace, the
               global route's time, the route and cluster size, the
               latency bound beside the bytes bound, and a 1000-level
               chain.
               For the backward kernels also `forward_ms` and SDPA's
               backward as `library_ms` (causal with `enable_gqa` at the
               SmolLM shape, a band mask at the RecurrentGemma one).
               `tol_ratio` is the worst |got - want| / (atol + rtol *
               |want|) over all outputs: at most 1 is within the stated
               tolerance.

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

# H100 SXM data sheet peaks (dense, no sparsity), used for the bounds: set
# by main() from repro_torch.perf.roofline, the port's one copy of them
H100_BYTES_PER_S = H100_BF16_FLOPS = None
H100_FP32_FLOPS = H100_FP64_FLOPS = None
H100_CLOCK_HZ = 1.98e9           # SXM5 maximum boost clock

FIT_TOL = dict(rtol=5e-3, atol=5e-4)
N_FLEET = 65536
FLEET_COLS = 64                  # pad_ragged's bucket of the fleet buffers
N_TENANTS = 64
Q_PREDICT_CHECK = 1 << 20
# the predictive's main-path shapes: one query, the paper path's median,
# a paper-sized launch, the 38-workflow round after a batch, the fleet's
# predict_batch and the 2**20 check
PREDICT_CHECK_QS = (1, 140, 1000, 33800, 100000, Q_PREDICT_CHECK)
PREDICT_PLANES = 38              # the replan cell's planes
MPE_REL_TOL = 1e-3
TASK_TYPES = ("bwa", "idx", "dedup", "qc", "merge", "report")
PLAN_TASKS, PLAN_NODES = 1000, 100
COST_CHECK_SHAPES = ((PLAN_TASKS, PLAN_NODES), (1037, 7), (1, 1),
                     (PLAN_TASKS, 101))
PLAN_QUANTILE = 0.95
S_DIRECT = 192                   # 2 x 192 x 100 float64 stacks: 307 KB
WIDE_NODES = 1500                # > 1024 threads: a thread owns two nodes
# the least latency of one sweep step, in cycles (a reckoning, not a
# measurement): three block barriers (~20 each), ten shuffle levels of the
# two-stage argmin over up to 1024 threads (~25 each), two dependent L1
# reads (a dependency's finish time, then an interval; ~35 each) and a
# chain of about eight float64 max/add/compare (~4 each)
SWEEP_STEP_CYCLES = 3 * 20 + 10 * 25 + 2 * 35 + 8 * 4
# the least latency of one level of the rank walk from shared memory, in
# cycles (a reckoning, not a measurement): four dependent shared-memory
# reads (a level's row, its successor range, a successor, that successor's
# rank; ~30 each), a dependent float64 add, max and add (~4 each) and one
# barrier (~20)
RANK_LEVEL_CYCLES = 4 * 30 + 3 * 4 + 20
SM_FILL_BYTES = 64               # a cycle from the L2 into one SM (reckoned)
# the rank checks' DAG whose levels alternate between more and at most 32
# rows (from the sources down; 950 tasks, so that the shared route's
# mixed launch holds lanes of two T)
NARROW_WIDE_LAYERS = (250, 4, 250, 32, 200, 1, 150, 12, 51)
OVERFLOW_TASKS, OVERFLOW_FAN_IN = 3000, 25   # tables past shared memory
INGEST_BATCHES, INGEST_BATCH = 8, 250
INGEST_DRIFT = 1.6               # remote nodes run this much slower than
                                 # their static factor says
FOLD_COLS = 8                    # fleet fold: 1-8 completions per task
# float64 operations of one fold step (core.bayes._nig_step, three of them
# divides, plus the b floor and the mask test)
FOLD_STEP_OPS = 60
LM_ARCH = "recurrentgemma-9b"
LM_BATCH, LM_PROMPT, LM_GEN = 2, 4096, 16   # the prompt passes the 2048
                                            # window, so the rings wrap
LM_SEED, LM_CUT_SEED = 0, 1
LM_CUT_S = 2100                  # the full-width, cut-depth checks' length
LM_PROFILE_STEPS = 4
# the serve path's prefill and peak memory with the earlier mma.sync
# flash_attention kernel (PERF.md section 5), printed beside this run's
LM_MMA_PREFILL_S, LM_MMA_PEAK_GB = 0.568, 18.68
BF16_TOL = dict(rtol=5e-2, atol=5e-2)      # tests/test_kernels.py:31-41
# The bf16 kernel's own limit, set from its error: one bf16 ulp is at most
# 0.78 % of |want| (rtol), and P rounded to bf16 before P.V moves rows of
# few keys whose values cancel by up to ~2e-3 (atol).  phase_lm_kernels
# shows that a band one key too wide falls outside it.
BF16_KERNEL_TOL = dict(rtol=1e-2, atol=4e-3)
F32_TOL = dict(rtol=2e-5, atol=2e-5)       # tests/test_kernels.py:12-28
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_torch_lm.py
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)    # tests/test_models_smoke.py:86


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
    return replan_dag(rng, n_tasks), nodes, svc


def replan_dag(rng: np.random.Generator, n_tasks: int):
    """The replan problem's random DAG: task i of type i mod 6 depends on
    each earlier task with probability min(3 / i, 0.5)."""
    from repro_torch.workflow.dag import TaskInstance, WorkflowDAG
    dag = WorkflowDAG("replan")
    for i in range(n_tasks):
        deps = [f"t{j}" for j in range(i)
                if rng.random() < min(3.0 / max(i, 1), 0.5)]
        dag.add(TaskInstance(f"t{i}", TASK_TYPES[i % len(TASK_TYPES)],
                             "replan", float(rng.uniform(0.05, 4.0)),
                             output_gb=float(rng.uniform(0.0, 2.0)),
                             deps=deps))
    return dag


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
L2_FLUSH_BYTES = 256 << 20      # five times the H100's 50 MB L2
_flush = []


def flush_l2() -> None:
    """Evict the card's L2 by reading a buffer several times its size.  A
    read leaves clean lines behind; a write would leave dirty ones, whose
    write-back the next kernel would pay for."""
    import torch
    if not _flush:
        _flush.append(torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                                 device="cuda"))
    _flush[0].sum()


def time_ms(fn, reps: int = 20, host: bool = False) -> float:
    """Median over `reps` of the CUDA-event time of one call, each with
    the L2 flushed before it (untimed), after a warm-up: a caller that
    finds its operands in device memory, not in the cache.  With
    host=False the flush is still running when the call is enqueued, so
    the time is the device's alone (a kernel); with host=True the card is
    idle first, so the call's host work (a wrapper's checks, the plain
    version's op dispatch) is in the time."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush_l2()
        if host:
            torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def warm_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median over `reps` of CUDA-event time per call across `inner`
    back-to-back calls on the same operands, after a warm-up: operands
    that fit in the L2 are served from it."""
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
    paths = _build.build("bayes", "decision_plane", "flash_attention",
                         "flash_attention_bwd", "rglru_scan")
    print(f"[build] {[os.path.relpath(p, ROOT) for p in paths]} in "
          f"{time.perf_counter() - t0:.3f} s")
    for path in paths:
        with open(path + ".log") as f:
            for line in f:
                if ("entry function" in line or "registers" in line
                        or "spill" in line):
                    print(f"[build] {line.strip()}")
    from repro_torch.kernels import bayes_fit as kernels
    for n in (FLEET_COLS, 37, 1024):
        print(f"[build] bayes_fit_kernel at T={N_FLEET} N={n}: "
              f"{kernels.fit_config(N_FLEET, n)} (smem_bytes: dynamic shared "
              f"memory a block; ptxas reports no static shared memory)")


def cost_inputs(rng: np.random.Generator, t: int, n: int):
    """t posterior rows (a quarter with a mean under the 1e-3 floor, a
    quarter with var_s <= 0), their inputs, a (t, n) static factor matrix
    and n node corrections (every third 1)."""
    x, post = random_posteriors(rng, t)
    q = t // 4
    post["y_mu"][:q] = -rng.uniform(1e3, 1e4, q)
    post["sigma"][q:2 * q] = -np.abs(post["sigma"][q:2 * q]) - 5.0
    base = rng.uniform(0.2, 5.0, (t, n))
    corr = rng.uniform(0.25, 4.0, n)
    corr[::3] = 1.0
    return x, post, base, corr


def cost_pair(dev, x, post, base, corr, z):
    """`fused_cost` on the card, on a slab `pack_cost` packed and a static
    factor matrix allocated as the binding allocates it, and its plain
    version on the CPU on the same values -> (got, want), both on the
    CPU."""
    import torch
    from repro_torch.kernels import decision_plane as plane
    from repro_torch.kernels import ref
    bd = torch.empty(base.shape, dtype=torch.float64, device=dev)
    bd.copy_(torch.from_numpy(base))
    got = plane.fused_cost(plane.pack_cost(dev, x, post, corr), bd, z)
    torch.cuda.synchronize()
    want = ref.fused_cost_ref(plane.pack_cost("cpu", x, post, corr),
                              torch.from_numpy(base), z)
    return got.cpu(), want


def fit_edge_cases(rng: np.random.Generator) -> dict:
    """Direct-launch cases of the fit beside the fleet buffers: low-noise
    rows (3-8 points, 1e-3 relative noise), T off any tile multiple,
    N = 37 (T = 4097: the last tile's 37 floats an array are no 16-byte
    multiple), rows of up to 1,024 points (staged a chunk at a time), and
    one-point rows among fully masked ones."""
    from repro_torch.kernels.bayes_fit import pad_ragged

    def rows(lengths, noise):
        base = rng.uniform(2.0, 30.0, len(lengths))
        slope = rng.uniform(1.0, 60.0, len(lengths))
        xs = [rng.uniform(0.05, 4.0, k) for k in lengths]
        ys = [(b + s * x) * (1.0 + rng.normal(0.0, noise, len(x)))
              for x, b, s in zip(xs, base, slope)]
        return xs, ys

    t = 4096
    edge = rng.integers(0, 4, t)                  # 0: masked, 1: one point
    edge = np.where(edge < 2, edge, rng.integers(2, 6, t))
    return {
        "low-noise": pad_ragged(*rows(rng.integers(3, 9, t), 1e-3)),
        "T=1037": pad_ragged(*rows(rng.integers(3, 65, 1037), 0.05)),
        "N=37": pad_ragged(*rows(rng.integers(1, 38, t + 1), 0.05),
                           col_bucket=37),
        "N=1024": pad_ragged(*rows(rng.integers(3, 1025, 512), 0.05),
                             col_bucket=1024),
        "one-point and masked": pad_ragged(*rows(edge, 0.05)),
    }


def fit_check(dev, label: str, xb, yb, mb, unaligned: bool = False
              ) -> tuple:
    """bayes_fit on (xb, yb, mb) against its plain version on the CPU, per
    leaf within FIT_TOL; returns (max |err|, tol_ratio).  `unaligned`
    places each operand 4 bytes past a 16-byte boundary (the cp.async
    route at any N)."""
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import ref
    t, n = xb.shape

    def on_card(a):
        if not unaligned:
            return torch.from_numpy(a).to(dev)
        buf = torch.empty(t * n + 1, dtype=torch.float32, device=dev)
        return buf[1:].view(t, n).copy_(torch.from_numpy(a))

    args = [on_card(a) for a in (xb, yb, mb)]
    config = kernels.fit_config(t, n, *args)
    got = kernels.bayes_fit(*args)
    torch.cuda.synchronize()
    got = {k: v.cpu() for k, v in got.items()}
    want = ref.bayes_fit_ref(*(torch.from_numpy(a) for a in (xb, yb, mb)))
    errs, ratios = {}, {}
    for leaf, w in want.items():
        g = got[leaf]
        check(bool(torch.isfinite(g).all()),
              f"bayes_fit {label}: {leaf} not finite")
        diff = (g - w).abs()
        errs[leaf] = float(diff.max())
        ratios[leaf] = float((diff / (FIT_TOL["atol"]
                                      + FIT_TOL["rtol"] * w.abs())).max())
    ok = all(r <= 1.0 for r in ratios.values()) and all(
        torch.allclose(got[leaf], w, **FIT_TOL) for leaf, w in want.items())
    ratio = max(ratios.values())
    print(f"[kernels] bayes_fit {label} (T={t} N={n}, "
          f"{int((mb.sum(axis=1) == 0).sum())} fully masked rows, "
          f"{config}) vs plain (CPU): within 5e-3/5e-4 "
          f"{ok}, tol_ratio {ratio!r}, max |err| per leaf {errs}, "
          f"tol_ratio per leaf {ratios}")
    check(ok, f"bayes_fit {label} outside rtol 5e-3 / atol 5e-4 of its "
              f"plain version")
    return max(errs.values()), ratio


def bits_equal(a, b) -> bool:
    """Two float64 tensors (on the CPU) equal bit for bit, NaNs too."""
    import torch
    return torch.equal(a.contiguous().view(torch.int64),
                       b.contiguous().view(torch.int64))


def nan_targets(lens, dev) -> list:
    """Resident rows of the given lengths on `dev`, filled with NaN."""
    from repro_torch.kernels.bayes_fit import PredictTarget
    out = []
    for n in lens:
        t = PredictTarget(int(n), dev)
        t.mean.fill_(float("nan"))
        t.std.fill_(float("nan"))
        out.append(t)
    return out


def predict_check(dev, q: int, seed: int) -> float:
    """`bayes_predict` at q random rows against its plain version on the
    CPU, bitwise, in both output forms: interleaved, and scattered into
    min(q, PREDICT_PLANES) resident planes of ragged sizes (each a few
    rows longer than its share, filled with NaN, destinations shuffled).
    Returns the max |err|."""
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import ref
    rng = np.random.default_rng(seed)
    x, post = random_posteriors(rng, q)
    got = kernels.bayes_predict(kernels.pack_predict(dev, x, post)).cpu()
    want = ref.bayes_predict_ref(kernels.pack_predict("cpu", x, post))
    inter = bits_equal(got, want)
    err = float((got - want).abs().max())
    p = min(q, PREDICT_PLANES)
    firsts = np.concatenate([[0], np.sort(rng.choice(
        np.arange(1, q), p - 1, replace=False))]).astype(int)
    share = np.diff(np.append(firsts, q))
    lens = share + rng.integers(0, 50, p)
    dest = np.concatenate([rng.permutation(n)[:k]
                           for n, k in zip(lens, share)])
    on_card, on_cpu = nan_targets(lens, dev), nan_targets(lens, "cpu")
    kernels.bayes_predict(kernels.pack_predict(
        dev, x, post, dest, list(zip(on_card, share))))
    ref.bayes_predict_ref(kernels.pack_predict(
        "cpu", x, post, dest, list(zip(on_cpu, share))))
    torch.cuda.synchronize()
    scat = all(bits_equal(a.cpu(), b) for t1, t2 in zip(on_card, on_cpu)
               for a, b in ((t1.mean, t2.mean), (t1.std, t2.std)))
    last = q - 256 * ((q - 1) // 256)
    print(f"[kernels] bayes_predict Q={q}: bitwise vs plain (CPU float64) "
          f"interleaved {inter}, scattered into {p} planes {scat} "
          f"({(q + 255) // 256} tiles of 256, the last {last} rows), max "
          f"|err| {err!r}")
    check(inter and scat, f"bayes_predict Q={q} differs from its plain "
                          f"version")
    return err


def phase_kernels(dev, fleet) -> dict:
    import torch
    from repro_torch.core.bayes import predict_blr_np
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import ref
    out = {}
    rng = np.random.default_rng(11)
    x, post = random_posteriors(rng, Q_PREDICT_CHECK)
    got = kernels.bayes_predict(kernels.pack_predict(
        dev, x, post)).cpu().numpy()
    n_mean, n_std = predict_blr_np(post, x)
    host = (np.array_equal(got[:, 0], n_mean)
            and np.array_equal(got[:, 1], n_std))
    print(f"[kernels] bayes_predict Q={Q_PREDICT_CHECK}: bitwise vs "
          f"predict_blr_np {host}")
    check(host, "bayes_predict differs from core.bayes.predict_blr_np")
    err = max(predict_check(dev, q, seed)
              for seed, q in enumerate(PREDICT_CHECK_QS, 40))
    out["bayes_predict"] = (err, 0.0)

    cases = {"fleet": fleet}
    cases.update(fit_edge_cases(np.random.default_rng(17)))
    worst = (0.0, 0.0)
    for label, bufs in cases.items():
        err, ratio = fit_check(dev, label, *bufs)
        worst = (max(worst[0], err), max(worst[1], ratio))
    err, ratio = fit_check(dev, "T=1037 unaligned", *cases["T=1037"],
                           unaligned=True)
    worst = (max(worst[0], err), max(worst[1], ratio))
    out["bayes_fit"] = worst

    from repro_torch.sched.plane import quantile_z
    err = 0.0
    for seed, (t, n) in enumerate(COST_CHECK_SHAPES, 13):
        x, post, base, corr = cost_inputs(np.random.default_rng(seed), t, n)
        mean, _ = predict_blr_np(post, x)
        xs = (x - post["x_mu"]) / post["x_sd"]
        var_s = (1.0 / post["beta_prec"] + post["sigma"][:, 0, 0]
                 + 2.0 * post["sigma"][:, 0, 1] * xs
                 + post["sigma"][:, 1, 1] * xs * xs)
        n_floor, n_var = int((mean < 1e-3).sum()), int((var_s <= 0.0).sum())
        if t >= 4:
            check(n_floor > 0 and n_var > 0, f"fused_cost inputs at {t} x "
                  f"{n} lack rows under the floor or with var_s <= 0")
        for z in (0.0, quantile_z(PLAN_QUANTILE)):
            got, want = cost_pair(dev, x, post, base, corr, z)
            bitwise = torch.equal(got.view(torch.int64),
                                  want.view(torch.int64))
            e = float((got - want).abs().max())
            err = max(err, e)
            print(f"[kernels] fused_cost T={t} N={n} z={z!r}: bitwise vs "
                  f"plain (CPU float64) {bitwise}, max |err| {e!r}, rows "
                  f"under the mean floor {n_floor}, rows with var_s <= 0 "
                  f"{n_var}")
            check(bitwise, f"fused_cost at {t} x {n} (z={z}) differs from "
                           f"its plain version")
    out["fused_cost"] = (err, 0.0)
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
    return {"replan_queries": queries, "replan_service": svc,
            "fleet_post": post,
            "replan_dag": dag, "replan_nodes": nodes}


def phase_plan(dev, fleet_out) -> dict:
    """The main path of HEFT placement on the card: the fleet's replan
    round through `cost_view` and `fused_heft_schedule(engine="device")`,
    cold, then warm with the rank_cache reused, at q = None and 0.95, and
    as a constrained replan.  Returns the schedules and the cost matrices
    for the checks, which run after the launch counts are read."""
    import torch
    from repro_torch.sched.fused import cost_view, fused_heft_schedule
    svc = fleet_out["replan_service"]
    dag, nodes = fleet_out["replan_dag"], fleet_out["replan_nodes"]
    rng = np.random.default_rng(17)
    avail = {n.name: float(rng.uniform(0.0, 200.0)) for n in nodes[::2]}
    ready = {u: float(rng.uniform(0.0, 100.0)) for u in dag.tasks}
    cache: dict = {}

    def round_(quantile, **kw):
        t0 = time.perf_counter()
        W = cost_view(svc, dag, nodes, quantile)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sched = fused_heft_schedule(dag, nodes, None, W=W, rank_cache=cache,
                                    engine="device", device=dev, **kw)
        t2 = time.perf_counter()
        return sched, W, (t1 - t0, t2 - t1)

    out = {"cache": cache, "avail": avail, "ready": ready}
    out["none"], out["W_none"], cold = round_(None)
    warm = [round_(None)[2] for _ in range(5)]
    out["q"], out["W_q"], _ = round_(PLAN_QUANTILE)
    qwarm = [round_(PLAN_QUANTILE)[2] for _ in range(5)]
    out["constrained"], _, cons = round_(PLAN_QUANTILE, ready_at=ready,
                                         node_available=avail)
    med = lambda xs, k: float(np.median([x[k] for x in xs]))
    out["times"] = {
        "cold_cost_view_s": cold[0], "cold_heft_s": cold[1],
        "warm_cost_view_s": med(warm, 0), "warm_heft_s": med(warm, 1),
        "warm_q_cost_view_s": med(qwarm, 0), "warm_q_heft_s": med(qwarm, 1),
        "constrained_heft_s": cons[1]}
    t = out["times"]
    print(f"[plan] replan {PLAN_TASKS}x{PLAN_NODES} on the card: cold round "
          f"{cold[0] + cold[1]:.4f} s (cost_view {cold[0]:.4f} s, HEFT "
          f"{cold[1]:.4f} s); warm round (median of 5) "
          f"{t['warm_cost_view_s'] + t['warm_heft_s']:.4f} s (cost_view "
          f"{t['warm_cost_view_s']:.4f} s, HEFT {t['warm_heft_s']:.4f} s); "
          f"q={PLAN_QUANTILE} warm HEFT {t['warm_q_heft_s']:.4f} s; "
          f"constrained replan HEFT {cons[1]:.4f} s; predicted makespan "
          f"{out['none'].predicted_makespan:.1f} s")
    return out


def heft_pieces(dev, ctx, dag, nodes, W) -> tuple:
    """One device placement run piece by piece as `fused_heft_schedule`
    runs it, host clock around each: the ranks (one upward_rank launch
    and the read of its finite flag), the rank order (a stable sort on
    the card), the sweep launch with the one copy back of the order,
    placements and counts (and the overflow check on them), and the
    Schedule rebuild.  -> (seconds of the four pieces, schedule, the
    sweep's arguments)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.sched import fused
    t0 = time.perf_counter()
    rank = fused._device_ranks([ctx], [W])
    t1 = time.perf_counter()
    order = fused._rank_order(rank)
    st = ctx.on_device(dev)
    args = (W, order[0], st["dep_rows"], st["gb8"], st["zeros"],
            st["avail0"], st["same"], st["gbps_min"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = ops.eft_sweep(*args, S=ctx.slot_cap)
    o, assign, est, eft, cnt = fused._fetch(order, *(x[None] for x in out))
    check(int(cnt.max()) <= ctx.slot_cap - 1, "warm round overflowed")
    t3 = time.perf_counter()
    sched = fused._build_schedule(ctx, o[0], assign[0], est[0], eft[0])
    t4 = time.perf_counter()
    return (t1 - t0, t2 - t1, t3 - t2, t4 - t3), sched, args


COST_SPLIT = ("order_s", "sync_s", "corr_s", "gather_s", "copy_s",
              "factors_s", "launch_s")


def cost_view_split(svc, dag, nodes, quantile) -> tuple:
    """One `cost_view` run piece by piece as it runs, with a sync after
    each piece: the DAG's topological order and the row and column
    names; the binding's sync, the snapshot, keys and inputs; the node
    corrections; the store's gather into the pinned slab (`fill_slab`,
    as `pack_cost` does); the slab's one copy up; the resident static
    factors (`device_base_factors`); the `fused_cost` launch.  ->
    ({piece: seconds}, W), W checked bitwise against `cost_view`'s."""
    import torch
    from repro_torch.kernels import ops, staging
    from repro_torch.kernels.bayes_fit import fill_slab, predict_slots
    from repro_torch.kernels.decision_plane import CostBatch, cost_slots
    from repro_torch.sched.fused import cost_view
    from repro_torch.sched.plane import quantile_z
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
    corr = binding.node_corrections(names)
    corr = [corr.get(n, 1.0) for n in names]
    t.append(time.perf_counter())
    with staging.staged(svc.device) as st:
        buf = st.host(cost_slots(len(x), len(corr)))
        fill_slab(buf, len(x), x, lambda out: snap.gather(keys, out))
        buf[predict_slots(len(x)):] = corr
        t.append(time.perf_counter())
        slab = st.send()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    base = binding.device_base_factors(tasks, names, svc.device)
    t.append(time.perf_counter())
    z = None if quantile is None else quantile_z(quantile)
    W = ops.fused_cost(CostBatch._packed(slab, len(x), len(corr)), base, z)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    want = cost_view(svc, dag, nodes, quantile)
    check(torch.equal(W.view(torch.int64), want.view(torch.int64)),
          "cost_view's pieces differ from cost_view")
    return dict(zip(COST_SPLIT, [b - a for a, b in zip(t, t[1:])],
                    strict=True)), W


def print_cost_split(label: str, splits) -> None:
    """Medians of `cost_view_split`'s pieces over rounds, and their sum."""
    med = {k: float(np.median([s[k] for s in splits])) for k in COST_SPLIT}
    print(f"[{label}] warm cost_view split (median of {len(splits)}, "
          f"synced pieces, each right after a round on the same state): "
          + ", ".join(f"{k} {v!r}" for k, v in med.items())
          + f"; sum {sum(med.values())!r} s (its host-to-device copies: "
          f"the [copies] line of a warm cost_view)")


def plan_breakdown(dev, fleet_out, plan) -> dict:
    """Host clock of each piece of a warm device round: `cost_view`
    (`cost_view_split`) and the placement (`heft_pieces`), median of 5."""
    from repro_torch.sched import fused
    svc = fleet_out["replan_service"]
    dag, nodes = fleet_out["replan_dag"], fleet_out["replan_nodes"]
    ctx = fused._context(dag, nodes, plan["cache"])
    times, splits = [], []
    for _ in range(5):
        split, W = cost_view_split(svc, dag, nodes, PLAN_QUANTILE)
        splits.append(split)
        pieces, sched, args = heft_pieces(dev, ctx, dag, nodes, W)
        times.append(pieces)
    check(same_schedule(sched, plan["q"]), "breakdown round differs")
    print_cost_split("plan", splits)
    keys = ("rank_s", "pack_s", "sweep_s", "rebuild_s")
    out = {k: float(np.median([x[i] for x in times]))
           for i, k in enumerate(keys)}
    out["args"] = args
    print(f"[plan] warm round pieces (median of 5, q={PLAN_QUANTILE}): "
          + ", ".join(f"{k} {out[k]:.6f}" for k in keys))
    return out


def wide_pack(rng: np.random.Generator, t: int, n: int) -> list:
    """Sweep inputs for t tasks in topo order on n nodes: random costs, up
    to three dependencies on earlier rows, busy prefixes on a third of the
    nodes, and a random symmetric link-rate matrix."""
    dep = np.full((t, 3), -1, np.int32)
    for i in range(1, t):
        k = min(int(rng.integers(0, 4)), i)
        dep[i, :k] = rng.choice(i, size=k, replace=False)
    rate = rng.uniform(1.0, 25.0, (n, n))
    avail = np.where(rng.random(n) < 1 / 3, rng.uniform(0.0, 50.0, n), 0.0)
    return [rng.uniform(1.0, 100.0, (t, n)), np.arange(t, dtype=np.int32),
            dep, rng.uniform(0.0, 16.0, t), np.zeros((t, n)), avail,
            np.eye(n, dtype=bool), np.minimum(rate, rate.T)]


SWEEP_CASE_TASKS, SWEEP_CASE_NODES = 500, 100


def chain_pack(rng: np.random.Generator, t: int, n: int) -> list:
    """Sweep inputs in which every task depends on the task placed just
    before it (rows in rank order, row i depending on i - 1 and i - 2, and
    on one random earlier row half the time), so the sweep hands the task
    it just placed to the next step on every step; random costs and link
    rates spread the chain over the nodes."""
    dep = np.full((t, 3), -1, np.int32)
    for i in range(1, t):
        dep[i, 0] = i - 1
        if i > 1:
            dep[i, 1] = i - 2
        if i > 2 and rng.random() < 0.5:
            dep[i, 2] = rng.integers(0, i - 2)
    rate = rng.uniform(1.0, 25.0, (n, n))
    return [rng.uniform(1.0, 100.0, (t, n)), np.arange(t, dtype=np.int32),
            dep, rng.uniform(0.0, 16.0, t), np.zeros((t, n)), np.zeros(n),
            np.eye(n, dtype=bool), np.minimum(rate, rate.T)]


def tie_pack(rng: np.random.Generator, t: int, n: int) -> list:
    """Sweep inputs full of exact ties: four node classes, node j of class
    j % 4, so identical nodes sit in every warp of nodes; costs are small
    integers times the class's factor, output sizes multiples of 0.5 over
    one link rate of 4, so every sum is exact in float32 and float64 and
    the argmin must keep np.argmin's lowest index across warps."""
    dep = np.full((t, 3), -1, np.int32)
    for i in range(1, t):
        k = min(int(rng.integers(0, 4)), i)
        dep[i, :k] = rng.choice(i, size=k, replace=False)
    factor = np.array([1.0, 2.0, 3.0, 4.0])[np.arange(n) % 4]
    w = rng.integers(1, 9, t).astype(np.float64)[:, None] * factor[None, :]
    return [w, np.arange(t, dtype=np.int32), dep,
            rng.integers(0, 8, t) * 0.5, np.zeros((t, n)), np.zeros(n),
            np.eye(n, dtype=bool), np.full((n, n), 4.0)]


def sweep_cases() -> dict:
    """The chain and the tie-heavy sweep inputs the sweep kernel is held
    to its plain version on (and the plain version, in the CPU tests, to
    the JAX package's float32 sweep)."""
    return {"chain": chain_pack(np.random.default_rng(23), SWEEP_CASE_TASKS,
                                SWEEP_CASE_NODES),
            "ties": tie_pack(np.random.default_rng(29), SWEEP_CASE_TASKS,
                             SWEEP_CASE_NODES)}


def phase_plan_checks(dev, fleet_out, plan, args) -> float:
    """Each plan round against the host HEFT, then the sweep kernel
    against its plain version on the CPU.  Returns the largest |err| of
    the sweep's float outputs against the plain version."""
    import torch
    from repro_torch.kernels import decision_plane as plane
    from repro_torch.kernels import ref
    from repro_torch.sched import fused
    from repro_torch.sched.heft import heft_schedule_matrix
    from repro_torch.sched.plane import PredictionMatrix
    svc = fleet_out["replan_service"]
    dag, nodes = fleet_out["replan_dag"], fleet_out["replan_nodes"]
    entries = [(u, t.task_name, t.input_gb) for u, t in dag.tasks.items()]
    mat = PredictionMatrix.from_service(svc, entries, nodes)
    order, names = dag.topo_order(), [n.name for n in nodes]
    for q, key in ((None, "W_none"), (PLAN_QUANTILE, "W_q")):
        want = mat.costs(order, names, q)
        check(np.array_equal(plan[key].cpu().numpy().view(np.int64),
                             want.view(np.int64)),
              f"cost_view (q={q}) differs from PredictionMatrix.costs")
    host = {"none": heft_schedule_matrix(dag, nodes, mat),
            "q": heft_schedule_matrix(dag, nodes, mat,
                                      quantile=PLAN_QUANTILE),
            "constrained": heft_schedule_matrix(
                dag, nodes, mat, quantile=PLAN_QUANTILE,
                ready_at=plan["ready"], node_available=plan["avail"])}
    for key, want in host.items():
        check(same_schedule(plan[key], want),
              f"device schedule ({key}) differs from heft_schedule_matrix")
    print("[plan] device schedules identical to heft_schedule_matrix: "
          "q=None, q=0.95, constrained replan; cost views bitwise equal "
          "to PredictionMatrix.costs")

    # the slot retry: start the stacks at 4 columns so they overflow
    cache: dict = {}
    ctx = fused._context(dag, nodes, cache)
    ctx.slot_cap = 4
    before = dict(plane.eft_sweep.launches_by_route)
    got = fused.fused_heft_schedule(dag, nodes, None, W=plan["W_none"],
                                    rank_cache=cache, engine="device",
                                    device=dev)
    retry = {k: plane.eft_sweep.launches_by_route[k] - before[k]
             for k in before}
    check(same_schedule(got, host["none"]),
          "schedule after the slot retry differs from heft_schedule_matrix")
    check(ctx.slot_cap >= 8, "the slot retry did not run")
    check(retry["global"] == 0 and retry["shared"] >= 2,
          "the slot retry left the shared route")
    print(f"[plan] slot retry 4 -> {ctx.slot_cap}: schedule identical to "
          f"heft_schedule_matrix; launches by route {retry}")

    # direct launches against the plain sweep on the CPU: S = 48, S = 192,
    # and a pack padded with masked rows to a multiple of 64
    cpu = [a.cpu() for a in args]
    t, n = args[0].shape
    pad = -(-t // 64) * 64 - t
    padded = (torch.cat([args[0], torch.ones(pad, n, dtype=torch.float64,
                                             device=dev)]),
              torch.cat([args[1], torch.full((pad,), -1, dtype=torch.int32,
                                             device=dev)]),
              torch.cat([args[2], torch.full((pad, args[2].shape[1]), -1,
                                             dtype=torch.int32, device=dev)]),
              torch.cat([args[3], torch.zeros(pad, dtype=torch.float64,
                                              device=dev)]),
              torch.cat([args[4], torch.zeros(pad, n, dtype=torch.float64,
                                              device=dev)])) + args[5:]
    wide = [torch.from_numpy(v).to(dev) for v in
            wide_pack(np.random.default_rng(19), 200, WIDE_NODES)]
    cases = {k: [torch.from_numpy(v).to(dev) for v in pack]
             for k, pack in sweep_cases().items()}
    optin = plane.smem_optin(dev.index)
    err = 0.0
    for label, a, s, route in (
            ("S=48", args, 48, "shared"),
            (f"S={S_DIRECT}", args, S_DIRECT, "global"),
            (f"padded T={t + pad} S=48", padded, 48, "shared"),
            ("T=200 S=48, more nodes than threads", wide, 48, "global"),
            (f"chain T={SWEEP_CASE_TASKS} S=48", cases["chain"], 48,
             "shared"),
            (f"ties T={SWEEP_CASE_TASKS} S=48", cases["ties"], 48,
             "shared")):
        shape = (a[0].shape[0], a[0].shape[1], s, a[2].shape[1])
        check(plane.sweep_smem_bytes(*shape)
              == plane._lib().lotaru_eft_sweep_smem_bytes(*shape),
              "the shared route's bytes differ between Python and C")
        before = dict(plane.eft_sweep.launches_by_route)
        got = [g.cpu() for g in plane.eft_sweep(*a, S=s)]
        torch.cuda.synchronize()
        took = [k for k, n in plane.eft_sweep.launches_by_route.items()
                if n > before[k]]
        want = ref.eft_sweep_ref(*(x.cpu() for x in a), S=s)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        e = max(float((got[k] - want[k]).abs().max()) for k in (1, 2))
        err = max(err, e)
        print(f"[plan] eft_sweep {label} N={a[0].shape[1]}: {took} route "
              f"({plane.sweep_smem_bytes(*shape)} B of shared state, "
              f"opt-in {optin} B), identical to the plain sweep (CPU "
              f"float64) {same}, max |err| {e!r}, max count "
              f"{int(got[3].max())}")
        check(took == [route], f"eft_sweep ({label}) took the {took} route, "
              f"want {route}")
        check(same, f"eft_sweep ({label}) differs from its plain version")
        if label.startswith("padded"):
            base = ref.eft_sweep_ref(*cpu, S=48)
            check(all(torch.equal(g[:t], w) for g, w in
                      zip(got[:3], base[:3]))
                  and torch.equal(got[3], base[3]),
                  "masked rows changed the sweep's result")
    return err


def ingest_stream(rng: np.random.Generator, dag, base, benches, nodes
                  ) -> list:
    """The workflow loop's completions, INGEST_BATCHES batches of
    INGEST_BATCH: even batches local only (each task type one fold
    group), odd batches half on the cluster's nodes, running INGEST_DRIFT
    times slower than their static factor says.  Runtimes follow the
    lines the replan problem's traces come from, with 5% noise."""
    from repro_torch.online import TaskCompletion
    tasks = list(dag.tasks.values())
    batches = []
    for b in range(INGEST_BATCHES):
        batch = []
        for _ in range(INGEST_BATCH):
            t = tasks[int(rng.integers(len(tasks)))]
            j = TASK_TYPES.index(t.task_name)
            rt = (2.0 + j + (15.0 + 6 * j) * t.input_gb) \
                * (1.0 + rng.normal(0.0, 0.05))
            node = "local"
            if b % 2 and rng.random() < 0.5:
                node = nodes[int(rng.integers(len(nodes)))].name
                rt *= INGEST_DRIFT * base.factor(t.task_name, benches[node])
            batch.append(TaskCompletion("replan", t.uid, t.task_name, node,
                                        t.input_gb, float(rt)))
        batches.append(batch)
    return batches


def fleet_state(post: dict, rows=None) -> dict:
    """A fitted-predictor state (`repro_torch.convert`) carrying the
    fleet's posteriors `rows` (all N_FLEET by default) as regression
    tasks."""
    from repro_torch.core.microbench import simulate_microbench
    from repro_torch.sched.cluster import LOCAL
    local = simulate_microbench(LOCAL, 1)
    return {"variant": "G", "threshold": 0.75,
            "local_bench": {f: getattr(local, f) for f in
                            ("name", "cpu", "mem", "io_read", "io_write")},
            "app_bench": {},
            "models": {f"task{i:05d}": {
                "correlated": True,
                "posterior": {k: post[k][i] for k in post},
                "median_s": float(post["y_mu"][i]), "spread_s": 1.0,
                "cpu_fraction": 0.5, "fit_x": None, "fit_y": None}
                for i in (range(N_FLEET) if rows is None else rows)}}


def fleet_completions(rng: np.random.Generator, names) -> list:
    """1-FOLD_COLS local completions per fleet task, linear runtimes with
    5% noise, in a shuffled arrival order."""
    from repro_torch.online import TaskCompletion
    t = len(names)
    counts = rng.integers(1, FOLD_COLS + 1, t)
    base = rng.uniform(2.0, 30.0, t)
    slope = rng.uniform(1.0, 60.0, t)
    idx = np.repeat(np.arange(t), counts)
    rng.shuffle(idx)
    x = rng.uniform(0.05, 4.0, idx.size)
    y = (base[idx] + slope[idx] * x) * (1.0 + rng.normal(0.0, 0.05,
                                                          idx.size))
    return [TaskCompletion("fleet", names[i], names[i], "local", a, b)
            for i, a, b in zip(idx.tolist(), x.tolist(), y.tolist())]


def phase_ingest(dev, fleet_out) -> dict:
    """The main path of the online write path on the card: the workflow
    loop (ingest in batches, re-predict, replan) and the fleet fold (one
    observe_many over the 65,536 fleet tasks).  Returns what the checks
    need; they run after the launch counts are read."""
    import torch
    from repro_torch.convert import predictor_from_state
    from repro_torch.online import OnlinePredictor, PredictionService
    from repro_torch.sched.fused import cost_view, fused_heft_schedule
    svc = fleet_out["replan_service"]
    dag, nodes = fleet_out["replan_dag"], fleet_out["replan_nodes"]
    benches = dict(svc.benches)
    batches = ingest_stream(np.random.default_rng(23), dag, svc.predictor,
                            benches, nodes)
    online = OnlinePredictor(svc.predictor, benches, device=dev)
    t0 = time.perf_counter()
    for batch in batches:
        online.observe_many(batch)
    t1 = time.perf_counter()
    isvc = PredictionService(online, benches, device=dev)
    flat = isvc.predict_batch(fleet_out["replan_queries"])
    t2 = time.perf_counter()
    W = cost_view(isvc, dag, nodes, PLAN_QUANTILE)
    sched = fused_heft_schedule(dag, nodes, None, W=W, engine="device",
                                device=dev)
    t3 = time.perf_counter()
    print(f"[ingest] workflow loop: {INGEST_BATCHES} observe_many of "
          f"{INGEST_BATCH} completions {t1 - t0:.4f} s "
          f"({online.ingest.as_dict()}), predict_batch "
          f"(Q={len(flat)}) {t2 - t1:.4f} s, replan (cost_view + "
          f"fused_heft_schedule, q={PLAN_QUANTILE}) {t3 - t2:.4f} s")

    state = fleet_state(fleet_out["fleet_post"])
    fleet = OnlinePredictor(predictor_from_state(state, dev), device=dev)
    names = list(fleet.tasks)
    comps = fleet_completions(np.random.default_rng(29), names)
    nigs0 = [fleet.tasks[n].nig for n in names]
    t4 = time.perf_counter()
    fleet.observe_many(comps)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    print(f"[ingest] fleet fold: one observe_many of {len(comps)} "
          f"completions over {len(names)} tasks {t5 - t4:.4f} s "
          f"({fleet.ingest.as_dict()})")
    return {"batches": batches, "online": online, "benches": benches,
            "flat": flat, "sched": sched, "state": state, "fleet": fleet,
            "comps": comps, "nigs0": nigs0, "names": names,
            "loop_s": t1 - t0, "fleet_observe_s": t5 - t4}


def bounds_fold(counts: np.ndarray) -> tuple:
    """Least time for one fold: per task its count (8 B), x and y for the
    observations it holds (16 B each), and the nine values of its state
    that the fold reads and writes (mu, V and prec at [0,0], [0,1], [1,1],
    b: 72 B) read once and written once; FOLD_STEP_OPS float64 operations
    per observation this run's rows hold."""
    t, n = counts.size, float(counts.sum())
    t_bytes = (n * 16 + t * (8 + 72 + 72)) / H100_BYTES_PER_S * 1e3
    t_ops = n * FOLD_STEP_OPS / H100_FP64_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def median_s(fn, reps: int = 3) -> float:
    """Median host-clock seconds of `reps` calls (each ends on the host)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_ingest_checks(dev, fleet_out, ing) -> dict:
    """The ingest path against the CPU: the workflow loop's state,
    predictions and schedule; the fleet fold's state against the CPU numpy
    fold; `nig_fold` on the fold's operands bitwise against its plain
    version on the CPU.  Then the fold's times.  Returns the report's
    numbers for nig_fold."""
    import torch
    from repro_torch.convert import predictor_from_state, predictor_state
    from repro_torch.core import bayes
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import ref
    from repro_torch.online import OnlinePredictor, PredictionService
    from repro_torch.sched.heft import heft_schedule_matrix
    from repro_torch.sched.plane import PredictionMatrix
    from repro_torch.store import compute
    online, benches = ing["online"], ing["benches"]
    dag, nodes = fleet_out["replan_dag"], fleet_out["replan_nodes"]
    cpu = OnlinePredictor(predictor_from_state(predictor_state(online.base),
                                               "cpu"), benches, device="cpu")
    for batch in ing["batches"]:
        for c in batch:
            cpu.observe(c)
    check(online.export_state() == cpu.export_state(),
          "workflow loop: export_state on the card differs from the CPU "
          "port predictor driven by the scalar observe")
    moved = sum(online.node_correction(n.name) != 1.0 for n in nodes)
    check(online.ingest.fold_dispatches > 0 and moved > 0,
          "workflow loop: no fold group, or no node correction moved")
    cpu_svc = PredictionService(cpu, benches, device="cpu")
    check(np.array_equal(cpu_svc.predict_batch(fleet_out["replan_queries"]),
                         ing["flat"]),
          "post-ingest predict_batch on the card differs from the CPU run")
    entries = [(u, t.task_name, t.input_gb) for u, t in dag.tasks.items()]
    mat = PredictionMatrix.from_service(cpu_svc, entries, nodes)
    check(same_schedule(heft_schedule_matrix(dag, nodes, mat,
                                             quantile=PLAN_QUANTILE),
                        ing["sched"]),
          "post-ingest replan on the card differs from the CPU run")
    print(f"[ingest] workflow loop: export_state equal to the CPU scalar "
          f"observe chain; {moved} node corrections moved; predict_batch "
          f"bitwise and the replan schedule identical to the CPU run")

    cpu_fleet = OnlinePredictor(predictor_from_state(ing["state"], "cpu"),
                                device="cpu")
    t0 = time.perf_counter()
    cpu_fleet.observe_many(ing["comps"])
    cpu_observe_s = time.perf_counter() - t0
    check(ing["fleet"].export_state() == cpu_fleet.export_state(),
          "fleet fold: export_state on the card differs from the CPU "
          "numpy fold")
    rows = {n: ([], []) for n in ing["names"]}
    for c in ing["comps"]:
        rows[c.task][0].append(c.input_gb)
        rows[c.task][1].append(c.runtime_s)
    xs = [rows[n][0] for n in ing["names"]]
    ys = [rows[n][1] for n in ing["names"]]
    nigs0 = ing["nigs0"]
    slab, counts, _, _ = bayes.fold_pack(nigs0, xs, ys)
    t = len(nigs0)
    err = fold_check(dev, "fleet", slab, t)
    for label, (nigs, cx, cy) in fold_edge_cases(
            np.random.default_rng(37), nigs0).items():
        err = max(err, fold_check(dev, label,
                                  bayes.fold_pack(nigs, cx, cy)[0],
                                  len(nigs)))
    print(f"[ingest] fleet export_state equal to the CPU numpy fold")

    cpu_slab = torch.from_numpy(slab)
    dev_slab = cpu_slab.to(dev)
    state = torch.empty((t, bayes.FOLD_STATE), dtype=torch.float64,
                        device=dev)
    launch = raw_launch("nig_fold", [dev_slab, t, state])
    out = {"ms": time_ms(launch), "warm_ms": warm_ms(launch),
           "wrapper_ms": time_ms(lambda: kernels.nig_fold(dev_slab, t),
                                 host=True),
           "plain_ms": time_ms(lambda: ref.nig_fold_ref(dev_slab, t), reps=5,
                               host=True),
           "err": err, "shape": f"T={t} K={int(counts.max())}"}
    out["bound_ms"], out["bound_by"] = bounds_fold(counts)
    # the fold's copies as the card sees them: the slab up from pinned
    # memory, the state slab back
    pinned = cpu_slab.pin_memory()
    h2d_ms = time_ms(lambda: pinned.to(dev, non_blocking=True), reps=5,
                     host=True)
    d2h_ms = time_ms(lambda: state.cpu(), reps=5, host=True)
    pack_s = median_s(lambda: bayes.fold_pack(nigs0, xs, ys))
    kernel_fold_s = median_s(lambda: compute.fold_kernel(nigs0, xs, ys,
                                                         dev))
    numpy_fold_s = median_s(lambda: bayes.nig_update_batch(nigs0, xs, ys))
    obs_s = ing["fleet_observe_s"]
    device_s = (out["ms"] + h2d_ms + d2h_ms) / 1e3
    print(f"[ingest] nig_fold kernel {out['ms']!r} ms (L2 flushed) beside "
          f"its bound {out['bound_ms']!r} ms ({out['bound_by']}); "
          f"back to back on the same operands {out['warm_ms']!r} ms")
    print(f"[ingest] nig_fold through the wrapper {out['wrapper_ms']!r} ms; "
          f"plain version on the card {out['plain_ms']!r} ms")
    print(f"[ingest] fleet observe_many {obs_s!r} s on the card: the fold "
          f"call {kernel_fold_s!r} s (packing {pack_s!r} s, the slab to "
          f"the card {h2d_ms / 1e3!r} s and the states back "
          f"{d2h_ms / 1e3!r} s, the kernel {out['ms'] / 1e3!r} s, unpacking "
          f"the rest), the grouping, ring appends and change feed "
          f"{obs_s - kernel_fold_s!r} s; share outside the kernel "
          f"{1.0 - out['ms'] / 1e3 / obs_s!r}, host share (outside the "
          f"kernel and the copies) {1.0 - device_s / obs_s!r}")
    print(f"[ingest] host numpy fold (nig_update_batch) at the same size "
          f"{numpy_fold_s!r} s; the CPU predictor's observe_many "
          f"{cpu_observe_s!r} s")
    return out


def fold_edge_cases(rng: np.random.Generator, nigs0) -> dict:
    """Fold cases beside the fleet fold, on the fleet's first states:
    {label: (states, x rows, y rows)}.  An ingest group (6 tasks of 42
    completions, the workflow loop's batch of 250), one row, a tile whose
    last rows hold nothing, a ragged last tile (T = 1037, 13 rows past
    eight tiles), and a tile with two rows of 6,000 and 5,000 completions,
    longer than a block's shared budget (walked from global memory)."""
    def case(lengths):
        lengths = list(lengths)
        xs = [rng.uniform(0.05, 4.0, k) for k in lengths]
        ys = [rng.uniform(4.0, 120.0, k) for k in lengths]
        return nigs0[:len(lengths)], xs, ys

    empty = rng.integers(1, 9, 300)
    empty[::3] = 0
    empty[200:] = 0
    long_rows = rng.integers(0, 9, 300)
    long_rows[5], long_rows[100] = 6000, 5000
    return {"ingest group": case([42] * 6), "T=1": case([8]),
            "empty rows": case(empty), "T=1037": case(rng.integers(
                1, 9, 1037)), "long rows": case(long_rows)}


def fold_check(dev, label: str, slab: np.ndarray, t: int) -> float:
    """`nig_fold` on a T-row fold slab against its plain version on the
    CPU, bitwise; prints how many rows the kernel walks from global memory
    (past its tile's shared budget).  Returns the max |err|."""
    import torch
    from repro_torch.core.bayes import FOLD_HEAD
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import ref
    cpu = torch.from_numpy(slab)
    got = kernels.nig_fold(cpu.to(dev), t).cpu()
    want = ref.nig_fold_ref(cpu, t)
    same = bits_equal(got, want)
    err = float((got - want).abs().max()) if t else 0.0
    shape = kernels.fold_config()
    size = np.diff(slab[:t + 1].view(np.int64))
    n_obs = int((size - FOLD_HEAD).sum() // 2)
    wide = kernels.fold_global_rows(slab, t, **shape)
    print(f"[ingest] nig_fold {label} (T={t}, {n_obs} observations, "
          f"{int((size == FOLD_HEAD).sum())} rows with none; "
          f"{wide} rows walked from global memory past the {shape} "
          f"budget): bitwise vs plain (CPU float64) {same}, max |err| "
          f"{err!r}")
    check(same, f"nig_fold {label} differs from its plain version")
    return err


PLANE_SPLIT = ("sync_gather_s", "predict_s", "scale_cost_s", "rank_s",
               "pack_s", "sweep_s", "rebuild_s")


def plane_rounds(dag, batches) -> list:
    """The plane phase's rounds: (label, completions to observe first)."""
    return ([("cold", None), ("warm", None)]
            + [(f"batch{b}", batch) for b, batch in enumerate(batches)])


def phase_plane(dev, fleet_out) -> dict:
    """The main path of the resident decision plane on the card: the
    fleet's replan problem wrapped in `OnlinePredictor(device="cuda")`, a
    `FusedPlane` over it, and rounds of `plane.schedule(engine="device")`
    at q = PLAN_QUANTILE: cold, warm with nothing moved, then one after
    each of phase 6's ingest batches (the same seeded stream).  Each
    round's launches and `PlaneStats` are read around it; the checks run
    after the launch counts are read."""
    import dataclasses
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import decision_plane as plane_k
    from repro_torch.online import OnlinePredictor, PredictionService
    from repro_torch.sched.fused import FusedPlane
    svc = fleet_out["replan_service"]
    dag, nodes = fleet_out["replan_dag"], fleet_out["replan_nodes"]
    benches = dict(svc.benches)
    batches = ingest_stream(np.random.default_rng(23), dag, svc.predictor,
                            benches, nodes)
    online = OnlinePredictor(svc.predictor, benches, device=dev)
    plane = FusedPlane(PredictionService(online, benches, device=dev), nodes,
                       dag=dag)
    binding = plane.binding
    factor_builds = []
    base_factor_matrix = binding.base_factor_matrix

    def counted_factors(*a):
        factor_builds.append(1)
        return base_factor_matrix(*a)
    binding.base_factor_matrix = counted_factors
    rounds = []
    for label, batch in plane_rounds(dag, batches):
        before = (dataclasses.asdict(plane.stats),
                  kernels.bayes_predict.launches, plane_k.eft_sweep.launches,
                  len(factor_builds), plane.w_host_copies)
        t0 = time.perf_counter()
        if batch is not None:
            online.observe_many(batch)
        t1 = time.perf_counter()
        sched = plane.schedule(dag, quantile=PLAN_QUANTILE, engine="device")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        stats = {k: v - before[0][k]
                 for k, v in dataclasses.asdict(plane.stats).items()}
        r = {"label": label, "observe_s": t1 - t0, "round_s": t2 - t1,
             "sched": sched, "matrix": plane._matrix,
             "stats": stats,
             "predict_launches": kernels.bayes_predict.launches - before[1],
             "sweep_launches": plane_k.eft_sweep.launches - before[2],
             "factor_builds": len(factor_builds) - before[3],
             "w_host_copies": plane.w_host_copies - before[4]}
        rounds.append(r)
        print(f"[plane] round {label}: {r['round_s']!r} s (observe_many "
              f"{r['observe_s']!r} s before it); rows refreshed "
              f"{stats['rows_refreshed']} of {len(plane.uids)}; launches "
              f"bayes_predict {r['predict_launches']}, eft_sweep "
              f"{r['sweep_launches']}; factor-matrix builds "
              f"{r['factor_builds']}; host copies of W "
              f"{r['w_host_copies']}; PlaneStats delta {stats}")
        check(r["w_host_copies"] == 0,
              f"plane round {label} copied W to the host")
    print(f"[plane] PlaneStats after {len(rounds)} rounds: {plane.stats}")
    return {"rounds": rounds, "batches": batches, "benches": benches,
            "online": online, "stats": plane.stats}


def plane_split(dev, plane, dag) -> tuple:
    """One plane round run piece by piece as `FusedPlane.schedule` runs
    it, with a sync after each piece: the binding sync, snapshot, dirty
    detection, host gather into the packed slab and its copy to the card;
    the bayes_predict launch, which writes the rows in place; scaling,
    the host matrix and the cost view (W stays on the card); then
    `heft_pieces` (ranks, rank order, sweep and its copy back, rebuild).
    -> ({piece: seconds}, schedule)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.sched import fused
    t = [time.perf_counter()]
    plane.stats.rounds += 1
    snap, idx = plane.collect_dirty()
    rows = plane.gather_rows(snap, idx) if len(idx) else None
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    if rows is not None:
        ops.bayes_predict(rows)
        plane.stats.predict_dispatches += 1
    plane.apply_rows(snap, idx)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    plane._scale()
    W = plane._costs(dag, PLAN_QUANTILE)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    ctx = fused._context(dag, plane.nodes, plane.rank_cache)
    pieces, sched, _ = heft_pieces(dev, ctx, dag, plane.nodes, W)
    split = dict(zip(PLANE_SPLIT, [b - a for a, b in zip(t, t[1:])]
                     + list(pieces), strict=True))
    return split, sched


def phase_plane_checks(dev, fleet_out, pl) -> None:
    """The plane's rounds against the reference, and their split.  The
    rounds are replayed on a second plane over a second predictor fed the
    same batches (launches outside the main path's counts): each round's
    matrix, on both planes, bitwise `PredictionMatrix.from_service` on a
    fresh service over the replayed predictor, and each schedule identical
    to `heft_schedule_matrix` on it.  The replay runs each round piece by
    piece (`plane_split`) and, in turns with it, the old round
    (`cost_view` + `fused_heft_schedule(engine="device")`) on the same
    state."""
    import dataclasses
    import torch
    from repro_torch.online import OnlinePredictor, PredictionService
    from repro_torch.sched.fused import (FusedPlane, cost_view,
                                         fused_heft_schedule)
    from repro_torch.sched.heft import heft_schedule_matrix
    from repro_torch.sched.plane import PredictionMatrix
    svc = fleet_out["replan_service"]
    dag, nodes = fleet_out["replan_dag"], fleet_out["replan_nodes"]
    benches = pl["benches"]
    entries = [(u, t.task_name, t.input_gb) for u, t in dag.tasks.items()]
    online = OnlinePredictor(svc.predictor, benches, device=dev)
    plane = FusedPlane(PredictionService(online, benches, device=dev), nodes,
                       dag=dag)
    old_svc = PredictionService(online, benches, device=dev)
    old_cache: dict = {}

    old_splits = []

    def old_round():
        t0 = time.perf_counter()
        W = cost_view(old_svc, dag, nodes, PLAN_QUANTILE)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sched = fused_heft_schedule(dag, nodes, None, W=W,
                                    rank_cache=old_cache, engine="device",
                                    device=dev)
        t2 = time.perf_counter()
        old_splits.append(cost_view_split(old_svc, dag, nodes,
                                          PLAN_QUANTILE)[0])
        return {"cost_view_s": t1 - t0, "heft_s": t2 - t1}, sched

    for i, (r, (label, batch)) in enumerate(zip(
            pl["rounds"], plane_rounds(dag, pl["batches"]))):
        if batch is not None:
            online.observe_many(batch)
        if i % 2:                          # in turns: old first, then new
            old, old_sched = old_round()
            split, sched = plane_split(dev, plane, dag)
        else:
            split, sched = plane_split(dev, plane, dag)
            old, old_sched = old_round()
        fresh = PredictionMatrix.from_service(
            PredictionService(online, benches, device=dev), entries, nodes)
        want = heft_schedule_matrix(dag, nodes, fresh, quantile=PLAN_QUANTILE)
        for name, mat in (("main-path plane", r["matrix"]),
                          ("replayed plane", plane._matrix)):
            check(np.array_equal(mat.means, fresh.means)
                  and np.array_equal(mat.stds, fresh.stds),
                  f"plane round {label}: the {name}'s matrix is not bitwise "
                  f"PredictionMatrix.from_service")
        for name, got in (("main-path plane", r["sched"]),
                          ("replayed plane", sched), ("old round", old_sched)):
            check(same_schedule(got, want),
                  f"plane round {label}: the {name}'s schedule differs from "
                  f"heft_schedule_matrix")
        st = r["stats"]
        check(r["predict_launches"] == st["predict_dispatches"]
              == (1 if st["rows_refreshed"] else 0),
              f"plane round {label}: not one bayes_predict launch per round "
              f"with dirty rows")
        check(r["sweep_launches"] == st["sweep_dispatches"] >= 1,
              f"plane round {label}: sweep launches and PlaneStats disagree")
        if label == "warm":
            check(r["predict_launches"] == 0 and r["factor_builds"] == 0
                  and st["matrix_rebuilds"] == 0 and st["cost_rebuilds"] == 0,
                  "the warm plane round with nothing moved predicted, built "
                  "factors or rebuilt a view")
        split_s = sum(split.values())
        print(f"[plane] round {label} split (synced pieces, replayed): "
              + ", ".join(f"{k} {v:.6f}" for k, v in split.items())
              + f"; sum {split_s:.6f} s; main-path round "
              f"{r['round_s']:.6f} s; old round on the same state "
              f"{old['cost_view_s'] + old['heft_s']:.6f} s (cost_view "
              f"{old['cost_view_s']:.6f} s, HEFT {old['heft_s']:.6f} s)")
    print_cost_split("plane", old_splits)
    check(online.export_state() == pl["online"].export_state(),
          "the replayed predictor's state differs from the main path's")
    main = dict(dataclasses.asdict(pl["stats"]), sweep_dispatches=0)
    check(dataclasses.asdict(plane.stats) == main,
          "the replayed plane did other work than the main path's")
    print(f"[plane] every round: both planes' matrices bitwise "
          f"PredictionMatrix.from_service, schedules identical to "
          f"heft_schedule_matrix (old round too); replayed PlaneStats "
          f"{plane.stats}")


# ---------------------------------------------------------------------------
# replan: many workflows a round
# ---------------------------------------------------------------------------
REPLAN_A = 32                    # workflows of PLAN_TASKS tasks on the
                                 # fleet's PLAN_NODES-node cluster
REPLAN_B = (6, 300, 30)          # benchmarks/fused_plane.py:50: batch,
                                 # batch_tasks, batch_nodes
REPLAN_SEED = 31
REPLAN_BATCHES = 2               # rounds after phase 6's first two batches
REPLAN_SPLIT = ("sync_gather_s", "predict_s", "scale_cost_s", "rank_s",
                "sweep_rebuild_s")


def replan_problem_many(fleet_out) -> dict:
    """The replan cell: group A, REPLAN_A DAGs of the replan problem's
    generator (`replan_dag`, seeds REPLAN_SEED + 1 on) on the fleet's
    cluster; group B, the reference benchmark's megabatch shape on a
    second cluster drawn from seed REPLAN_SEED; and both clusters'
    microbenchmarks (a node name names one machine in both)."""
    from repro_torch.core.microbench import simulate_microbench
    from repro_torch.sched.cluster import TARGET_MACHINES
    from repro_torch.workflow.simulator import random_cluster
    svc = fleet_out["replan_service"]
    nodes_a = fleet_out["replan_nodes"]
    n_b, t_b, m_b = REPLAN_B
    nodes_b = random_cluster(np.random.default_rng(REPLAN_SEED),
                             list(TARGET_MACHINES), n_nodes=m_b)
    by_name = {n.name: n for n in nodes_a}
    check(all(by_name.get(n.name, n) == n for n in nodes_b),
          "a node name names two machines in the replan cell")
    benches = dict(svc.benches)
    benches.update({n.name: simulate_microbench(n, 1) for n in nodes_b})
    seeds = iter(range(REPLAN_SEED + 1, REPLAN_SEED + 1 + REPLAN_A + n_b))
    work = ([(replan_dag(np.random.default_rng(next(seeds)), PLAN_TASKS),
              nodes_a) for _ in range(REPLAN_A)]
            + [(replan_dag(np.random.default_rng(next(seeds)), t_b),
                nodes_b) for _ in range(n_b)])
    return {"work": work, "benches": benches, "groups": 2}


def replan_planes(dev, problem, online) -> tuple:
    """A `FusedPlane` per workflow of the cell over one service of
    `online`, and their requests at q = PLAN_QUANTILE."""
    from repro_torch.online import PredictionService
    from repro_torch.sched.fused import FusedPlane, ReplanRequest
    service = PredictionService(online, problem["benches"], device=dev)
    planes = [FusedPlane(service, nodes, dag=dag)
              for dag, nodes in problem["work"]]
    reqs = [ReplanRequest(p, dag, quantile=PLAN_QUANTILE)
            for p, (dag, _) in zip(planes, problem["work"])]
    return planes, reqs


def replan_caps(reqs) -> list:
    """The interval columns each group's sweep starts at (its members'
    largest slot_cap), in the order of the groups' first members."""
    from repro_torch.sched import fused
    caps = {}
    for req in reqs:
        ctx = fused._context(req.dag, req.plane.nodes, req.plane.rank_cache)
        caps[ctx.cluster] = max(caps.get(ctx.cluster, 0), ctx.slot_cap)
    return list(caps.values())


def phase_replan(dev, fleet_out) -> dict:
    """The main path of replanning many workflows on the card: the replan
    cell's 38 workflows (`replan_problem_many`), each a `FusedPlane` over
    one `OnlinePredictor(device="cuda")` wrapping the fleet's predictor,
    and one `replan_many` of all of them a round at q = PLAN_QUANTILE:
    cold, warm with nothing moved, then one after each of the first
    REPLAN_BATCHES of phase 6's ingest batches (the same seeded stream).
    A round makes one bayes_predict launch when rows moved and none when
    none did, one upward_rank and one eft_sweep_many launch a cluster
    (more sweeps only on a slot retry), no single-workflow sweep and no
    host copy of W.  The schedules are checked after the launch counts
    are read."""
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import decision_plane as plane_k
    from repro_torch.online import OnlinePredictor
    from repro_torch.sched.fused import replan_many
    svc = fleet_out["replan_service"]
    problem = replan_problem_many(fleet_out)
    batches = ingest_stream(np.random.default_rng(23), fleet_out["replan_dag"],
                            svc.predictor, dict(svc.benches),
                            fleet_out["replan_nodes"])[:REPLAN_BATCHES]
    online = OnlinePredictor(svc.predictor, problem["benches"], device=dev)
    planes, reqs = replan_planes(dev, problem, online)
    fns = {"bayes_predict": kernels.bayes_predict,
           "upward_rank": plane_k.upward_rank,
           "eft_sweep_many": plane_k.eft_sweep_many,
           "eft_sweep": plane_k.eft_sweep}
    rounds = []
    for label, batch in plane_rounds(None, batches):
        before = ({k: f.launches for k, f in fns.items()},
                  sum(p.w_host_copies for p in planes),
                  sum(p.stats.rows_refreshed for p in planes),
                  dict(plane_k.eft_sweep_many.launches_by_route),
                  replan_caps(reqs))
        t0 = time.perf_counter()
        if batch is not None:
            online.observe_many(batch)
        t1 = time.perf_counter()
        scheds = replan_many(reqs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {k: f.launches - before[0][k] for k, f in fns.items()}
        routes = {k: v - before[3][k]
                  for k, v in plane_k.eft_sweep_many.launches_by_route.items()}
        retries = sum(int(np.log2(b / a))
                      for a, b in zip(before[4], replan_caps(reqs)))
        r = {"label": label, "observe_s": t1 - t0, "round_s": t2 - t1,
             "scheds": scheds, "launches": launches, "retries": retries,
             "rows": sum(p.stats.rows_refreshed for p in planes) - before[2],
             "w_host_copies": sum(p.w_host_copies for p in planes)
             - before[1]}
        rounds.append(r)
        print(f"[replan] round {label}: {len(reqs)} workflows in one "
              f"replan_many, {r['round_s']!r} s (observe_many "
              f"{r['observe_s']!r} s before it); rows refreshed "
              f"{r['rows']}; launches {launches} (eft_sweep_many by route "
              f"{routes}; slot retries {retries}); host copies of W "
              f"{r['w_host_copies']}")
        check(launches["bayes_predict"] == (1 if r["rows"] else 0),
              f"replan round {label}: not one bayes_predict launch when rows "
              f"moved and none when none did")
        check(launches["upward_rank"] == problem["groups"]
              and launches["eft_sweep_many"] == problem["groups"] + retries
              and launches["eft_sweep"] == 0,
              f"replan round {label}: not one upward_rank and one "
              f"eft_sweep_many launch a cluster")
        check(routes["global"] == 0, f"replan round {label}: a many-lane "
              f"sweep left the shared route")
        check(r["w_host_copies"] == 0,
              f"replan round {label} copied W to the host")
    check(rounds[1]["rows"] == 0, "the warm replan round refreshed rows")
    return {"problem": problem, "batches": batches, "rounds": rounds,
            "online": online, "planes": planes}


def replan_split(dev, reqs) -> tuple:
    """One `replan_many` round run piece by piece as it runs, a sync
    after each piece: the bindings' sync, the dirty rows' collection,
    host gather into one packed slab and its copy; the one bayes_predict
    launch, which writes every plane's rows in place; each plane's
    scaling and cost view; each cluster's ranks (one upward_rank launch
    and the read of its flags); each cluster's rank order, sweep, copy
    back and Schedule rebuild.
    -> ({piece: seconds}, schedules)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.sched import fused
    t = [time.perf_counter()]
    for req in reqs:
        req.plane.binding.sync()
    collected = [(req.plane,) + req.plane.collect_dirty() for req in reqs]
    dirty = [c for c in collected if len(c[2])]
    rows = fused._gather_many(dirty, dev) if dirty else None
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    if dirty:
        ops.bayes_predict(rows)
        for plane, _, _ in dirty:
            plane.stats.predict_dispatches += 1
    for plane, snap, idx in collected:
        plane.apply_rows(snap, idx)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    groups = {}
    for pos, req in enumerate(reqs):
        _, W = req.plane.cost_view(req.dag, req.quantile)
        ctx = fused._context(req.dag, req.plane.nodes, req.plane.rank_cache)
        groups.setdefault(ctx.cluster, []).append((pos, req, ctx, W))
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    ranks = [fused._device_ranks([m[2] for m in g], [m[3] for m in g])
             for g in groups.values()]
    t.append(time.perf_counter())
    out = [None] * len(reqs)
    for g, rank in zip(groups.values(), ranks):
        inputs = [fused._sweep_inputs(ctx, req.dag, req.plane.nodes,
                                      req.ready_at, req.node_available)
                  for _, req, ctx, _ in g]
        scheds, _ = fused._sweep_lanes([m[2] for m in g], [m[3] for m in g],
                                       rank, inputs)
        for (pos, req, _, _), sched in zip(g, scheds):
            req.plane.stats.sweep_dispatches += 1
            out[pos] = sched
    t.append(time.perf_counter())
    return dict(zip(REPLAN_SPLIT, [b - a for a, b in zip(t, t[1:])],
                    strict=True)), out


def phase_replan_checks(dev, fleet_out, rp) -> dict:
    """The replan rounds against the reference, their split, and the two
    kernels of the path against their plain versions.  The rounds are
    replayed on two replicas, each a second predictor fed the same
    batches with its own planes: one runs `replan_many` piece by piece
    (`replan_split`), the other the 38 per-request rounds
    (`plane.schedule(engine="device")`), in turns.  Every schedule of the
    main path equals both replicas'; in the cold round each equals
    `heft_schedule_matrix` on a fresh service.  -> the kernel checks'
    errors and the arguments the report times."""
    import dataclasses
    import torch
    from repro_torch.online import OnlinePredictor, PredictionService
    from repro_torch.sched.heft import heft_schedule_matrix
    from repro_torch.sched.plane import PredictionMatrix
    problem, benches = rp["problem"], rp["problem"]["benches"]
    svc = fleet_out["replan_service"]
    split_on = OnlinePredictor(svc.predictor, benches, device=dev)
    twin_on = OnlinePredictor(svc.predictor, benches, device=dev)
    split_planes, split_reqs = replan_planes(dev, problem, split_on)
    twin_planes, twin_reqs = replan_planes(dev, problem, twin_on)

    def per_request():
        t0 = time.perf_counter()
        out = [req.plane.schedule(req.dag, quantile=req.quantile,
                                  engine="device") for req in twin_reqs]
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    for i, (r, (label, batch)) in enumerate(zip(
            rp["rounds"], plane_rounds(None, rp["batches"]))):
        if batch is not None:
            split_on.observe_many(batch)
            twin_on.observe_many(batch)
        if i % 2:                          # in turns: per-request first
            one_s, twin = per_request()
            split, got = replan_split(dev, split_reqs)
        else:
            split, got = replan_split(dev, split_reqs)
            one_s, twin = per_request()
        for k, (a, b, c) in enumerate(zip(r["scheds"], got, twin)):
            check(same_schedule(a, b) and same_schedule(a, c),
                  f"replan round {label}: workflow {k}'s schedule differs "
                  f"from the replayed replan_many or from plane.schedule")
        if label == "cold":
            fresh = PredictionService(twin_on, benches, device=dev)
            for k, (dag, nodes) in enumerate(problem["work"]):
                entries = [(u, t.task_name, t.input_gb)
                           for u, t in dag.tasks.items()]
                want = heft_schedule_matrix(
                    dag, nodes, PredictionMatrix.from_service(
                        fresh, entries, nodes), quantile=PLAN_QUANTILE)
                check(same_schedule(r["scheds"][k], want),
                      f"replan cold round: workflow {k}'s schedule differs "
                      f"from heft_schedule_matrix")
        r["split"], r["per_request_s"] = split, one_s
        print(f"[replan] round {label} split (synced pieces, replayed): "
              + ", ".join(f"{k} {v:.6f}" for k, v in split.items())
              + f"; sum {sum(split.values()):.6f} s; main-path round "
              f"{r['round_s']:.6f} s; the {len(twin_reqs)} per-request "
              f"rounds on the same state {one_s:.6f} s")
    check(split_on.export_state() == rp["online"].export_state(),
          "the replayed predictor's state differs from the main path's")
    for p, q in zip(split_planes, rp["planes"]):
        check(dataclasses.asdict(p.stats) == dataclasses.asdict(q.stats),
              "the replayed planes did other work than the main path's")
    print(f"[replan] every round: each of the {len(twin_reqs)} schedules "
          f"identical to the replayed replan_many's and to plane.schedule"
          f"(engine='device') on twin planes; the cold round's identical to "
          f"heft_schedule_matrix")
    errors = replan_kernel_checks(dev, fleet_out, twin_planes, twin_reqs)
    return dict(errors, planes=twin_planes, reqs=twin_reqs)


def profiled_regions(steps) -> dict:
    """Run `steps`, [(label or None, fn)], in order under ONE
    torch.profiler session (CPU and CUDA; in a trial run a third session
    in one process recorded no device event), the card's work
    synchronised after each step -> per labelled step what crossed and
    ran in it: host-to-device and device-to-host copies, bayes_predict,
    nig_fold and fused_cost kernels, index_copy ops or kernels, and all
    device events.  An event belongs to the step whose span holds its
    start.  One unlabelled device op ends the session, so that no
    labelled step does (a run lost the copy up of the session's last
    step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, fn in steps:
            if label is None:
                fn()
                torch.cuda.synchronize()
                continue
            with record_function(f"copies/{label}"):
                fn()
                torch.cuda.synchronize()
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
    events = prof.events()
    spans = {e.name[len("copies/"):]: (e.time_range.start, e.time_range.end)
             for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith("copies/")}
    out = {label: dict.fromkeys(("h2d", "d2h", "bayes_predict", "nig_fold",
                                 "fused_cost", "index_copy",
                                 "device_events"), 0)
           for label in spans}
    for e in events:
        if e.name.startswith("copies/"):
            continue
        label = next((k for k, (a, b) in spans.items()
                      if a <= e.time_range.start <= b), None)
        if label is None:
            continue
        c = out[label]
        on_card = e.device_type == DeviceType.CUDA
        c["device_events"] += on_card
        c["h2d"] += on_card and e.name.startswith("Memcpy HtoD")
        c["d2h"] += on_card and e.name.startswith("Memcpy DtoH")
        c["bayes_predict"] += on_card and "bayes_predict_kernel" in e.name
        c["nig_fold"] += on_card and "nig_fold_kernel" in e.name
        c["fused_cost"] += on_card and "fused_cost_kernel" in e.name
        c["index_copy"] += "index_copy" in e.name
    return out


def phase_copy_checks(dev, fleet_out) -> None:
    """What a dirty round and a fold send across, under one torch.profiler
    session, on fresh planes after a cold round.  A plane's row sync after
    an ingest batch (`FusedPlane.sync`) and the 38 workflows'
    (`sync_planes`, the replan round's first piece): one copy up, one
    bayes_predict kernel, no index_copy; the whole dirty round after the
    next batch: one bayes_predict kernel and no index_copy (its other
    copies up, of the node corrections, view indices and sweep operands,
    are printed).  A fold (`store.compute.fold_kernel`, the workflow
    loop's group shape): one copy each way, one nig_fold kernel.  A warm
    `cost_view`: one copy up (the cost slab) and one fused_cost kernel."""
    from repro_torch.core.bayes import nig_from_blr
    from repro_torch.online import OnlinePredictor, PredictionService
    from repro_torch.sched.fused import (FusedPlane, cost_view, replan_many,
                                         sync_planes)
    from repro_torch.store import compute
    svc = fleet_out["replan_service"]
    dag, nodes = fleet_out["replan_dag"], fleet_out["replan_nodes"]
    benches = dict(svc.benches)
    batches = ingest_stream(np.random.default_rng(23), dag, svc.predictor,
                            benches, nodes)
    online = OnlinePredictor(svc.predictor, benches, device=dev)
    plane = FusedPlane(PredictionService(online, benches, device=dev), nodes,
                       dag=dag)
    round_ = lambda: plane.schedule(dag, quantile=PLAN_QUANTILE,
                                    engine="device")
    round_()                                        # cold
    problem = replan_problem_many(fleet_out)
    many = OnlinePredictor(svc.predictor, problem["benches"], device=dev)
    planes, reqs = replan_planes(dev, problem, many)
    replan_many(reqs)                               # cold
    post = fleet_out["fleet_post"]
    nigs = [nig_from_blr({k: v[i] for k, v in post.items()})
            for i in range(6)]
    rng = np.random.default_rng(41)
    xs = [rng.uniform(0.05, 4.0, 42) for _ in nigs]
    ys = [rng.uniform(4.0, 120.0, 42) for _ in nigs]
    cost_svc = PredictionService(online, benches, device=dev)
    cost_view(cost_svc, dag, nodes, PLAN_QUANTILE)   # cold: the factors
    rows = []
    got = profiled_regions([
        ("a warm cost_view",
         lambda: cost_view(cost_svc, dag, nodes, PLAN_QUANTILE)),
        (None, lambda: online.observe_many(batches[0])),
        ("plane row sync after an ingest batch",
         lambda: rows.append(plane.sync())),
        (None, lambda: online.observe_many(batches[1])),
        ("plane whole round after the next batch", round_),
        (None, lambda: many.observe_many(batches[0])),
        (f"replan ({len(planes)} workflows) row sync after an ingest batch",
         lambda: rows.append(sync_planes(planes))),
        (None, lambda: many.observe_many(batches[1])),
        (f"replan ({len(planes)} workflows) whole round after the next "
         f"batch", lambda: replan_many(reqs)),
        ("a fold of 6 tasks x 42 completions",
         lambda: compute.fold_kernel(nigs, xs, ys, dev))])
    for label, c in got.items():
        print(f"[copies] {label}: {c}")
        check(c["device_events"] > 0, f"{label}: the profiler recorded no "
                                      f"device event")
        check(c["index_copy"] == 0, f"{label}: an index_copy ran")
    print(f"[copies] rows refreshed by the two syncs: {rows}")
    check(all(rows), "a row sync found no dirty rows")
    for label, c in got.items():
        if label == "a warm cost_view":
            check(c["h2d"] == 1 and c["fused_cost"] == 1,
                  f"{label}: not one copy up and one fused_cost kernel")
        elif "row sync" in label:
            check(c["h2d"] == 1 and c["bayes_predict"] == 1,
                  f"{label}: not one copy up and one bayes_predict kernel")
        elif "whole round" in label:
            check(c["bayes_predict"] == 1,
                  f"{label}: not one bayes_predict kernel")
        else:
            check(c["h2d"] == 1 and c["d2h"] == 1 and c["nig_fold"] == 1,
                  f"{label}: not one copy each way and one nig_fold kernel")
    check(len(got) == 6, f"the profiler saw {len(got)} of 6 steps")


def fan_dag(n_tasks: int):
    """One task feeding n_tasks - 1 sinks: ranks of two levels, the sinks
    of each task type tied."""
    from repro_torch.workflow.dag import TaskInstance, WorkflowDAG
    dag = WorkflowDAG("fan")
    for i in range(n_tasks):
        dag.add(TaskInstance(f"t{i}", TASK_TYPES[i % len(TASK_TYPES)], "fan",
                             1.0, output_gb=0.5, deps=[] if i == 0
                             else ["t0"]))
    return dag


def chain_dag(n_tasks: int):
    """n_tasks in a chain: n_tasks levels, the rank kernel's longest
    walk."""
    from repro_torch.workflow.dag import TaskInstance, WorkflowDAG
    dag = WorkflowDAG("chain")
    for i in range(n_tasks):
        dag.add(TaskInstance(f"t{i}", TASK_TYPES[i % len(TASK_TYPES)],
                             "chain", 1.0, output_gb=1.0,
                             deps=[f"t{i - 1}"] if i else []))
    return dag


def layer_deps(rng: np.random.Generator, sizes) -> list:
    """Each task's dependencies (task indices) in a layered DAG of these
    layer sizes: every task of a layer but the last feeds a task of the
    next one, every task past the first layer has a dependency in the
    layer above, and a few edges skip a layer, so layer j is exactly level
    len(sizes) - 1 - j of the rank walk."""
    starts = np.concatenate([[0], np.cumsum(sizes)])
    deps = [set() for _ in range(int(starts[-1]))]
    for j in range(len(sizes) - 1):
        here = range(starts[j], starts[j + 1])
        nxt = range(starts[j + 1], starts[j + 2])
        for u in here:
            deps[int(rng.choice(nxt))].add(u)
        for v in nxt:
            if not deps[v]:
                deps[v].add(int(rng.choice(here)))
            if j and rng.random() < 0.2:
                deps[v].add(int(rng.integers(starts[j - 1], starts[j])))
    return [sorted(d) for d in deps]


def deps_dag(name: str, deps: list):
    """A DAG of len(deps) tasks, task i depending on tasks deps[i]."""
    from repro_torch.workflow.dag import TaskInstance, WorkflowDAG
    dag = WorkflowDAG(name)
    for i, d in enumerate(deps):
        dag.add(TaskInstance(f"t{i}", TASK_TYPES[i % len(TASK_TYPES)], name,
                             1.0, output_gb=0.25 + (i % 7) / 4,
                             deps=[f"t{j}" for j in d]))
    return dag


def overflow_dag(rng: np.random.Generator):
    """OVERFLOW_TASKS tasks, each depending on up to OVERFLOW_FAN_IN of the
    300 before it: about 75,000 edges, so the rank tables (~340 KB) do not
    fit a block's shared memory and the ranks take the global route."""
    return deps_dag("overflow", [
        sorted(rng.choice(np.arange(max(0, i - 300), i),
                          min(i, OVERFLOW_FAN_IN), replace=False).tolist())
        for i in range(OVERFLOW_TASKS)])


def misaligned(tab):
    """The RankTable `tab` copied to storage one element past a 16-byte
    boundary (the global route's case)."""
    import torch
    from repro_torch.kernels.decision_plane import RankTable

    def shift(x):
        y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
        return y.copy_(x)
    return RankTable(*(shift(x) for x in tab))


def rank_checks(dev, nodes, W0, dag0, rng: np.random.Generator) -> float:
    """upward_rank on the card bitwise `_PlanContext.ranks` and its plain
    version (on the CPU), lane by lane and in mixed-T launches: the replan
    DAG with its W of the last round, a chain, a fan, a DAG whose levels
    alternate between more and at most 32 rows (shared route), a lane
    whose tables overflow shared memory and the replan lane's tables off a
    16-byte boundary (global route); each launch's route is
    `rank_config`'s and is counted; a NaN lane among finite ones is flagged
    alone.  The chain's and fan's W are `rng`'s next two draws of
    (PLAN_TASKS, N); the other cases draw from a generator of their own.
    -> the largest |err| (0.0 when bitwise)."""
    import torch
    from repro_torch.kernels import decision_plane as plane_k
    from repro_torch.kernels import ref
    from repro_torch.sched import fused
    n = len(nodes)
    draws = [rng.uniform(1.0, 100.0, (PLAN_TASKS, n)) for _ in range(2)]
    more = np.random.default_rng(38)
    dags = [("replan", dag0, W0.cpu().numpy()),
            ("chain", chain_dag(PLAN_TASKS), draws[0]),
            ("fan", fan_dag(PLAN_TASKS), draws[1]),
            ("narrow/wide", deps_dag("layers", layer_deps(
                more, NARROW_WIDE_LAYERS)), None),
            ("overflow", overflow_dag(more), None),
            ("misaligned", dag0, W0.cpu().numpy())]
    cases = []
    for name, dag, w in dags:
        ctx = fused._PlanContext(dag, nodes)
        if w is None:
            w = more.uniform(1.0, 100.0, (len(ctx.order), n))
        W = torch.from_numpy(np.ascontiguousarray(w)).to(dev)
        tab = ctx.on_device(dev)["rank"]
        if name == "misaligned":
            tab = misaligned(tab)
        host = ctx.ranks(dag, w)
        want = np.asarray([host[u] for u in ctx.order])
        cases.append((name, ctx, W, tab, want))
    optin, sms = plane_k.smem_optin(dev.index), plane_k.sm_count(dev.index)
    err = 0.0

    def launch(idx, label, route):
        nonlocal err
        sel = [cases[k] for k in idx]
        Ws, tabs = [c[2] for c in sel], [c[3] for c in sel]
        before = dict(plane_k.upward_rank.launches_by_route)
        rank, bad = plane_k.upward_rank(Ws, tabs)
        took = {k: v - before[k]
                for k, v in plane_k.upward_rank.launches_by_route.items()
                if v > before[k]}
        plain, plain_bad = ref.upward_rank_ref([w.cpu() for w in Ws],
                                               [t.to("cpu") for t in tabs])
        got = rank.cpu().numpy()
        same = np.array_equal(got.view(np.int64),
                              plain.numpy().view(np.int64))
        for k, c in enumerate(sel):
            t = c[3].T
            same &= np.array_equal(got[k, :t].view(np.int64),
                                   c[4].view(np.int64))
            err = max(err, float(np.abs(got[k, :t] - c[4]).max()))
        cfg = plane_k.rank_config(
            max(t.T for t in tabs), max(t.E for t in tabs),
            max(t.L for t in tabs), n, len(sel), optin, sms,
            aligned=not any(x.data_ptr() & 15 for t in tabs for x in t))
        levels = [c[3].L for c in sel]
        print(f"[replan] upward_rank {label} T={[c[3].T for c in sel]} "
              f"N={n} levels {levels}: route {took} (rank_config "
              f"{cfg['route']}, cluster {cfg['cluster']}), bitwise "
              f"_PlanContext.ranks and the plain version {same}, flags "
              f"{bad.tolist()}")
        check(same and bad.tolist() == [0] * len(sel)
              and plain_bad.tolist() == [0] * len(sel)
              and took == {route: 1} and cfg["route"] == route,
              f"upward_rank ({label}) differs from its plain version or "
              f"did not launch once on the {route} route")

    for k, (name, *_rest) in enumerate(cases):
        launch([k], name, "global" if k >= 4 else "shared")
    launch([0, 1, 2, 3], "replan, chain, fan, narrow/wide in one launch",
           "shared")
    launch([4, 5, 2], "overflow, misaligned, fan in one launch", "global")
    # a NaN lane among finite ones: its flag alone, the others bitwise
    W_nan = cases[1][2].clone()
    W_nan[PLAN_TASKS // 2, n // 3] = float("nan")
    Ws = [cases[0][2], W_nan, cases[2][2]]
    tabs = [cases[k][3] for k in (0, 1, 2)]
    rank, bad = plane_k.upward_rank(Ws, tabs)
    plain, plain_bad = ref.upward_rank_ref([w.cpu() for w in Ws],
                                           [t.to("cpu") for t in tabs])
    got = rank.cpu().numpy()
    same = all(np.array_equal(got[k, :cases[c][3].T].view(np.int64),
                              cases[c][4].view(np.int64))
               for k, c in ((0, 0), (2, 2)))
    same &= np.array_equal(got[1], plain.numpy()[1], equal_nan=True)
    print(f"[replan] upward_rank a NaN lane among finite ones: flags "
          f"{bad.tolist()} (plain {plain_bad.tolist()}), the finite lanes "
          f"bitwise and the NaN lane equal to the plain version {same}")
    check(same and bad.tolist() == [0, 1, 0]
          and plain_bad.tolist() == [0, 1, 0],
          "upward_rank did not flag the NaN lane alone")
    return err


def replan_kernel_checks(dev, fleet_out, planes, reqs) -> dict:
    """upward_rank and eft_sweep_many on the card against their plain
    versions: `rank_checks` for the ranks.  The sweep
    bitwise its plain version on the CPU for a group with lanes of
    different T, a group of tie packs, the first group at S = 4 (stacks
    overflowing) and two lanes of WIDE_NODES nodes (the global route, a launch a lane); then the cell's
    second cluster replanned from slot_cap 4, its sweeps retried on the
    shared route, schedules identical to `heft_schedule_matrix`."""
    import torch
    from repro_torch.kernels import decision_plane as plane_k
    from repro_torch.kernels import ref
    from repro_torch.online import PredictionService
    from repro_torch.sched import fused
    from repro_torch.sched.fused import FusedPlane, ReplanRequest, replan_many
    from repro_torch.sched.heft import heft_schedule_matrix
    from repro_torch.sched.plane import PredictionMatrix
    nodes = fleet_out["replan_nodes"]
    rng = np.random.default_rng(37)
    rank_err = rank_checks(dev, nodes, planes[0]._costs(reqs[0].dag,
                                                       PLAN_QUANTILE),
                           reqs[0].dag, rng)

    def lanes(packs):
        for p in packs:
            p[1] = rng.permutation(p[1].shape[0]).astype(np.int32)
            p[6], p[7] = packs[0][6], packs[0][7]
        t = max(p[0].shape[0] for p in packs)
        order = np.full((len(packs), t), -1, np.int32)
        for k, p in enumerate(packs):
            order[k, :p[0].shape[0]] = p[1]
        c = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        return ([c(p[0]) for p in packs], c(order), [c(p[2]) for p in packs],
                [c(p[3]) for p in packs], [c(p[4]) for p in packs],
                [c(p[5]) for p in packs], c(packs[0][6]), c(packs[0][7]))

    mixed = lanes([wide_pack(rng, PLAN_TASKS, PLAN_NODES),
                   chain_pack(rng, 850, PLAN_NODES),
                   tie_pack(rng, 700, PLAN_NODES),
                   wide_pack(rng, 300, PLAN_NODES)])
    ties = lanes([tie_pack(np.random.default_rng(41 + k), SWEEP_CASE_TASKS,
                           PLAN_NODES) for k in range(4)])
    wide = lanes([wide_pack(rng, 200, WIDE_NODES),
                  wide_pack(rng, 150, WIDE_NODES)])
    err = 0.0
    for label, a, s, route in (
            ("lanes of T 1000, 850, 700, 300", mixed, 48, "shared"),
            ("four tie packs", ties, 48, "shared"),
            ("lanes of T 1000, 850, 700, 300", mixed, 4, "shared"),
            (f"two lanes of T 200, 150 on {WIDE_NODES} nodes", wide, 48,
             "global")):
        on = [[x.to(dev) for x in v] if isinstance(v, list) else v.to(dev)
              for v in a]
        before = dict(plane_k.eft_sweep_many.launches_by_route)
        got = [g.cpu() for g in plane_k.eft_sweep_many(*on, S=s)]
        took = {k: n - before[k] for k, n in
                plane_k.eft_sweep_many.launches_by_route.items()
                if n > before[k]}
        want = ref.eft_sweep_many_ref(*a, S=s)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        # equal cells (an overflowed lane's inf starts too) differ by 0
        e = max(float(torch.where(got[k] == want[k], 0.0,
                                  (got[k] - want[k]).abs()).max())
                for k in (1, 2))
        err = max(err, e)
        print(f"[replan] eft_sweep_many {label} S={s}: launches by route "
              f"{took}, identical to the plain version (CPU float64) "
              f"{same}, max |err| {e!r}, max count {int(got[3].max())}")
        # the global route runs the lanes in turn, a launch each
        want_took = {route: 1 if route == "shared" else len(a[0])}
        check(took == want_took and same,
              f"eft_sweep_many ({label}, S={s}) differs from its plain "
              f"version or did not launch {want_took}")
        if s == 4:
            check(int(got[3].max()) > 3, "the S = 4 group did not overflow")

    # the second cluster's workflows replanned from 4 interval columns
    names = [n.name for n in nodes]
    b_reqs = [r for r in reqs if r.plane.node_names != names]
    svc = b_reqs[0].plane.service
    retry = [FusedPlane(svc, r.plane.nodes, dag=r.dag) for r in b_reqs]
    for p, r in zip(retry, b_reqs):
        fused._context(r.dag, p.nodes, p.rank_cache).slot_cap = 4
    before = (plane_k.eft_sweep_many.launches,
              dict(plane_k.eft_sweep_many.launches_by_route))
    got = replan_many([ReplanRequest(p, r.dag, quantile=PLAN_QUANTILE)
                       for p, r in zip(retry, b_reqs)])
    n_sweeps = plane_k.eft_sweep_many.launches - before[0]
    routes = {k: v - before[1][k]
              for k, v in plane_k.eft_sweep_many.launches_by_route.items()}
    fresh = PredictionService(svc.predictor, svc.benches, device=dev)
    for k, (p, r) in enumerate(zip(retry, b_reqs)):
        entries = [(u, t.task_name, t.input_gb)
                   for u, t in r.dag.tasks.items()]
        want = heft_schedule_matrix(
            r.dag, p.nodes, PredictionMatrix.from_service(fresh, entries,
                                                          p.nodes),
            quantile=PLAN_QUANTILE)
        check(same_schedule(got[k], want), f"replan slot retry: workflow "
              f"{k}'s schedule differs from heft_schedule_matrix")
    caps = replan_caps([ReplanRequest(p, r.dag) for p, r in zip(retry,
                                                                 b_reqs)])
    print(f"[replan] slot retry of the {len(b_reqs)}-workflow cluster from "
          f"S=4 to {caps}: {n_sweeps} eft_sweep_many launches by route "
          f"{routes}; schedules identical to heft_schedule_matrix")
    check(n_sweeps >= 2 and routes["global"] == 0 and caps[0] > 4,
          "the replan slot retry did not run on the shared route")
    return {"upward_rank": (rank_err, 0.0), "eft_sweep_many": (err, 0.0)}


def rank_route_pairs(label: str, run, pairs: int) -> dict:
    """`run` (one warm round; nothing moves between calls) timed on the
    host clock, a sync before and after, in `pairs` pairs: once with
    upward_rank on its own route (`rank_config`'s, the cluster launch)
    and once forced onto the global route (PR 28's kernel and launch),
    the order flipped every pair.  -> {route: [ms, ...]}."""
    import torch
    from repro_torch.kernels import decision_plane as plane_k
    config = plane_k.rank_config

    def on_global(*a, **k):
        return config(*a, **dict(k, aligned=False))
    times = {"shared": [], "global": []}
    for p in range(pairs):
        for route in ("shared", "global")[::1 if p % 2 == 0 else -1]:
            before = dict(plane_k.upward_rank.launches_by_route)
            plane_k.rank_config = config if route == "shared" else on_global
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times[route].append((time.perf_counter() - t0) * 1e3)
            finally:
                plane_k.rank_config = config
            took = {k: v - before[k]
                    for k, v in plane_k.upward_rank.launches_by_route.items()
                    if v > before[k]}
            check(list(took) == [route], f"{label}: a round meant for the "
                  f"{route} route launched {took}")
    q = {r: [float(x) for x in np.percentile(v, [25, 50, 75])]
         for r, v in times.items()}
    wins = sum(a < b for a, b in zip(times["shared"], times["global"]))
    print(f"[{label.split()[0]}] {label}, {pairs} pairs in turns, ms "
          f"(host clock): rank launch on its own route median "
          f"{q['shared'][1]!r} (quartiles {q['shared'][0]!r}-"
          f"{q['shared'][2]!r}); forced onto the global route median "
          f"{q['global'][1]!r} ({q['global'][0]!r}-{q['global'][2]!r}); "
          f"own route faster in {wins} of {pairs} pairs")
    return times


def warm_round_pairs(dev, fleet_out, problem) -> None:
    """The warm rounds of phases 7 and 8 (nothing moved since a cold
    round, on fresh planes over a fresh predictor, as before their first
    ingest batch) by `rank_route_pairs`: the plane's 20 pairs, the replan
    cell's 10."""
    from repro_torch.online import OnlinePredictor, PredictionService
    from repro_torch.sched.fused import FusedPlane, replan_many
    svc = fleet_out["replan_service"]
    dag, nodes = fleet_out["replan_dag"], fleet_out["replan_nodes"]
    benches = dict(svc.benches)
    plane = FusedPlane(PredictionService(OnlinePredictor(
        svc.predictor, benches, device=dev), benches, device=dev), nodes,
        dag=dag)

    def plane_round():
        plane.schedule(dag, quantile=PLAN_QUANTILE, engine="device")
    plane_round()                        # the cold round
    rank_route_pairs("plane warm round", plane_round, pairs=20)
    _, reqs = replan_planes(dev, problem, OnlinePredictor(
        svc.predictor, problem["benches"], device=dev))
    replan_many(reqs)                    # the cold round
    rank_route_pairs("replan warm round of 38 workflows",
                     lambda: replan_many(reqs), pairs=10)


def once_ms(fn) -> float:
    """CUDA-event time of one call, the card idle and the L2 flushed
    before it: for a plain version too slow to repeat."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    flush_l2()
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_rank(Ws, tabs, plain: bool = True) -> dict:
    """upward_rank over these lanes: on its route (`rank_config`'s) through
    the C entry point with the L2 flushed (`ms`) and back to back
    (`warm_ms`), through the wrapper (`wrapper_ms`), on the global route
    (PR 28's kernel, `global_ms`), the plain version on the card
    (`plain_ms`, unless plain=False), the launch shape and both bounds."""
    from repro_torch.kernels import decision_plane as plane_k
    from repro_torch.kernels import ref
    dev = Ws[0].device
    b, n = len(Ws), Ws[0].shape[1]
    cfg = plane_k.rank_config(
        max(t.T for t in tabs), max(t.E for t in tabs),
        max(t.L for t in tabs), n, b, plane_k.smem_optin(dev.index),
        plane_k.sm_count(dev.index))
    on_route = rank_launch(Ws, tabs, cfg["route"], cfg["cluster"])
    bound, by, latency = bounds_rank(Ws, tabs, cfg["cluster"])
    rk = {"ms": time_ms(on_route), "warm_ms": warm_ms(on_route),
          "global_ms": time_ms(rank_launch(Ws, tabs, "global")),
          "wrapper_ms": time_ms(lambda: plane_k.upward_rank(Ws, tabs),
                                host=True),
          "bound_ms": bound, "bound_by": by, "latency_bound_ms": latency,
          "binds": "latency" if latency > bound else by,
          "route": cfg["route"], "cluster": cfg["cluster"],
          "tile_rows": cfg["tile_rows"], "smem_bytes": cfg["smem_bytes"],
          "levels": max(t.L for t in tabs)}
    if plain:
        rk["plain_ms"] = time_ms(lambda: ref.upward_rank_ref(Ws, tabs),
                                 reps=3, host=True)
    return rk


def time_replan(dev, rpc) -> dict:
    """Times of upward_rank and eft_sweep_many on the replan cell's first
    cluster at its last round's state, for one lane and for all REPLAN_A
    (1000 x 100, S = 48): through the C entry points with the L2 flushed
    (`ms`) and back to back (`warm_ms`), through the wrappers
    (`wrapper_ms`), and the plain versions on the card (`plain_ms`; the
    many-lane sweep's once, at REPLAN_A lanes); for the ranks (`time_rank`)
    also the global route, a chain of PLAN_TASKS levels at one lane and
    the host ranks they replace, with and without W's copy to the host;
    and the bounds.  -> {lanes: {kernel: times}}."""
    import torch
    from repro_torch.kernels import decision_plane as plane_k
    from repro_torch.kernels import ref
    from repro_torch.sched import fused
    planes, reqs = rpc["planes"], rpc["reqs"]
    group = [(p, r) for p, r in zip(planes, reqs)
             if p.node_names == planes[0].node_names]
    ctxs = [fused._context(r.dag, p.nodes, p.rank_cache) for p, r in group]
    Ws = [p._costs(r.dag, PLAN_QUANTILE) for p, r in group]
    sts = [c.on_device(dev) for c in ctxs]
    tabs = [st["rank"] for st in sts]
    order = fused._rank_order(fused._device_ranks(ctxs, Ws))
    b, t = order.shape
    n = Ws[0].shape[1]
    dep = [st["dep_rows"] for st in sts]
    gb8 = [st["gb8"] for st in sts]
    ready0 = [st["zeros"] for st in sts]
    avail = [st["avail0"] for st in sts]
    same, gbps = sts[0]["same"], sts[0]["gbps_min"]
    lib = plane_k._lib()
    f64, i32 = torch.float64, torch.int32
    out = {}
    for nb in (1, b):
        o = order[:nb].contiguous()
        d = max(x.shape[1] for x in dep[:nb])
        table = plane_k._lane_table(
            [[Ws[k].data_ptr(), ready0[k].data_ptr(), dep[k].data_ptr(),
              gb8[k].data_ptr(), avail[k].data_ptr(), dep[k].shape[1]]
             for k in range(nb)], dev)
        outs = [torch.empty((nb, t + 1, n), dtype=f64, device=dev),
                torch.empty((nb, n), dtype=i32, device=dev),
                torch.zeros((nb, t + 1), dtype=i32, device=dev),
                torch.zeros((nb, t + 1), dtype=f64, device=dev),
                torch.zeros((nb, t + 1), dtype=f64, device=dev)]
        sweep = raw_launch("eft_sweep_many", [table, nb, o, d, same, gbps, t,
                                              n, 48] + outs, lib)
        args = (Ws[:nb], o, dep[:nb], gb8[:nb], ready0[:nb], avail[:nb],
                same, gbps)
        assign = plane_k.eft_sweep_many(*args, S=48)[0]
        bound, by, step = bounds_sweep_many(
            [(Ws[k], o[k], dep[k], gb8[k], ready0[k], avail[k], same, gbps)
             for k in range(nb)], list(assign))
        sw = {"ms": time_ms(sweep, reps=10),
              "warm_ms": warm_ms(sweep, reps=10, inner=5),
              "wrapper_ms": time_ms(lambda: plane_k.eft_sweep_many(
                  *args, S=48), reps=10, host=True),
              "bound_ms": bound, "bound_by": by, "step_bound_ms": step}
        out[nb] = {"eft_sweep_many": sw,
                   "upward_rank": time_rank(Ws[:nb], tabs[:nb])}
    chain = fused._PlanContext(chain_dag(PLAN_TASKS), group[0][0].nodes)
    out[1]["upward_rank"]["chain"] = time_rank(
        [torch.from_numpy(np.random.default_rng(43).uniform(
            1.0, 100.0, (PLAN_TASKS, n))).to(dev)],
        [chain.on_device(dev)["rank"]], plain=False)
    dag0 = group[0][1].dag
    W_host = Ws[0].cpu().numpy()
    rk = out[1]["upward_rank"]
    rk["host_ranks_ms"] = median_s(lambda: ctxs[0].ranks(dag0, W_host),
                                   reps=5) * 1e3
    rk["host_ranks_copy_ms"] = median_s(
        lambda: ctxs[0].ranks(dag0, Ws[0].cpu().numpy()), reps=5) * 1e3
    out[b]["eft_sweep_many"]["plain_ms"] = once_ms(
        lambda: ref.eft_sweep_many_ref(Ws, order, dep, gb8, ready0, avail,
                                       same, gbps, S=48))
    return out


def report_replan(launches, errors, times) -> list:
    """The report lines and the kernels JSON rows of upward_rank (at one
    lane, the plan and plane paths' shape) and eft_sweep_many (at
    REPLAN_A lanes, the replan path's)."""
    b = max(times)
    for nb, tm in sorted(times.items()):
        rk = dict(tm["upward_rank"])
        chain = rk.pop("chain", None)
        print(f"[report] upward_rank B={nb} T={PLAN_TASKS} N={PLAN_NODES}: "
              f"{rk}")
        if chain:
            print(f"[report] upward_rank chain B=1 T={PLAN_TASKS} "
                  f"N={PLAN_NODES}: {chain}")
        print(f"[report] eft_sweep_many B={nb} T={PLAN_TASKS} "
              f"N={PLAN_NODES} S=48 (shared route): {tm['eft_sweep_many']}")
    ur, sm = times[1]["upward_rank"], times[b]["eft_sweep_many"]
    dsrc = "src/repro_torch/kernels/csrc/decision_plane.cu"
    return [
        {"name": "upward_rank", "route": "cuda", "source": dsrc,
         "replaces": "src/repro/kernels/decision_plane.py:155",
         "launches": launches["upward_rank"],
         "max_abs_err": errors["upward_rank"][0], "tolerance": "bitwise",
         "tol_ratio": 0.0, "ms": ur["ms"], "plain_ms": ur["plain_ms"],
         "bound_ms": ur["bound_ms"], "bound_by": ur["bound_by"],
         "library_ms": None, "warm_ms": ur["warm_ms"],
         "wrapper_ms": ur["wrapper_ms"], "host_ranks_ms": ur["host_ranks_ms"],
         "host_ranks_copy_ms": ur["host_ranks_copy_ms"],
         "rank_route": ur["route"], "cluster": ur["cluster"],
         "latency_bound_ms": ur["latency_bound_ms"], "binds": ur["binds"],
         "global_route_ms": ur["global_ms"],
         "shape": f"B=1 T={PLAN_TASKS} N={PLAN_NODES}",
         "chain": {k: ur["chain"][k] for k in (
             "ms", "global_ms", "bound_ms", "latency_bound_ms", "route",
             "cluster")},
         "by_lanes": {b: times[b]["upward_rank"]}},
        {"name": "eft_sweep_many", "route": "cuda", "source": dsrc,
         "replaces": "src/repro/kernels/decision_plane.py:268",
         "launches": launches["eft_sweep_many"],
         "max_abs_err": errors["eft_sweep_many"][0], "tolerance": "bitwise",
         "tol_ratio": 0.0, "ms": sm["ms"], "plain_ms": sm["plain_ms"],
         "bound_ms": sm["bound_ms"], "bound_by": sm["bound_by"],
         "library_ms": None, "warm_ms": sm["warm_ms"],
         "wrapper_ms": sm["wrapper_ms"], "step_bound_ms": sm["step_bound_ms"],
         "sweep_route": "shared",
         "shape": f"B={b} T={PLAN_TASKS} N={PLAN_NODES} S=48",
         "by_lanes": {1: times[1]["eft_sweep_many"]}},
    ]


# ---------------------------------------------------------------------------
# adaptive: in-flight rescheduling and speculation
# ---------------------------------------------------------------------------
# true runtime multiplier per machine class: benchmarks/online_adaptation.py
ADAPTIVE_DRIFT = {"A1": 1.5, "A2": 0.7, "N1": 1.4, "N2": 0.6, "C2": 2.0}
ADAPTIVE_SEED = 41
ADAPTIVE_NOISE = 0.1             # sigma of the lognormal runtime factor
ADAPTIVE_STRAGGLERS = (0.08, 5.0)  # share of tasks, runtime factor
ADAPTIVE_SPEC = dict(q=0.95, check_interval_s=15.0)
ADAPTIVE_COOLDOWN = 25
ADAPTIVE_COST_Q = 0.95
# a re-plan's pieces and a completion's (each exclusive of those inside it)
ADAPTIVE_SPLIT = ("subdag_ctx_s", "running_s", "ready_s", "plane_sync_s",
                  "cost_view_s", "rank_s", "sweep_s", "rebuild_s",
                  "predict_s", "factors_s", "other_s")
COMPLETION_SPLIT = ("observe_s", "predict_s", "factors_s", "other_s")


def sim_key(res) -> tuple:
    """What two runs of `execute_adaptive` must share to be identical."""
    return ([(r.uid, r.node, r.start, r.finish, r.attempt)
             for r in res.records], res.makespan, res.node_busy,
            res.n_reschedules, res.n_backups, res.backup_waste_s)


class AdaptiveSplit:
    """Times one planner's run piece by piece, each piece ended by a
    device sync and timed exclusive of the pieces inside it.  Every
    `on_completion`: the scalar `observe`, the service's `predict_batch`
    (the store's gather, the copy up, one `bayes_predict`, the copy back)
    and its per-query factors (static x node correction); the rest (the
    frontier, its queries, the band test) is `other_s`, a re-plan inside
    it excluded.  Every re-plan: the sub-DAG and its context, the running
    tasks' estimate, the ready rows, the plane's sync and host matrix,
    the cost view, the rank launch and its flag read, the sweep with its
    rank order and copy back, the Schedule rebuild; the rest (bands, rows
    for speculation) is `other_s`.  Installed for the run and removed
    after it."""

    def __init__(self, planner, dev):
        import torch
        from repro_torch.sched import fused
        self.planner, self.fused = planner, fused
        self.sync = (torch.cuda.synchronize if dev.type == "cuda"
                     else (lambda: None))
        self.completions = []          # ({piece: seconds}, re-planned)
        self.replans = []              # {piece: seconds}
        self.last = None               # the last schedule handed out
        self._cur = None               # the region being timed
        self._frames = []
        self._patched = []             # (object, attribute)
        self._saved = {}

    def _timed(self, piece, fn):
        def run(*a, **kw):
            cur = self._cur
            if cur is None:
                return fn(*a, **kw)
            self._frames.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.sync()
                spent = time.perf_counter() - t0
                cur[piece] = (cur.get(piece, 0.0) + spent
                              - self._frames.pop())
                self._frames[-1] += spent
        return run

    def _region(self, fn, record):
        """A top-level region (a completion or a re-plan): its pieces go
        to a dict of its own, handed to `record(pieces, result)`."""
        def run(*a, **kw):
            outer, cur = self._cur, {}
            self._cur = cur
            self._frames.append(0.0)
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            finally:
                self.sync()
                spent = time.perf_counter() - t0
                cur["other_s"] = spent - self._frames.pop()
                cur["total_s"] = spent
                self._cur = outer
                if self._frames:
                    self._frames[-1] += spent
            record(cur, out)
            return out
        return run

    def _patch(self, obj, name, wrapped):
        setattr(obj, name, wrapped)
        self._patched.append((obj, name))

    def __enter__(self):
        planner, plane, fused = self.planner, self.planner._plane, self.fused
        for obj, name, piece in (
                (planner, "_frontier_dag", "subdag_ctx_s"),
                (planner, "_running_ends", "running_s"),
                (planner, "_ready_rows", "ready_s"),
                (planner.online, "observe", "observe_s"),
                (planner.service, "predict_batch", "predict_s"),
                (planner.service._binding, "factors", "factors_s"),
                (plane, "matrix", "plane_sync_s"),
                (plane, "_costs", "cost_view_s")):
            self._patch(obj, name, self._timed(piece, getattr(obj, name)))
        for name, piece in (("_device_ranks", "rank_s"),
                            ("_sweep_lanes", "sweep_s"),
                            ("_build_schedule", "rebuild_s")):
            self._saved[name] = getattr(fused, name)
            setattr(fused, name, self._timed(piece, self._saved[name]))

        def completed(cur, out):
            self.completions.append((cur, out is not None))
            if out is not None:
                self.last = out
        self._patch(planner, "_replan", self._region(
            planner._replan, lambda cur, out: self.replans.append(cur)))
        self._patch(planner, "on_completion",
                    self._region(planner.on_completion, completed))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.fused, name, fn)
        for obj, name in self._patched:
            del obj.__dict__[name]


def adaptive_planner(dag, nodes, lot, benches, dev, engine, **kw):
    """The port's planner over a fresh `OnlinePredictor` of `lot` on
    `dev`."""
    from repro_torch.online import OnlinePredictor, OnlineReschedulingPlanner
    return OnlineReschedulingPlanner(
        dag, nodes, OnlinePredictor(lot, benches, device=dev),
        benches=benches, engine=engine, device=dev, **kw)


def adaptive_paper(dev) -> int:
    """The paper's online scenario (benchmarks/online_adaptation.py,
    `run_makespan_recovery`): each nf-core workflow on the five target
    machines, whose true speeds drifted by ADAPTIVE_DRIFT, planned by the
    port's planner on `dev` (device engine) and on the CPU (numpy engine)
    over the same Lotaru-G posteriors (fitted on the CPU, carried to the
    card).  The two `SimResult`s must be identical.  -> device rounds
    (initial schedules and re-plans), their sweep launches (more than one
    a round after a slot retry)."""
    import torch
    from repro_torch.convert import predictor_from_state, predictor_state
    from repro_torch.sched.cluster import TARGET_MACHINES
    from repro_torch.sched.heft import heft_schedule
    from repro_torch.workflow.generator import WORKFLOWS
    from repro_torch.workflow.simulator import (execute_adaptive,
                                                execute_schedule)
    cpu = torch.device("cpu")
    nodes = list(TARGET_MACHINES)
    rounds = sweeps = 0
    for wf in WORKFLOWS:
        gt, dag, benches, preds = paper_experiment(wf, 0, "cpu")
        lot = preds["lotaru-g"]
        on_card = predictor_from_state(predictor_state(lot), dev)

        def true_rt(u, n, gt=gt, dag=dag):
            t = dag.tasks[u]
            return (gt.runtime(t.task_name, t.input_gb, n, u)
                    * ADAPTIVE_DRIFT.get(n.name, 1.0))

        def pred_rt(u, n, lot=lot, dag=dag, benches=benches):
            t = dag.tasks[u]
            return lot.predict(t.task_name, t.input_gb, benches[n.name])[0]
        static = execute_schedule(dag, heft_schedule(dag, nodes, pred_rt),
                                  nodes, true_rt)
        oracle = execute_schedule(dag, heft_schedule(dag, nodes, true_rt),
                                  nodes, true_rt)
        planner = adaptive_planner(dag, nodes, on_card, benches, dev,
                                   "device")
        t0 = time.perf_counter()
        got = execute_adaptive(dag, nodes, planner, true_rt)
        t1 = time.perf_counter()
        want = execute_adaptive(dag, nodes,
                                adaptive_planner(dag, nodes, lot, benches,
                                                 cpu, "numpy"), true_rt)
        check(sim_key(got) == sim_key(want),
              f"adaptive {wf}: the SimResult on the card differs from the "
              f"CPU run")
        check(planner._plane.w_host_copies == 0,
              f"adaptive {wf}: a device-engine pass copied W to the host")
        rounds += 1 + got.n_reschedules
        sweeps += planner._plane.stats.sweep_dispatches
        print(f"[adaptive] paper {wf} ({len(dag.tasks)} tasks, 5 nodes): "
              f"makespan static {float(static.makespan)!r} s, adaptive "
              f"{float(got.makespan)!r} s ({got.n_reschedules} re-plans, "
              f"{planner.stats}, {planner._plane.stats.sweep_dispatches} "
              f"sweeps), oracle {float(oracle.makespan)!r} s; run "
              f"{t1 - t0:.4f} s host clock; identical to the CPU run")
    return rounds, sweeps


def adaptive_problem(dev_cpu):
    """The 1000 x 100 replan problem (`replan_problem`, seed 0) with true
    runtimes: the CPU service's mean x ADAPTIVE_DRIFT by machine class x a
    seeded lognormal factor, and ADAPTIVE_STRAGGLERS of the tasks slowed."""
    from repro_torch.sched.plane import PredictionMatrix
    dag, nodes, svc = replan_problem(PLAN_TASKS, PLAN_NODES, 0, dev_cpu)
    entries = [(u, t.task_name, t.input_gb) for u, t in dag.tasks.items()]
    mean = PredictionMatrix.from_service(svc, entries, nodes).means
    rng = np.random.default_rng(ADAPTIVE_SEED)
    drift = np.asarray([ADAPTIVE_DRIFT.get(n.name.rsplit("-", 1)[0], 1.0)
                        for n in nodes])
    truth = mean * drift[None, :] * rng.lognormal(0.0, ADAPTIVE_NOISE,
                                                  mean.shape)
    row = {u: i for i, u in enumerate(dag.tasks)}
    col = {n.name: j for j, n in enumerate(nodes)}
    frac, factor = ADAPTIVE_STRAGGLERS
    slow = {u for u in dag.tasks if rng.random() < frac}
    return {"dag": dag, "nodes": nodes, "lot": svc.predictor,
            "benches": dict(svc.benches),
            "true_rt": lambda u, n: float(truth[row[u], col[n.name]]),
            "factor": lambda u: factor if u in slow else 1.0,
            "n_slow": len(slow)}


def adaptive_run(prob, dev, engine):
    """One `execute_adaptive` of the full-width problem with speculation on
    `dev` and `engine`, timed by an `AdaptiveSplit` -> (result, planner, host
    seconds, the split)."""
    from repro_torch.workflow.simulator import (SpeculationPolicy,
                                                execute_adaptive)
    planner = adaptive_planner(prob["dag"], prob["nodes"], prob["lot"],
                               prob["benches"], dev, engine,
                               cooldown=ADAPTIVE_COOLDOWN)
    t0 = time.perf_counter()
    with AdaptiveSplit(planner, dev) as timer:
        res = execute_adaptive(prob["dag"], prob["nodes"], planner,
                               prob["true_rt"],
                               straggler_factor=prob["factor"],
                               speculation=SpeculationPolicy(**ADAPTIVE_SPEC))
    return res, planner, time.perf_counter() - t0, timer


def phase_adaptive(dev) -> dict:
    """In-flight rescheduling and speculation on the card through
    `execute_adaptive` with the port's `OnlineReschedulingPlanner` (its
    plane on `dev`, the device engine): the paper scenario, then the
    1000 x 100 problem with 8 % stragglers, speculation and a cooldown,
    each against the port's CPU run (numpy engine) of the same seed.  The
    launch counts are read around the full-width run; the caller checks
    the phase's totals.  -> {"device_rounds": initial schedules and
    re-plans on the device engine, ...}."""
    import dataclasses
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import decision_plane as plane_k
    from repro_torch.sched.cost import predicted_cost_quantile
    rounds, sweeps = adaptive_paper(dev)
    cpu = torch.device("cpu")
    prob = adaptive_problem(cpu)
    before = (kernels.bayes_predict.launches, plane_k.upward_rank.launches,
              plane_k.eft_sweep.launches)
    got, planner, host_s, timer = adaptive_run(prob, dev, "device")
    launched = (kernels.bayes_predict.launches - before[0],
                plane_k.upward_rank.launches - before[1],
                plane_k.eft_sweep.launches - before[2])
    want, cplanner, cpu_s, ctimer = adaptive_run(prob, cpu, "numpy")
    check(sim_key(got) == sim_key(want),
          "adaptive 1000x100: the SimResult on the card differs from the "
          "CPU run")
    check(dataclasses.asdict(planner.stats)
          == dataclasses.asdict(cplanner.stats),
          "adaptive 1000x100: RescheduleStats differ from the CPU run")
    check(planner._plane.w_host_copies == 0,
          "adaptive 1000x100: a device-engine pass copied W to the host")
    check(dataclasses.asdict(planner._plane.stats)
          == dict(dataclasses.asdict(cplanner._plane.stats),
                  sweep_dispatches=planner._plane.stats.sweep_dispatches),
          "adaptive 1000x100: the card's plane did other work than the "
          "CPU run's")
    costs = []
    for p, t in ((planner, timer), (cplanner, ctimer)):
        check(t.last is not None, "adaptive 1000x100: no re-plan was made")
        costs.append(predicted_cost_quantile(t.last, p._plane.last_matrix,
                                             prob["nodes"], "minute",
                                             ADAPTIVE_COST_Q))
    check(costs[0] == costs[1],
          f"adaptive 1000x100: predicted_cost_quantile {costs[0]!r} on the "
          f"card, {costs[1]!r} on the CPU")
    n_re = got.n_reschedules
    rounds += 1 + n_re
    sweeps += planner._plane.stats.sweep_dispatches
    idle = [c for c, re in timer.completions if not re]
    idle_s = np.asarray([c["total_s"] for c in idle])
    idle_split = {k: float(np.median([c.get(k, 0.0) for c in idle]))
                  for k in COMPLETION_SPLIT}
    split = {k: float(np.median([r.get(k, 0.0) for r in timer.replans]))
             for k in ADAPTIVE_SPLIT + ("total_s",)}
    cpu_split = float(np.median([r["total_s"] for r in ctimer.replans]))
    cpu_idle = float(np.median([c["total_s"] for c, re in ctimer.completions
                                if not re]))
    print(f"[adaptive] 1000x100: {len(prob['dag'].tasks)} tasks, "
          f"{prob['n_slow']} stragglers x {ADAPTIVE_STRAGGLERS[1]}, "
          f"speculation {ADAPTIVE_SPEC}, cooldown {ADAPTIVE_COOLDOWN}: "
          f"makespan {float(got.makespan)!r} s, {n_re} re-plans in "
          f"{len(timer.completions)} completions, {got.n_backups} backups "
          f"({got.backup_waste_s!r} s wasted); {planner.stats}; identical "
          f"to the CPU run (records, makespan, counters, RescheduleStats); "
          f"predicted_cost_quantile(q={ADAPTIVE_COST_Q}, minute) "
          f"{costs[0]!r} on both")
    print(f"[adaptive] 1000x100 host clock: the whole run {host_s:.4f} s "
          f"on the card ({cpu_s:.4f} s on the CPU, numpy engine); a "
          f"completion without a re-plan median "
          f"{np.median(idle_s) * 1e3:.4f} ms (quartiles "
          f"{np.percentile(idle_s, 25) * 1e3:.4f}, "
          f"{np.percentile(idle_s, 75) * 1e3:.4f}; CPU "
          f"{cpu_idle * 1e3:.4f} ms); a re-plan median "
          f"{split['total_s'] * 1e3:.4f} ms (CPU numpy engine "
          f"{cpu_split * 1e3:.4f} ms)")
    print(f"[adaptive] 1000x100 completion split (medians over {len(idle)} "
          f"completions without a re-plan, ms, each piece synced): "
          + ", ".join(f"{k} {idle_split[k] * 1e3:.4f}"
                      for k in COMPLETION_SPLIT))
    print("[adaptive] 1000x100 re-plan split (medians over "
          f"{len(timer.replans)} re-plans, ms, each piece synced): "
          + ", ".join(f"{k} {split[k] * 1e3:.4f}" for k in ADAPTIVE_SPLIT))
    print(f"[adaptive] 1000x100 launches: bayes_predict {launched[0]}, "
          f"upward_rank {launched[1]}, eft_sweep {launched[2]} for "
          f"{1 + n_re} device rounds (the initial schedule and {n_re} "
          f"re-plans); PlaneStats card {planner._plane.stats}, CPU "
          f"{cplanner._plane.stats}; host copies of W "
          f"{planner._plane.w_host_copies}")
    check(planner._plane.stats.sweep_dispatches == 1 + n_re,
          "adaptive 1000x100: a device round retried its sweep")
    if dev.type == "cuda":
        check(launched[1] == launched[2] == 1 + n_re,
              "adaptive 1000x100: not one upward_rank and one eft_sweep "
              "launch per device round")
    return {"device_rounds": rounds, "sweeps": sweeps}


def tol_np(got, want, tol) -> tuple:
    """`tol_check` for float64 numpy arrays."""
    check(bool(np.isfinite(got).all()), "an output is not finite")
    diff = np.abs(got - want)
    return (float(diff.max()),
            float((diff / (tol["atol"] + tol["rtol"] * np.abs(want))).max()))


REFRESH_POLICY = dict(every_n=4)         # due at 4 or more completions
REFRESH_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_slice.py:41
REFRESH_SPLIT = ("due", "snapshot", "pad", "fit", "apply", "put_many",
                 "cursor")


def fleet_predictor(dev, post, ten: int):
    """Tenant `ten` of the refresh fleet: an `OnlinePredictor` on `dev`
    over the fleet posteriors of its N_FLEET / N_TENANTS rows."""
    from repro_torch.convert import predictor_from_state
    from repro_torch.online import OnlinePredictor
    per = N_FLEET // N_TENANTS
    rows = range(ten * per, (ten + 1) * per)
    return OnlinePredictor(predictor_from_state(fleet_state(post, rows),
                                                dev), device=dev)


def fleet_benches() -> dict:
    from repro_torch.core.microbench import simulate_microbench
    from repro_torch.sched.cluster import TARGET_MACHINES
    return {n.name: simulate_microbench(n, 1) for n in TARGET_MACHINES}


def refresh_fleet(dev, post, comps) -> dict:
    """The fleet's 65,536 posteriors as N_TENANTS tenants of
    N_FLEET / N_TENANTS tasks, each one `OnlinePredictor` on `dev`
    (`fleet_predictor`) bound to one store under tenant tNN / workflow
    "fleet", each fed its share of `comps` in one `observe_many`, then
    every binding synced in one generation (`sync_bindings`)."""
    from repro_torch.online import PredictionService
    from repro_torch.store import PosteriorStore
    per = N_FLEET // N_TENANTS
    store = PosteriorStore()
    benches = fleet_benches()
    shares = [[] for _ in range(N_TENANTS)]
    for c in comps:
        shares[int(c.task[4:]) // per].append(c)
    svcs = []
    t0 = time.perf_counter()
    for ten in range(N_TENANTS):
        pred = fleet_predictor(dev, post, ten)
        svcs.append(PredictionService(pred, benches, store=store,
                                      tenant=f"t{ten:02d}", workflow="fleet",
                                      device=dev))
    t1 = time.perf_counter()
    for svc, share in zip(svcs, shares):
        svc.predictor.observe_many(share)
    t2 = time.perf_counter()
    written = store.sync_bindings()
    t3 = time.perf_counter()
    return {"store": store, "svcs": svcs, "written": written,
            "times": {"bind_s": t1 - t0, "observe_s": t2 - t1,
                      "sync_bindings_s": t3 - t2}}


def phase_refresh(dev, fleet_out, ingest) -> dict:
    """The main path of the maintenance plane on the card: the refresh
    fleet (`refresh_fleet`), a `FusedPlane` over tenant t00 made resident,
    one `FleetRefresher.refresh()` (one bayes_fit launch, one store
    generation), then a plane round that re-predicts only the rows the
    publish dirtied.  The checks run after the launch counts are read."""
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.online import FleetRefresher, RefreshPolicy
    from repro_torch.sched.cluster import TARGET_MACHINES
    from repro_torch.sched.fused import FusedPlane
    fl = refresh_fleet(dev, fleet_out["fleet_post"], ingest["comps"])
    store, svc0 = fl["store"], fl["svcs"][0]
    rng = np.random.default_rng(31)
    tasks = svc0.predictor.task_names()
    plane = FusedPlane(svc0, TARGET_MACHINES[:4],
                       entries=[(t, t, float(rng.uniform(0.05, 4.0)))
                                for t in tasks])
    plane.matrix()
    gen0 = store.generation
    refresher = FleetRefresher(store, RefreshPolicy(**REFRESH_POLICY),
                               device=dev)
    fits0 = kernels.bayes_fit.launches
    report = refresher.refresh()
    fits = kernels.bayes_fit.launches - fits0
    torch.cuda.synchronize()
    dirty = int(store.snapshot().rows_changed_since(plane._keys, gen0).sum())
    before = (plane.stats.rows_refreshed, plane.stats.predict_dispatches,
              kernels.bayes_predict.launches)
    t0 = time.perf_counter()
    plane.matrix()
    torch.cuda.synchronize()
    plane_s = time.perf_counter() - t0
    after = (plane.stats.rows_refreshed - before[0],
             plane.stats.predict_dispatches - before[1],
             kernels.bayes_predict.launches - before[2])
    print(f"[refresh] fleet of {N_TENANTS} tenants x {N_FLEET // N_TENANTS} "
          f"tasks on the card: bind {fl['times']['bind_s']!r} s, "
          f"{N_TENANTS} observe_many {fl['times']['observe_s']!r} s, "
          f"sync_bindings ({fl['written']} rows, one generation) "
          f"{fl['times']['sync_bindings_s']!r} s")
    due = report.n_tasks + report.n_stale    # every due task is fitted
    print(f"[refresh] FleetRefresher.refresh(): due {due} tasks, published {report.n_tasks} in "
          f"{report.n_tenants} tenants, n_dispatches {report.n_dispatches}, "
          f"n_stale {report.n_stale}, bayes_fit launches {fits}, generation "
          f"{gen0} -> {report.generation}; {report.duration_s!r} s: "
          + ", ".join(f"{k} {report.split_s[k]!r}" for k in REFRESH_SPLIT))
    print(f"[refresh] plane over t00 after the publish: {dirty} of "
          f"{len(plane.uids)} rows in blocks the publish rewrote; rows "
          f"re-predicted {after[0]}, bayes_predict launches {after[2]}, "
          f"{plane_s!r} s")
    check(report.n_dispatches == 1 and fits == 1,
          "the refresh did not make exactly one bayes_fit launch")
    check(report.generation == gen0 + 1,
          "the refresh did not publish in exactly one store generation")
    check(report.n_tenants == N_TENANTS and report.n_stale == 0,
          "the refresh did not publish into every tenant")
    check(after[0] == dirty > 0 and after[1] == after[2] == 1,
          "the plane did not re-predict exactly the dirtied rows in one "
          "bayes_predict launch")
    keys = store.task_keys()        # the rows phase_refresh_checks reads:
    return {"report": report, "store": store, "svcs": fl["svcs"],   # the
            "keys": keys, "rows": store.gather(keys)}   # checkpoint phase
                                                        # writes the store


def phase_refresh_checks(dev, fleet_out, ingest, rf) -> None:
    """The same refresh on device="cpu" (the plain fit), against the
    card's: equal report counts and generation step, the synced rows
    bitwise before the refresh, and every store row after it within
    REFRESH_TOL (both fits are float32)."""
    from repro_torch.online import FleetRefresher, RefreshPolicy
    t0 = time.perf_counter()
    fl = refresh_fleet("cpu", fleet_out["fleet_post"], ingest["comps"])
    store = fl["store"]
    keys = store.task_keys()
    check(keys == rf["keys"], "refresh: the stores' keys differ")
    gen0 = store.generation
    report = FleetRefresher(store, RefreshPolicy(**REFRESH_POLICY),
                            device="cpu").refresh()
    got, want = rf["rows"], store.gather(keys)
    card = rf["report"]
    check((report.n_tasks, report.n_tenants, report.n_dispatches,
           report.n_stale, report.generation - gen0)
          == (card.n_tasks, card.n_tenants, card.n_dispatches, card.n_stale,
              1),
          "refresh: the card's report differs from the CPU run's")
    worst = {leaf: tol_np(got[leaf], want[leaf], REFRESH_TOL)
             for leaf in want}
    kernel = {leaf: tol_np(got[leaf], want[leaf], FIT_TOL)[1]
              for leaf in want}
    print(f"[refresh] against the same refresh on the CPU (plain fit, "
          f"{report.duration_s!r} s; this check {time.perf_counter() - t0!r} "
          f"s): report equal; per leaf (max |err|, tol_ratio at rtol "
          f"{REFRESH_TOL['rtol']} / atol {REFRESH_TOL['atol']}): {worst}; "
          f"tol_ratio at the kernel's 5e-3/5e-4: {kernel}")
    check(max(r for _, r in worst.values()) <= 1.0,
          "refresh: the card's refreshed rows are not within rtol 1e-4 / "
          "atol 1e-5 of the CPU run's")


CKPT_QUERIES = 256               # a tenant's seeded query set
CKPT_INGEST = 250                # completions in the ingest batch, on
CKPT_INGEST_TENANTS = 4          # random tasks of t00-t03 (8 blocks)
CKPT_MIGRATE = 8                 # tenants moved by export_namespaces
CKPT_DUE_TASKS = 256             # tasks a migrated tenant has due
FE_QUERIES, FE_CALLERS, FE_ROUNDS = 4096, 16, 5   # service_throughput.py
FE_WINDOW_S = 0.002
_CARD = []


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    if not _CARD:
        _CARD.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])
    return _CARD[0]


def disk_bytes(path: str, names=None) -> tuple:
    """(bytes of block files, bytes of the manifest) in `path`, of the
    files `names` only when given."""
    blocks = man = 0
    for f in os.listdir(path):
        if names is not None and f not in names:
            continue
        size = os.path.getsize(os.path.join(path, f))
        if f == "manifest.json":
            man += size
        elif f.endswith(".npz"):
            blocks += size
    return blocks, man


def ckpt_queries(rng: np.random.Generator, tasks) -> list:
    """CKPT_QUERIES seeded queries of one tenant, on the target machines
    and the local one."""
    from repro_torch.online import PredictionQuery
    from repro_torch.sched.cluster import TARGET_MACHINES
    nodes = [None] + [m.name for m in TARGET_MACHINES]
    return [PredictionQuery(tasks[int(rng.integers(0, len(tasks)))],
                            nodes[int(rng.integers(0, len(nodes)))],
                            float(rng.uniform(0.05, 12.0)))
            for _ in range(CKPT_QUERIES)]


def ckpt_dag(rng: np.random.Generator, tasks):
    """`replan_dag`'s random DAG over one tenant's fleet tasks (task i
    runs fleet task i)."""
    from repro_torch.workflow.dag import TaskInstance, WorkflowDAG
    dag = WorkflowDAG("ckpt")
    for i, name in enumerate(tasks):
        deps = [f"t{j}" for j in range(i)
                if rng.random() < min(3.0 / max(i, 1), 0.5)]
        dag.add(TaskInstance(f"t{i}", name, "ckpt",
                             float(rng.uniform(0.05, 4.0)),
                             output_gb=float(rng.uniform(0.0, 2.0)),
                             deps=deps))
    return dag


def resume_fleet(dev, post, store, tens) -> tuple:
    """Fresh fleet predictors of tenants `tens`, built as `refresh_fleet`
    builds them, resumed on `store`, and their services: (services,
    build seconds, resume seconds)."""
    from repro_torch.online import PredictionService
    benches = fleet_benches()
    t0 = time.perf_counter()
    preds = {ten: fleet_predictor(dev, post, ten) for ten in tens}
    t1 = time.perf_counter()
    for ten, pred in preds.items():
        store.resume(f"t{ten:02d}", "fleet", pred, benches)
    t2 = time.perf_counter()
    svcs = {ten: PredictionService(pred, benches, store=store,
                                   tenant=f"t{ten:02d}", workflow="fleet",
                                   device=dev)
            for ten, pred in preds.items()}
    return svcs, t1 - t0, t2 - t1


def answers(svcs, qsets, tens) -> tuple:
    """({tenant: predict_batch of its query set}, seconds taken)."""
    t0 = time.perf_counter()
    out = {ten: svcs[ten].predict_batch(qsets[ten]) for ten in tens}
    return out, time.perf_counter() - t0


def all_equal(got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(
        np.array_equal(got[k], want[k]) for k in want)


def ckpt_ingest(rng: np.random.Generator, svcs) -> tuple:
    """CKPT_INGEST local completions on random tasks of the first
    CKPT_INGEST_TENANTS tenants, one `observe_many` a tenant: (tenants
    touched, seconds)."""
    from repro_torch.online import TaskCompletion
    per = N_FLEET // N_TENANTS
    idx = rng.integers(0, CKPT_INGEST_TENANTS * per, CKPT_INGEST)
    x = rng.uniform(0.5, 6.0, CKPT_INGEST)
    y = (5.0 + 30.0 * x) * (1.0 + rng.normal(0.0, 0.05, CKPT_INGEST))
    by = {}
    for k, (i, a, b) in enumerate(zip(idx.tolist(), x.tolist(),
                                      y.tolist())):
        by.setdefault(i // per, []).append(TaskCompletion(
            "fleet", f"ck{k}", f"task{i:05d}", "local", a, b))
    t0 = time.perf_counter()
    for ten, comps in by.items():
        svcs[ten].predictor.observe_many(comps)
    return sorted(by), time.perf_counter() - t0


def fe_chunks(rng: np.random.Generator, tasks_of) -> list:
    """benchmarks/service_throughput.py's 4,096 queries (random task,
    target machine and input in 0.05-12 GB) in 16 callers' chunks, for
    FE_ROUNDS rounds: caller c of round r asks tenant (c + 16 r) mod 64,
    so the 80 caller batches cover every tenant."""
    from repro_torch.online import PredictionQuery
    from repro_torch.sched.cluster import TARGET_MACHINES
    nodes = [m.name for m in TARGET_MACHINES]
    chunk = FE_QUERIES // FE_CALLERS
    out = []
    for r in range(FE_ROUNDS):
        row = []
        for c in range(FE_CALLERS):
            ten = (c + FE_CALLERS * r) % N_TENANTS
            tasks = tasks_of[ten]
            row.append((ten, [PredictionQuery(
                tasks[int(rng.integers(0, len(tasks)))],
                nodes[int(rng.integers(0, len(nodes)))],
                float(rng.uniform(0.05, 12.0))) for _ in range(chunk)]))
        out.append(row)
    return out


def fe_rounds(fe, chunks) -> tuple:
    """FE_ROUNDS rounds of FE_CALLERS threads through the auto-flushing
    `fe`, as benchmarks/service_throughput.py drives it: (every caller's
    answers, seconds, dispatches)."""
    from concurrent.futures import ThreadPoolExecutor
    got = []
    d0 = fe.dispatch_count
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=FE_CALLERS) as pool:
        for row in chunks:
            futs = list(pool.map(lambda tq: fe.predict_async(
                tq[1], tenant=f"t{tq[0]:02d}", workflow="fleet"), row))
            got.append([f.result(timeout=60) for f in futs])
    return got, time.perf_counter() - t0, fe.dispatch_count - d0


def same_answers(got, quiet) -> bool:
    return all(np.array_equal(g, q) for gr, qr in zip(got, quiet)
               for g, q in zip(gr, qr))


def fe_manual(dev, store, row) -> tuple:
    """One manual flush of FE_CALLERS callers submitted at once: (their
    answers, flush seconds, bayes_predict launches, the launches' Q)."""
    import threading
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import ops
    from repro_torch.store import AsyncPredictionFrontend
    fe = AsyncPredictionFrontend(store, device=dev, auto_flush=False)
    futs = [None] * len(row)
    barrier = threading.Barrier(len(row))

    def submit(c):
        ten, qs = row[c]
        barrier.wait()
        futs[c] = fe.predict_async(qs, tenant=f"t{ten:02d}",
                                   workflow="fleet")

    threads = [threading.Thread(target=submit, args=(c,))
               for c in range(len(row))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    qs_seen = []
    dispatch = ops.bayes_predict
    ops.bayes_predict = lambda b: qs_seen.append(b.q) or dispatch(b)
    try:
        l0 = kernels.bayes_predict.launches
        t0 = time.perf_counter()
        flushed = fe.flush()
        if fe.device.type == "cuda":
            torch.cuda.synchronize(fe.device)
        flush_s = time.perf_counter() - t0
        launched = kernels.bayes_predict.launches - l0
    finally:
        ops.bayes_predict = dispatch
    fe.close()
    check(flushed == len(row) and fe.dispatch_count == 1
          and fe.coalesced == [len(row)],
          f"frontend: a manual flush answered {flushed} of {len(row)} "
          f"callers in {fe.dispatch_count} dispatches")
    return [f.result(timeout=60) for f in futs], flush_s, launched, qs_seen


def due_stream(rng: np.random.Generator, svcs, tens) -> int:
    """Four local completions on each of the first CKPT_DUE_TASKS tasks
    of tenants `tens` (due at every_n = 4), one `observe_many` a tenant;
    returns the completions fed."""
    from repro_torch.online import TaskCompletion
    n = 0
    for ten in tens:
        tasks = svcs[ten].predictor.task_names()[:CKPT_DUE_TASKS]
        xs = rng.uniform(0.5, 6.0, (len(tasks), 4))
        comps = [TaskCompletion("fleet", f"due{ten}-{i}-{j}", t, "local",
                                float(xs[i, j]), float(5.0 + 20.0 * xs[i, j]))
                 for i, t in enumerate(tasks) for j in range(4)]
        svcs[ten].predictor.observe_many(comps)
        n += len(comps)
    return n


def phase_checkpoint(dev, fleet_out, rf) -> dict:
    """The store's durability and shipping and the batch-window frontend
    on the refresh fleet (`phase_refresh`'s store: 64 tenants x 1,024
    tasks, 65,536 rows of 88 bytes in 128 blocks of 512), on `dev`.  The
    checkpoints live in one temporary directory, removed at the end."""
    import shutil
    import tempfile
    import threading
    import torch
    from repro_torch.core.microbench import run_local_microbench
    from repro_torch.online import FleetRefresher, RefreshPolicy
    from repro_torch.sched.cluster import TARGET_MACHINES
    from repro_torch.sched.fused import FusedPlane
    from repro_torch.store import AsyncPredictionFrontend, PosteriorStore
    from repro_torch.store.compute import predict_stacked
    from repro_torch.workflow.simulator import random_cluster
    store, svcs = rf["store"], dict(enumerate(rf["svcs"]))
    post = fleet_out["fleet_post"]
    tens = list(range(N_TENANTS))
    tasks_of = {ten: svcs[ten].predictor.task_names() for ten in tens}
    rng = np.random.default_rng(43)
    qsets = {ten: ckpt_queries(rng, tasks_of[ten]) for ten in tens}
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="lotaru-ckpt-")
    try:
        # --- 1. full save, restart: the same answers and schedule -------
        before, _ = answers(svcs, qsets, tens)
        dag = ckpt_dag(rng, tasks_of[0])
        nodes = random_cluster(rng, list(TARGET_MACHINES),
                               n_nodes=PLAN_NODES)
        sched0 = FusedPlane(svcs[0], nodes, dag=dag).schedule(
            dag, quantile=PLAN_QUANTILE, engine="device")
        path = tempfile.mkdtemp(dir=root)
        t0 = time.perf_counter()
        store.save(path)
        save_s = time.perf_counter() - t0
        g_full = store.generation
        n_full = len(store.last_checkpoint_blocks)
        full_bytes = disk_bytes(path)
        t0 = time.perf_counter()
        restored = PosteriorStore.restore(path)
        restore_s = time.perf_counter() - t0
        keys = store.task_keys()
        rows0 = store.gather(keys)

        def same_rows(s) -> bool:
            got = s.gather(keys)
            return all(np.array_equal(got[k], v) for k, v in rows0.items())

        check(same_rows(restored),
              "checkpoint: the restored rows differ from the saved ones")
        rsvcs, build_s, resume_s = resume_fleet(dev, post, restored, tens)
        gen = restored.generation
        after, first_s = answers(rsvcs, qsets, tens)
        restacked = restored.generation - gen
        check(all_equal(after, before),
              "checkpoint: predictions after restore and resume are not "
              "bitwise the pre-restart ones")
        check(same_rows(restored) and restacked == N_TENANTS,
              f"checkpoint: resume restacked in {restacked} generations, "
              f"or rows other than the checkpoint's")
        plane = FusedPlane(rsvcs[0], nodes, dag=dag)
        sched1 = plane.schedule(dag, quantile=PLAN_QUANTILE, engine="device")
        cold = plane.stats.rows_refreshed
        plane.schedule(dag, quantile=PLAN_QUANTILE, engine="device")
        check(same_schedule(sched1, sched0),
              "checkpoint: the plane's schedule on the restored store "
              "differs from the one before the restart")
        check(cold == len(plane.uids) == plane.stats.rows_refreshed,
              "checkpoint: the plane over the restored store did not "
              "re-predict every row once, then none")
        print(f"[checkpoint] full save of {len(keys)} rows in {n_full} "
              f"blocks of {store.block_size} ({N_TENANTS} tenants): save "
              f"{save_s!r} s, {full_bytes[0]} bytes of blocks + "
              f"{full_bytes[1]} bytes of manifest; restore {restore_s!r} "
              f"s; {N_TENANTS} fresh predictors {build_s!r} s, resume "
              f"{resume_s!r} s; first predict after resume ({N_TENANTS} x "
              f"{CKPT_QUERIES} queries, each namespace restacked in one "
              f"put_many) {first_s!r} s ({card()})")
        print(f"[checkpoint] restart: {N_TENANTS} x {CKPT_QUERIES} answers "
              f"and all rows bitwise; plane over t00 ({len(plane.uids)} "
              f"tasks x {len(nodes)} nodes, device engine) schedule "
              f"identical, rows re-predicted {cold} cold and 0 warm")

        # --- 2. replica bootstrap, then an ingest batch and an -----------
        # --- incremental save with retention --------------------------
        replica = PosteriorStore()
        t0 = time.perf_counter()
        boot = store.export_blocks(-1)
        t1 = time.perf_counter()
        replica.import_blocks(boot)
        boot_s = (t1 - t0, time.perf_counter() - t1)
        g_boot = store.generation
        touched, ingest_s = ckpt_ingest(rng, svcs)
        store.sync_bindings()
        moved = sorted(i for i, g in store._block_gen.items() if g > g_boot)
        some = touched + [N_TENANTS - 1]
        mid, _ = answers(svcs, qsets, some)
        t0 = time.perf_counter()
        store.save(path, incremental=True, keep_last=2)
        inc_s = time.perf_counter() - t0
        written = list(store.last_checkpoint_blocks)
        inc_bytes = disk_bytes(path, {f"block_{i}.npz" for i in written}
                               | {"manifest.json"})
        check(written == moved and 0 < len(moved) < store.num_blocks,
              f"checkpoint: the incremental save wrote blocks {written}, "
              f"not exactly the moved ones {moved}")
        old = PosteriorStore.restore(path, generation=g_full)
        osvcs, _, _ = resume_fleet(dev, post, old, some)
        check(all_equal(answers(osvcs, qsets, some)[0],
                        {t: before[t] for t in some}),
              "checkpoint: restore(generation=<the full save>) does not "
              "answer the pre-ingest predictions")
        live = PosteriorStore.restore(path)
        lsvcs, _, _ = resume_fleet(dev, post, live, some)
        check(all_equal(answers(lsvcs, qsets, some)[0], mid),
              "checkpoint: the live checkpoint does not answer the "
              "post-ingest predictions")
        print(f"[checkpoint] ingest of {CKPT_INGEST} completions in "
              f"tenants {touched} ({ingest_s!r} s), one sync_bindings "
              f"generation: blocks moved {moved} ({len(moved)} of "
              f"{store.num_blocks}); incremental save keep_last=2 "
              f"{inc_s!r} s wrote exactly them, {inc_bytes[0]} bytes of "
              f"blocks + {inc_bytes[1]} bytes of manifest; "
              f"restore(generation={g_full}) answers the pre-ingest "
              f"predictions bitwise, the live checkpoint the post-ingest "
              f"ones ({card()})")

        # --- 3. the replica's delta --------------------------------------
        t0 = time.perf_counter()
        delta = store.export_blocks(g_boot)
        t1 = time.perf_counter()
        replica.import_blocks(delta)
        delta_s = (t1 - t0, time.perf_counter() - t1)
        shipped = sorted(int(i) for i in delta["blocks"])
        check(shipped == moved,
              f"replica: the delta shipped blocks {shipped}, not the moved "
              f"ones {moved}")
        x = rng.uniform(0.05, 12.0, len(keys))
        psnap, rsnap = store.snapshot(), replica.snapshot()
        mp, sp = predict_stacked(x, lambda out: psnap.gather(keys, out),
                                 device=dev)
        mr, sr = predict_stacked(x, lambda out: rsnap.gather(keys, out),
                                 device=dev)
        check(np.array_equal(mp, mr) and np.array_equal(sp, sr),
              "replica: predict_stacked on the replica is not bitwise the "
              "primary's")
        nb = lambda p: sum(a.nbytes for blk in p["blocks"].values()
                           for a in blk.values())
        print(f"[checkpoint] replica: bootstrap export_blocks(-1) "
              f"{len(boot['blocks'])} blocks, {nb(boot)} bytes, export "
              f"{boot_s[0]!r} s, import {boot_s[1]!r} s; delta after the "
              f"ingest {len(shipped)} blocks, {nb(delta)} bytes, export "
              f"{delta_s[0]!r} s, import {delta_s[1]!r} s; predict_stacked "
              f"of all {len(keys)} rows on the card bitwise the primary's "
              f"({card()})")

        # --- 4. migration into a live store holding other rows -----------
        dst = PosteriorStore()
        for k in (0, 1):
            dst.bind(f"x{k:02d}", "fleet", fleet_predictor(dev, post, k),
                     fleet_benches())
        other = len(dst)
        moving = list(range(N_TENANTS - CKPT_MIGRATE, N_TENANTS))
        t0 = time.perf_counter()
        payload = store.export_namespaces([f"t{t:02d}/fleet"
                                           for t in moving])
        t1 = time.perf_counter()
        n_in = dst.import_namespaces(payload)
        mig_s = (t1 - t0, time.perf_counter() - t1)
        msvcs, _, mres_s = resume_fleet(dev, post, dst, moving)
        check(all_equal(answers(msvcs, qsets, moving)[0],
                        answers(svcs, qsets, moving)[0]),
              "migration: predictions after import_namespaces and resume "
              "are not bitwise the source's")
        print(f"[checkpoint] migration: export_namespaces of "
              f"{CKPT_MIGRATE} tenants ({len(payload['keys'])} rows) "
              f"{mig_s[0]!r} s, import_namespaces into a live store "
              f"holding {other} other rows ({n_in} rows) {mig_s[1]!r} s, "
              f"resume {mres_s!r} s; answers bitwise the source's "
              f"({card()})")

        # --- 5. the frontend: manual, auto-flush, under load -------------
        chunks = fe_chunks(rng, tasks_of)
        quiet = [[svcs[ten].predict_batch(qs) for ten, qs in row]
                 for row in chunks]
        manual, flush_s, launched, qs_seen = fe_manual(dev, store,
                                                       chunks[0])
        on_card = torch.device(dev).type == "cuda"
        check(launched == int(on_card) and qs_seen == [FE_QUERIES],
              f"frontend: a manual flush made {launched} bayes_predict "
              f"launches at Q {qs_seen}, not one at Q = {FE_QUERIES}")
        check(same_answers([manual], quiet[:1]),
              "frontend: a manual flush's answers are not bitwise "
              "predict_batch's")
        print(f"[frontend] manual: {FE_CALLERS} callers x "
              f"{FE_QUERIES // FE_CALLERS} queries of {FE_CALLERS} tenants, "
              f"one flush {flush_s!r} s, bayes_predict launches {launched} "
              f"at Q = {qs_seen[0]}; answers bitwise predict_batch "
              f"({card()})")
        n_batches = FE_ROUNDS * FE_CALLERS
        with AsyncPredictionFrontend(store, device=dev,
                                     window_s=FE_WINDOW_S) as fe:
            got, auto_s, auto_d = fe_rounds(fe, chunks)
        check(same_answers(got, quiet) and auto_d < n_batches,
              f"frontend: the auto-flush rounds' answers are not bitwise "
              f"predict_batch's, or {auto_d} dispatches for {n_batches} "
              f"caller batches")
        # under load: predict_batch on this thread, and a refresher (on
        # its own thread) fitting due tasks of the migrated store
        fed = due_stream(np.random.default_rng(47), msvcs, moving)
        refresher = FleetRefresher(dst, RefreshPolicy(**REFRESH_POLICY),
                                   device=dev)
        due = len(refresher.due())
        ok, n_main, out = True, 0, {}
        with AsyncPredictionFrontend(store, device=dev, window_s=FE_WINDOW_S,
                                     refresher=refresher,
                                     refresh_interval_s=0.01) as fe:
            th = threading.Thread(target=lambda: out.update(
                zip(("got", "s", "d"), fe_rounds(fe, chunks))))
            th.start()
            while th.is_alive() or n_main < n_batches:
                r, c = divmod(n_main % n_batches, FE_CALLERS)
                ten, qs = chunks[r][c]
                ok &= np.array_equal(svcs[ten].predict_batch(qs),
                                     quiet[r][c])
                n_main += 1
            th.join()
        check(same_answers(out["got"], quiet) and ok
              and out["d"] < n_batches,
              "frontend: under the main thread's predict_batch and the "
              "refresher, an answer is not bitwise the quiet run's")
        check(refresher.dispatch_count >= 1 and refresher.failure_count == 0
              and sum(r.n_tasks for r in refresher.reports) == due > 0,
              f"frontend: the attached refresher did not fit the {due} due "
              f"tasks ({refresher.dispatch_count} fits, "
              f"{refresher.failure_count} failures)")
        print(f"[frontend] auto-flush (window {FE_WINDOW_S} s): "
              f"{FE_ROUNDS} rounds x {FE_CALLERS} threads x "
              f"{FE_QUERIES // FE_CALLERS} queries over {N_TENANTS} "
              f"tenants: {FE_ROUNDS * FE_QUERIES / auto_s!r} queries/s "
              f"({auto_s!r} s), {auto_d} dispatches for {n_batches} caller "
              f"batches; under load (predict_batch x {n_main} on the main "
              f"thread, an attached FleetRefresher fitting {due} due "
              f"tasks of the migrated store ({fed} completions) in "
              f"{refresher.dispatch_count} bayes_fit launch(es)): "
              f"{FE_ROUNDS * FE_QUERIES / out['s']!r} queries/s, "
              f"{out['d']} dispatches; every answer bitwise the quiet "
              f"run's ({card()})")

        # --- 6. the real probes ------------------------------------------
        mb = run_local_microbench(device=dev)
        vals = (mb.cpu, mb.mem, mb.io_read, mb.io_write)
        check(all(np.isfinite(v) and v > 0 for v in vals),
              f"probes: run_local_microbench read {vals}")
        print(f"[checkpoint] probes: run_local_microbench(device={dev}): "
              f"float32 matmul n=512 {mb.cpu!r} GFLOP/s, stream "
              f"{mb.mem!r} GB/s, file write {mb.io_write!r} MB/s, read "
              f"{mb.io_read!r} MB/s ({card()})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[checkpoint] the phase took {time.perf_counter() - t_phase!r} s "
          f"({card()})")
    return {"moved": moved, "schedules": 3}


SERVE_SHARDS = ("s0", "s1", "s2")
SERVE_ADDED = "s3"               # joins, then leaves, under traffic
SERVE_INGEST_BATCHES, SERVE_INGEST_BATCH = 8, 250
SERVE_REPLICA_LAG = 1            # the replica's max_generation_lag
SERVE_RESHARD_TENANTS = 4        # moving and staying tenants the observe
                                 # worker writes to during a rebalance
SERVE_FAILOVER_BATCHES = 2       # observe_many batches before and after
                                 # the subprocess tier's checkpoint
SERVE_FLEET_ENV = "CHIP_SMOKE_SERVE_FLEET"   # the fleet posterior (npz)
SERVE_READY_S = 30.0             # a failover's limit from SIGKILL to READY
SERVE_BOOTSTRAP = "chip_smoke:serve_bootstrap"
_SERVE_POST = {}


def fleet_specs(dev, post, shard_id, shard_map) -> dict:
    """The refresh fleet's namespaces that `shard_map` places on
    `shard_id`: tenant tNN / workflow "fleet" -> (a fresh `fleet_predictor`
    on `dev`, the target machines' benches).  A shard's bootstrap: boot
    binds them, an install resumes the migrated ones off shipped
    states."""
    benches = fleet_benches()
    return {(f"t{ten:02d}", "fleet"): (fleet_predictor(dev, post, ten),
                                       benches)
            for ten in range(N_TENANTS)
            if shard_map.shard_for(f"t{ten:02d}/fleet") == shard_id}


def serve_bootstrap(shard_id, shard_map) -> dict:
    """The bootstrap of the failover step's shard processes (`python -m
    repro_torch.serve.shard --bootstrap chip_smoke:serve_bootstrap`): the
    fleet posterior the parent wrote to the npz that $CHIP_SMOKE_SERVE_FLEET
    names, its predictors on the card."""
    import torch
    path = os.environ[SERVE_FLEET_ENV]
    if path not in _SERVE_POST:
        with np.load(path) as z:
            _SERVE_POST[path] = {k: z[k] for k in z.files}
    return fleet_specs(torch.device("cuda"), _SERVE_POST[path], shard_id,
                       shard_map)


def serve_completion(rng: np.random.Generator, ten: int, task: str,
                     k: int) -> tuple:
    """One local completion of tenant `ten`'s `task`: (ten, completion)."""
    from repro_torch.online import TaskCompletion
    x = float(rng.uniform(0.5, 6.0))
    return ten, TaskCompletion(
        "fleet", f"sv{rng.integers(1 << 40)}-{k}", task, "local", x,
        float((5.0 + 30.0 * x) * (1.0 + rng.normal(0.0, 0.05))))


def serve_completions(rng: np.random.Generator, n: int, tens) -> list:
    """n local completions on random tasks of tenants `tens`:
    [(tenant index, completion)]."""
    per = N_FLEET // N_TENANTS
    tens = list(tens)
    out = []
    for k in range(n):
        ten = tens[int(rng.integers(0, len(tens)))]
        i = ten * per + int(rng.integers(0, per))
        out.append(serve_completion(rng, ten, f"task{i:05d}", k))
    return out


class ServeRefs:
    """In-process `PredictionService`s on the card over fresh fleet
    predictors: the tier's answers are held against them bitwise, and
    they are fed every completion the tier acknowledged, in order, so
    that their `state_digest` is what the tier's must be."""

    def __init__(self, dev, post):
        fleet = refresh_fleet(dev, post, [])
        self.store = fleet["store"]
        self.svcs = dict(enumerate(fleet["svcs"]))

    def feed(self, acked) -> None:
        """acked: [(tenant index, completion)] in acknowledgement order."""
        by = {}
        for ten, comp in acked:
            by.setdefault(ten, []).append(comp)
        for ten, comps in by.items():
            self.svcs[ten].predictor.observe_many(comps)

    def digest(self, ten: int) -> str:
        from repro_torch.serve import state_digest
        return state_digest(self.svcs[ten].predictor)

    def same(self, ten: int, qs, got) -> bool:
        want = self.svcs[ten].predict_batch(qs)
        return got.dtype == want.dtype and np.array_equal(got, want)


async def serve_predict_rounds(client, refs, rounds) -> tuple:
    """`fe_chunks`' rounds through the client, every caller of a round
    at once, each one `predict_many`: (seconds,
    each call's latency, queries, every answer bitwise refs', each
    round's seconds)."""
    import asyncio
    lat, ok, n_q = [], True, 0

    async def worker(ten, qs):
        t0 = time.perf_counter()
        got = await client.predict_many([(f"t{ten:02d}", "fleet", qs)])
        lat.append(time.perf_counter() - t0)
        return got[0]

    t0 = time.perf_counter()
    outs, rounds_s = [], []
    for row in rounds:
        t1 = time.perf_counter()
        outs.append(await asyncio.gather(*[worker(*c) for c in row]))
        rounds_s.append(time.perf_counter() - t1)
    secs = time.perf_counter() - t0
    for row, got in zip(rounds, outs):
        for (ten, qs), arr in zip(row, got):
            ok &= refs.same(ten, qs, arr)
            n_q += len(qs)
    return secs, lat, n_q, ok, rounds_s


async def serve_observe(client, items) -> tuple:
    """One `observe_many` of [(tenant index, completion)]: (acks, seconds)."""
    t0 = time.perf_counter()
    seqs = await client.observe_many(
        [(c, f"t{ten:02d}", "fleet") for ten, c in items])
    return seqs, time.perf_counter() - t0


async def serve_tier(dev, post, root) -> dict:
    """Steps 1-4 of `phase_serve`, in one event loop: three in-process
    shards on `dev` and the port's client; the replica; the rebalance."""
    import asyncio
    import tempfile
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.online import (FleetRefresher, PredictionQuery,
                                    RefreshPolicy)
    from repro_torch.sched.cluster import TARGET_MACHINES
    from repro_torch.serve import (MigratingError, PartialObserveError,
                                   RebalanceCoordinator, ReplicaServer,
                                   ReplicaShipper, ReplicaStaleError,
                                   RetryPolicy, ServingClient, ShardInfo,
                                   ShardMap, ShardServer, WrongShardError,
                                   boot_shard, call_direct, wire)
    from repro_torch.store import PosteriorStore, QueueFullError
    from repro_torch.store.compute import predict_stacked
    boot = lambda sid, m: fleet_specs(dev, post, sid, m)
    host = "127.0.0.1"
    rng = np.random.default_rng(53)
    out = {}
    shipped = []            # (install frame bytes, payload) of each ship

    class KeptShipper(ReplicaShipper):
        async def _ship_to(self, addr, payload):
            n = await super()._ship_to(addr, payload)
            shipped.append((self.frame_bytes.get(addr), payload))
            return n

    def shard_opts():
        return dict(checkpoint_dir=tempfile.mkdtemp(dir=root),
                    oplog_path=os.path.join(tempfile.mkdtemp(dir=root),
                                            "oplog"),
                    window_s=FE_WINDOW_S, ingest_window_s=FE_WINDOW_S,
                    device=dev)

    # --- 1. serve ---------------------------------------------------------
    t0 = time.perf_counter()
    refs = ServeRefs(dev, post)
    refs_s = time.perf_counter() - t0
    m = ShardMap([ShardInfo(s, host, 0) for s in SERVE_SHARDS])
    servers = {}
    t0 = time.perf_counter()
    for sid in SERVE_SHARDS:
        srv = boot_shard(sid, m, boot, **shard_opts())
        await srv.start()
        m = m.with_address(sid, host, srv.port)
        servers[sid] = srv
    for srv in servers.values():
        srv.map = m
    cold_s = time.perf_counter() - t0
    owned = {sid: len(s.store.bindings()) - 1 for sid, s in servers.items()}
    check(sum(owned.values()) == N_TENANTS and all(owned.values()),
          f"serve: the shards bound {owned} tenants, not all "
          f"{N_TENANTS} spread over {len(SERVE_SHARDS)}")
    client = ServingClient(m, RetryPolicy(max_attempts=12))
    clients, others = [client], []             # closed at the end
    try:
        tasks_of = {ten: refs.svcs[ten].predictor.task_names()
                    for ten in range(N_TENANTS)}
        secs, lat, n_q, ok, rounds_s = await serve_predict_rounds(
            client, refs, fe_chunks(rng, tasks_of))
        check(ok, "serve: a predict_many answer is not bitwise the "
                  "in-process predict_batch's")
        x = rng.uniform(0.05, 12.0, len(tasks_of[0]))
        mtasks = list(zip(tasks_of[0], x.tolist()))
        nodes = [mm.name for mm in TARGET_MACHINES]
        t0 = time.perf_counter()
        mean, std = await client.predict_matrix("t00", "fleet", mtasks,
                                                nodes)
        matrix_s = time.perf_counter() - t0
        wm, ws = refs.svcs[0].predict_matrix(mtasks, nodes)
        check(np.array_equal(mean, wm) and np.array_equal(std, ws),
              "serve: predict_matrix over the wire is not bitwise the "
              "in-process PredictionService.predict_matrix")
        print(f"[serve] {len(SERVE_SHARDS)} shards on the card "
              f"({owned} tenants of {N_FLEET // N_TENANTS} tasks), codec "
              f"{'json+base64' if wire.msgpack is None else 'msgpack'} "
              f"(wire.msgpack is None: {wire.msgpack is None}); cold boot "
              f"{cold_s!r} s, the in-process references {refs_s!r} s "
              f"({card()})")
        print(f"[serve] {FE_ROUNDS} rounds x {FE_CALLERS} workers' "
              f"predict_many ({FE_QUERIES // FE_CALLERS} queries of a "
              f"tenant): {n_q / secs!r} predictions/s ({n_q} in {secs!r} "
              f"s), a call p50 {float(np.percentile(lat, 50)) * 1e3!r} ms "
              f"p99 {float(np.percentile(lat, 99)) * 1e3!r} ms; rounds "
              f"{[round(r, 4) for r in rounds_s]} s; predict_matrix of t00 "
              f"({len(mtasks)} x {len(nodes)}) "
              f"{matrix_s * 1e3!r} ms; every answer bitwise "
              f"PredictionService.predict_batch / predict_matrix ({card()})")

        # --- 2. ingest and durability -----------------------------------
        acked, ack_s, by_shard = [], [], {}
        for _ in range(SERVE_INGEST_BATCHES):
            items = serve_completions(rng, SERVE_INGEST_BATCH,
                                      range(N_TENANTS))
            seqs, s = await serve_observe(client, items)
            ack_s.append(s)
            acked += items
            for (ten, _), q in zip(items, seqs):
                by_shard.setdefault(m.shard_for(f"t{ten:02d}/fleet"),
                                    []).append(q)
        check(all(sorted(q) == list(range(1, len(q) + 1))
                  for q in by_shard.values()),
              "ingest: a shard's acks are not its dense oplog seqs 1..n")
        health = {sid: await client.health(sid) for sid in SERVE_SHARDS}
        drains = {sid: (h["ingest"]["batches"],
                        h["ingest"]["generations_published"],
                        h["ingest"]["flushes"], h["seq"])
                  for sid, h in health.items()}
        check(all(d[0] >= 1 and d[0] == d[1] and d[3] == len(by_shard[sid])
                  for sid, d in drains.items()),
              f"ingest: health does not show one COW generation a drain "
              f"and every ack applied (drains, generations, flushes, seq: "
              f"{drains})")
        refs.feed(acked)
        touched = sorted({ten for ten, _ in acked})
        bad = [ten for ten in touched
               if await client.digest(f"t{ten:02d}", "fleet")
               != refs.digest(ten)]
        check(not bad, f"ingest: the digests of tenants {bad} over the wire "
                       f"differ from in-process predictors fed the same "
                       f"completions")
        _, _, n2, ok, _ = await serve_predict_rounds(
            client, refs, fe_chunks(rng, tasks_of)[:1])
        check(ok, "ingest: a prediction after the ingest is not bitwise "
                  "the in-process predict_batch's")
        n_acks = SERVE_INGEST_BATCHES * SERVE_INGEST_BATCH
        print(f"[serve] ingest: {SERVE_INGEST_BATCHES} observe_many x "
              f"{SERVE_INGEST_BATCH} completions: {n_acks / sum(ack_s)!r} "
              f"acks/s (a batch p50 {float(np.percentile(ack_s, 50)) * 1e3!r} "
              f"ms); acks "
              f"dense per shard; shards' (drains, generations, oplog "
              f"flushes, seq) {drains}; {len(touched)} tenants' digests "
              f"equal in-process predictors fed the same completions; "
              f"{n2} predictions after it bitwise ({card()})")
        # queue_full round-trips; a stale map heals from wrong_shard
        mq = ShardMap([ShardInfo("sq", host, 0)])
        sq = ShardServer("sq", mq, store=PosteriorStore(), window_s=0.5,
                         max_pending_batches=1, device=dev)
        others.append(sq)
        sq.store.bind("t00", "fleet", fleet_predictor(dev, post, 0),
                      fleet_benches())
        await sq.start()
        sq.map = mq = mq.with_address("sq", host, sq.port)
        qc = ServingClient(mq, RetryPolicy(max_attempts=2,
                                           base_backoff_s=0.01))
        clients.append(qc)
        qs = [(tasks_of[0][0], None, 1.0)]
        first = asyncio.ensure_future(qc.predict(qs, "t00", "fleet"))
        await asyncio.sleep(0.05)
        try:
            await asyncio.gather(*[qc.predict(qs, "t00", "fleet")
                                   for _ in range(4)])
            full = None
        except QueueFullError as e:
            full = e
        check(full is not None and (await first).shape == (1, 3),
              "serve: queue_full did not round-trip as QueueFullError")
        far = next(ten for ten in range(N_TENANTS)
                   if m.shard_for(f"t{ten:02d}/fleet") != "s0")
        stale = ServingClient(ShardMap([ShardInfo("s0",
                                                  *m.address_of("s0"))]))
        clients.append(stale)
        qs = [refs.svcs[far].predictor.task_names()[3], "C2", 2.5]
        got = await stale.predict([qs], f"t{far:02d}", "fleet")
        check(stale.map.version == m.version
              and refs.same(far, [PredictionQuery(*qs)], got),
              "serve: a client with a stale map did not heal from "
              "wrong_shard to the bitwise answer")
        print(f"[serve] queue_full from a shard of max_pending_batches=1 "
              f"round-trips as {type(full).__module__}."
              f"{type(full).__name__}; a client on map v1 healed to "
              f"v{stale.map.version} from wrong_shard ({card()})")
        # the refresher: `every_n` + 8 completions on each of two tasks of
        # t00, then one `refresh` RPC to its shard refits those two in one
        # bayes_fit launch; an in-process refresher over the references
        # refits the same rows, and the shard's state must match it bitwise
        fsid = m.shard_for("t00/fleet")
        fit_tasks = tasks_of[0][:2]
        every_n = RefreshPolicy().every_n
        items = [serve_completion(rng, 0, task, k) for k in range(every_n + 8)
                 for task in fit_tasks]
        await serve_observe(client, items)
        refs.feed(items)
        fits = kernels.bayes_fit.launches
        t0 = time.perf_counter()
        rr = await client.refresh(fsid)
        refresh_s = time.perf_counter() - t0
        fits = kernels.bayes_fit.launches - fits
        owned_ns = {f"t{ten:02d}" for ten in range(N_TENANTS)
                    if m.shard_for(f"t{ten:02d}/fleet") == fsid}
        ref_fit = FleetRefresher(refs.store, device=dev)
        fit_rep = ref_fit.refresh([(b, t) for b, t in ref_fit.due()
                                   if b.tenant in owned_ns])
        qs = [PredictionQuery(t, nd, 2.0) for t in fit_tasks
              for nd in (None, nodes[0])]
        got = await client.predict(qs, "t00", "fleet")
        check(rr["refreshed"] == fit_rep.n_tasks == len(fit_tasks)
              and fits == 1
              and await client.digest("t00", "fleet") == refs.digest(0)
              and refs.same(0, qs, got),
              f"refresh: the shard refit {rr['refreshed']} tasks in {fits} "
              f"bayes_fit launches, the in-process refresher "
              f"{fit_rep.n_tasks}, want {len(fit_tasks)} in one; or t00's "
              f"digest or predictions differ from the in-process refit's")
        print(f"[serve] refresh: {len(items)} completions on {fit_tasks}, "
              f"then the refresh RPC to {fsid}: {rr['refreshed']} tasks in "
              f"{fits} bayes_fit launch, {refresh_s * 1e3!r} ms; t00's "
              f"digest and predictions bitwise an in-process refresher's "
              f"({card()})")

        # --- 3. replica ---------------------------------------------------
        psid = m.shard_for("t00/fleet")
        primary = servers[psid]
        pstore = primary.store
        ptens = [ten for ten in range(N_TENANTS)
                 if m.shard_for(f"t{ten:02d}/fleet") == psid]
        replica = await ReplicaServer(
            device=dev, max_generation_lag=SERVE_REPLICA_LAG).start()
        others.append(replica)
        raddr = (host, replica.port)
        shipper = KeptShipper(pstore, [raddr])
        rkeys = [pstore.binding(f"t{ten:02d}", "fleet").key_str(t)
                 for ten in ptens[:2] for t in tasks_of[ten]]
        rx = rng.uniform(0.05, 12.0, len(rkeys))

        def primary_base():
            snap = pstore.snapshot()
            mean, std = predict_stacked(
                rx, lambda buf: snap.gather(rkeys, buf), device=dev)
            return np.stack([mean, mean - replica.z * std,
                             mean + replica.z * std],
                            axis=1).astype(np.float32)

        t0 = time.perf_counter()
        installed = await shipper.ship_once()
        boot_ship_s = time.perf_counter() - t0
        boot_bytes = shipper.frame_bytes[raddr]
        check(installed == [pstore.num_blocks] and shipper.ship_errors == 0,
              f"replica: the bootstrap ship installed {installed} of "
              f"{pstore.num_blocks} blocks ({shipper.ship_errors} errors: "
              f"{shipper.last_error!r})")
        cursor = shipper.shipped[raddr]
        # the delta's batch lands in the two tenants read below (a few of
        # the shard's blocks)
        items = serve_completions(rng, SERVE_INGEST_BATCH, ptens[:2])
        seqs, _ = await serve_observe(client, items)
        refs.feed(items)
        moved = sorted(i for i, g in pstore._block_gen.items() if g > cursor)
        t0 = time.perf_counter()
        installed = await shipper.ship_once()
        delta_ship_s = time.perf_counter() - t0
        delta_bytes = shipper.frame_bytes[raddr]
        check(installed == [len(moved)] and 0 < len(moved)
              < pstore.num_blocks and shipper.ship_errors == 0,
              f"replica: the delta installed {installed} blocks, not the "
              f"{len(moved)} moved ones ({shipper.ship_errors} errors: "
              f"{shipper.last_error!r})")
        got = await client.predict_base(raddr, rkeys, rx)
        check(got.dtype == np.float32 and np.array_equal(got,
                                                         primary_base()),
              "replica: predict_base is not bitwise the primary's")
        for _ in range(SERVE_REPLICA_LAG + 1):     # past the bound
            items = serve_completions(rng, 16, ptens)
            await serve_observe(client, items)
            refs.feed(items)
        await call_direct(raddr, "mark", {"g": pstore.generation})
        try:
            await client.predict_base(raddr, rkeys, rx)
            stale_err = None
        except ReplicaStaleError as e:
            stale_err = e
        check(stale_err is not None
              and stale_err.lag == SERVE_REPLICA_LAG + 1,
              f"replica: a read {SERVE_REPLICA_LAG + 1} generations behind "
              f"did not raise ReplicaStaleError")
        await shipper.ship_once()
        got = await client.predict_base(raddr, rkeys, rx)
        digests = [(await call_direct(raddr, "digest",
                                      {"ns": f"t{ten:02d}/fleet"}))["sha256"]
                   == refs.digest(ten) for ten in ptens]
        check(np.array_equal(got, primary_base()) and all(digests)
              and shipper.ship_errors == 0,
              f"replica: after the catch-up ship, predict_base or a digest "
              f"differs from the primary's ({shipper.ship_errors} ship "
              f"errors: {shipper.last_error!r})")
        print(f"[serve] replica of {psid} ({len(ptens)} tenants, "
              f"{pstore.num_blocks} blocks): bootstrap frame "
              f"{boot_bytes} bytes shipped in {boot_ship_s!r} s; after "
              f"{len(seqs)} acks a delta frame {delta_bytes} bytes "
              f"({len(moved)} blocks) in {delta_ship_s!r} s; "
              f"predict_base of {len(rkeys)} rows "
              f"bitwise the primary; a read {stale_err.lag} generations "
              f"behind raised ReplicaStaleError; ship_errors 0; "
              f"MAX_FRAME {wire.MAX_FRAME} ({card()})")

        # --- 4. resharding under traffic ------------------------------------
        s3 = boot_shard(SERVE_ADDED, client.map, boot, **shard_opts())
        await s3.start()
        servers[SERVE_ADDED] = s3
        all_ns = [f"t{ten:02d}/fleet" for ten in range(N_TENANTS)]
        grown = client.map.with_shard(SERVE_ADDED, host, s3.port)
        moving = [int(ns[1:3]) for ns in client.map.moved(grown, all_ns)]
        staying = [t for t in range(N_TENANTS) if t not in moving]
        obs_tens = (moving[:SERVE_RESHARD_TENANTS]
                    + staying[:SERVE_RESHARD_TENANTS])
        read_tens = [t for t in moving + staying if t not in obs_tens][:8]
        reshard = {}
        for label, change in (
                ("add", lambda c: c.add_shard(SERVE_ADDED, host, s3.port)),
                ("remove", lambda c: c.remove_shard(SERVE_ADDED))):
            stop = asyncio.Event()
            got_acks, n_reads, reads_ok, unknown = [], [0], [True], [0]

            async def observer():
                # a record rejected as migrating, wrong_shard or queue_full
                # was applied nowhere and is sent again; one whose frame
                # was on a connection the publish closed (the removed
                # shard's) has an unknown outcome, is not sent again, and
                # is not fed to the references: the digests then show
                # whether it was applied
                retry = (MigratingError, WrongShardError, QueueFullError)
                while not stop.is_set():
                    pending = serve_completions(rng, 50, obs_tens)
                    while pending:
                        try:
                            await serve_observe(client, pending)
                            got_acks.extend(pending)
                            break
                        except PartialObserveError as e:
                            seqs, errs = e.seqs, e.errors
                        except retry as e:
                            seqs, errs = [None] * len(pending), {0: e}
                        except ConnectionError:
                            unknown[0] += len(pending)
                            break
                        check(all(isinstance(x, retry + (ConnectionError,))
                                  for x in errs.values()),
                              f"reshard: an observe failed with {errs}")
                        got_acks.extend(p for p, q in zip(pending, seqs)
                                        if q is not None)
                        lost = [i for i, x in errs.items()
                                if isinstance(x, ConnectionError)]
                        unknown[0] += len(lost)
                        pending = [p for i, (p, q) in enumerate(
                            zip(pending, seqs))
                            if q is None and i not in lost]
                        await asyncio.sleep(0.02)

            async def reader():
                while not stop.is_set():
                    batch = [(ten, [PredictionQuery(
                        tasks_of[ten][int(rng.integers(0,
                                                       len(tasks_of[ten])))],
                        nodes[int(rng.integers(0, len(nodes)))],
                        float(rng.uniform(0.05, 12.0)))
                        for _ in range(64)]) for ten in read_tens]
                    arrs = await client.predict_many(
                        [(f"t{ten:02d}", "fleet", q) for ten, q in batch])
                    for (ten, q), a in zip(batch, arrs):
                        reads_ok[0] &= refs.same(ten, q, a)
                    n_reads[0] += 1

            quiet_moved = [t for t in moving if t not in obs_tens]
            before = {t: await client.digest(f"t{t:02d}", "fleet")
                      for t in quiet_moved}
            workers = [asyncio.ensure_future(observer()),
                       asyncio.ensure_future(reader())]
            await asyncio.sleep(0.1)
            t0 = time.perf_counter()
            report = await change(RebalanceCoordinator(
                client, release_grace_s=0.05))
            rb_s = time.perf_counter() - t0
            await asyncio.sleep(0.1)
            stop.set()
            await asyncio.gather(*workers)
            refs.feed(got_acks)
            lost = [ten for ten in obs_tens
                    if await client.digest(f"t{ten:02d}", "fleet")
                    != refs.digest(ten)]
            moved_now = [int(ns[1:3]) for ns in report.moved]
            check(report.verified and sorted(moved_now) == sorted(moving)
                  and not lost and reads_ok[0] and n_reads[0] > 0,
                  f"reshard ({label}): verified {report.verified}, moved "
                  f"{moved_now} (want {moving}), tenants whose digest "
                  f"misses an acked observation {lost}, reads bitwise "
                  f"{reads_ok[0]} ({n_reads[0]} rounds)")
            after = {t: await client.digest(f"t{t:02d}", "fleet")
                     for t in quiet_moved}
            check(set(report.digests) == set(report.moved)
                  and all(report.digests[f"t{t:02d}/fleet"] == d
                          for t, d in before.items()) and after == before,
                  f"reshard ({label}): a moved namespace's digest differs "
                  f"before, at and after the handoff")
            reshard[label] = (rb_s, report.rows_shipped, len(report.moved),
                              len(got_acks), n_reads[0], unknown[0])
            print(f"[serve] reshard {label} {SERVE_ADDED} (map "
                  f"v{report.old_version} -> v{report.new_version}): "
                  f"{rb_s!r} s, {len(report.moved)} tenants, "
                  f"{report.rows_shipped} rows moved; digests source == "
                  f"target for each, and equal before and after for the "
                  f"{len(quiet_moved)} no worker wrote; under it "
                  f"{len(got_acks)} acked observations all in the digests "
                  f"({unknown[0]} of unknown "
                  f"outcome, in flight on a closed connection, applied "
                  f"nowhere), {n_reads[0]} predict_many rounds bitwise "
                  f"({card()})")
        check(SERVE_ADDED not in client.map.shards
              and all(ns.startswith("__shard__/")
                      for ns in s3.store.namespaces()),
              "reshard: the removed shard still owns namespaces")
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)
        out.update(cold_s=cold_s, predict_s=secs, n_q=n_q, lat=lat,
                   ack_s=ack_s, reshard=reshard, boot_bytes=boot_bytes,
                   delta_bytes=delta_bytes)
    finally:
        for c in clients:
            await c.close()
        for srv in list(servers.values()) + others:
            await srv.aclose()
    # the install frames the replica was sent, and the same payloads'
    # frames under the JSON + base64 fallback (reckoned once the tier is
    # closed): each under MAX_FRAME under either codec
    sent = [n for n, _ in shipped]
    as_json = [n if wire.msgpack is None else wire._HEADER.size + len(
        json.dumps(wire._jsonize({"i": 1, "op": "install_snapshot",
                                  "s": p})).encode()) for n, p in shipped]
    check(max(sent + as_json) < wire.MAX_FRAME,
          f"replica: an install frame of {max(sent + as_json)} bytes "
          f"reaches MAX_FRAME {wire.MAX_FRAME} (shipped {sent}, under the "
          f"JSON fallback {as_json})")
    print(f"[serve] the replica's install frames (bootstrap, delta, "
          f"catch-up): {sent} bytes as shipped, {as_json} under the JSON + "
          f"base64 fallback; MAX_FRAME {wire.MAX_FRAME} ({card()})")
    return out


async def serve_failover(dev, post, root) -> dict:
    """Step 5 of `phase_serve`: the three shards as processes of the
    port's `ShardSupervisor` (`--device cuda`), observed, checkpointed,
    observed again, one SIGKILLed, failed over and readmitted."""
    import asyncio
    import json as _json
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.serve import (RetryPolicy, ServingClient, ShardInfo,
                                   ShardMap, ShardSpec, ShardSupervisor)
    npz = os.path.join(root, "fleet_post.npz")
    np.savez(npz, **post)
    os.environ[SERVE_FLEET_ENV] = npz
    rng = np.random.default_rng(59)
    host = "127.0.0.1"
    m = ShardMap([ShardInfo(s, host, 0) for s in SERVE_SHARDS])
    specs = [ShardSpec(sid, SERVE_BOOTSTRAP, tempfile.mkdtemp(dir=root),
                       os.path.join(tempfile.mkdtemp(dir=root), "oplog"),
                       extra_args=["--device", "cuda", "--window-s",
                                   str(FE_WINDOW_S)])
             for sid in SERVE_SHARDS]
    wire_map = _json.dumps(m.to_wire())
    logs = tempfile.mkdtemp(dir=root)

    def child_logs() -> str:
        return "".join(f"\n--- {n}:\n" + open(os.path.join(logs, n)).read()
                       [-3000:] for n in sorted(os.listdir(logs)))

    with ShardSupervisor(repo_root=ROOT, ready_timeout_s=300,
                         stderr_dir=logs) as sup:
        t0 = time.perf_counter()
        try:
            with ThreadPoolExecutor(len(specs)) as pool:
                ports = list(pool.map(lambda s: sup.start(s, wire_map),
                                      specs))
        except (RuntimeError, TimeoutError) as e:
            fail(f"failover: a shard process did not start: {e}"
                 f"{child_logs()}")
        start_s = time.perf_counter() - t0
        for sid, port in zip(SERVE_SHARDS, ports):
            m = m.with_address(sid, host, port)
        client = ServingClient(m, RetryPolicy(max_attempts=12))
        try:
            await client.update_maps()
            victim = m.shard_for("t00/fleet")
            vtens = [ten for ten in range(N_TENANTS)
                     if m.shard_for(f"t{ten:02d}/fleet") == victim]

            async def ingest():
                acks = []
                for _ in range(SERVE_FAILOVER_BATCHES):
                    items = serve_completions(rng, SERVE_INGEST_BATCH,
                                              range(N_TENANTS))
                    seqs, _ = await serve_observe(client, items)
                    acks += [q for (ten, _), q in zip(items, seqs)
                             if m.shard_for(f"t{ten:02d}/fleet") == victim]
                return acks

            pre = await ingest()
            t0 = time.perf_counter()
            ck = await client.checkpoint(victim)
            ckpt_s = time.perf_counter() - t0
            check(ck["seq"] == max(pre),
                  f"failover: the checkpoint's watermark {ck['seq']} is not "
                  f"the last ack {max(pre)}")
            post_acks = await ingest()
            digests = {ten: await client.digest(f"t{ten:02d}", "fleet")
                       for ten in vtens}
            qs = [(f"task{ten * (N_FLEET // N_TENANTS) + j:05d}",
                   ("A1", "N2", None)[j % 3], 0.25 + j)
                  for ten in vtens[:1] for j in range(64)]
            before = await client.predict(qs, f"t{vtens[0]:02d}", "fleet")
            t0 = time.perf_counter()
            sup.kill(victim)
            loop = asyncio.get_running_loop()
            try:
                port = await loop.run_in_executor(
                    None, sup.failover, victim, _json.dumps(m.to_wire()))
            except (RuntimeError, TimeoutError) as e:
                fail(f"failover: {victim} did not come back: {e}"
                     f"{child_logs()}")
            ready_s = time.perf_counter() - t0
            replayed = sup.ready[victim]["replayed"]
            boot_ms = (sup.ready[victim]["boot_ms"],
                       sup.ready[victim]["replay_ms"])
            client.set_map(m.with_address(victim, host, port))
            await client.update_maps()
            h = await client.health(victim)
            after = {ten: await client.digest(f"t{ten:02d}", "fleet")
                     for ten in vtens}
            again = await client.predict(qs, f"t{vtens[0]:02d}", "fleet")
            check(after == digests and replayed == len(post_acks)
                  and h["seq"] == max(post_acks)
                  and np.array_equal(again, before),
                  f"failover: after the kill of {victim}, digests equal "
                  f"{after == digests}, replayed {replayed} of "
                  f"{len(post_acks)} acks past the checkpoint, seq "
                  f"{h['seq']} (want {max(post_acks)}), predictions "
                  f"bitwise {np.array_equal(again, before)}")
            check(ready_s <= SERVE_READY_S,
                  f"failover: {victim} took {ready_s!r} s from SIGKILL to "
                  f"READY, over the limit of {SERVE_READY_S} s")
        finally:
            await client.close()
    print(f"[serve] failover: {len(SERVE_SHARDS)} shard processes "
          f"(--device cuda) ready in {start_s!r} s (cold boots, side by "
          f"side); {victim} ({len(vtens)} tenants) checkpointed at seq "
          f"{ck['seq']} in {ckpt_s!r} s, {len(post_acks)} more acks, "
          f"SIGKILL -> failover READY {ready_s!r} s (limit "
          f"{SERVE_READY_S} s; the child's warm "
          f"boot: restore, resume, replay {boot_ms[0]} ms, of it the "
          f"replay of {replayed} records {boot_ms[1]} ms); digests of "
          f"its {len(vtens)} tenants bit-identical, predictions bitwise, "
          f"seq {h['seq']}; "
          f"the children's launches are their own and not counted "
          f"({card()})")
    return {"start_s": start_s, "ready_s": ready_s, "replayed": replayed,
            "ckpt_s": ckpt_s, "boot_ms": boot_ms}


def phase_serve(dev, fleet_out) -> dict:
    """The sharded serving tier on the card over the refresh fleet (64
    tenants x 1,024 tasks, 65,536 rows): three in-process shards through
    the port's client (serve, ingest, replica, resharding), then the same
    shards as supervised processes (failover).  Oplogs and checkpoints in
    `tempfile.mkdtemp()` directories under one parent, removed at the
    end."""
    import asyncio
    import shutil
    import tempfile
    post = fleet_out["fleet_post"]
    root = tempfile.mkdtemp(prefix="lotaru-serve-")
    t0 = time.perf_counter()
    try:
        out = asyncio.run(serve_tier(dev, post, root))
        out.update(asyncio.run(serve_failover(dev, post, root)))
    finally:
        os.environ.pop(SERVE_FLEET_ENV, None)
        shutil.rmtree(root, ignore_errors=True)
    print(f"[serve] the phase took {time.perf_counter() - t0!r} s "
          f"({card()})")
    return out


def bounds_predict(q: int) -> tuple:
    """Least time for q predictive queries: the eleven values a query
    needs (x and its posterior row, 88 B) read once and its mean and std
    (16 B) written once; 20 float64 operations per query."""
    t_bytes = q * (88 + 16) / H100_BYTES_PER_S * 1e3
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


def raw_launch(name: str, args, lib=None):
    """A callable that launches kernel `name` through its C entry point
    with fixed arguments (tensors become pointers; the current stream is
    appended): back-to-back calls of it time the kernel, not the wrapper's
    checks and allocations."""
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    fn = getattr(lib or kernels._lib(), f"lotaru_{name}")
    full = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args] + [torch.cuda.current_stream().cuda_stream]

    def launch():
        rc = fn(*full)
        check(rc == 0, f"{name} launch failed with CUDA error {rc}")
    launch.operands = args      # the tensors live as long as the callable
    launch.unchecked = lambda: fn(*full)    # -> the CUDA error code
    return launch


def bounds_cost(t: int, n: int, has_z: bool) -> tuple:
    """Least time for one fused cost matrix: the static factor read and
    the cost written once a cell (16 B), x and the 80-byte posterior row
    read once a task (88 B), a node's correction once (8 B); about 20
    float64 operations a task and 3 (6 with the quantile shift) a cell."""
    t_bytes = (t * n * 16 + t * 88 + n * 8) / H100_BYTES_PER_S * 1e3
    ops = t * 20 + t * n * (6 if has_z else 3)
    t_ops = ops / H100_FP64_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sweep_work(args, assign) -> tuple:
    """(bytes, float64 operations) of one workflow's sweep, as
    `bounds_sweep` counts them, without the (N, N) comm structure's bytes
    (a group of workflows on one cluster reads it once)."""
    W, order, dep, gb8, ready0, avail, same, gbps = args
    t, n = W.shape
    d = dep.shape[1]
    n_bytes = 16 * t * n + 4 * t * d + 12 * t + 8 * n + 20 * t + 4 * n
    counts = (avail.cpu().numpy() > 0).astype(np.int64)
    ndeps = (dep.cpu().numpy() >= 0).sum(axis=1)
    assign = assign.cpu().numpy()
    ops = 0
    for i in order.cpu().numpy():
        if i < 0:
            continue
        ops += n * (2 * int(ndeps[i]) + 3) + 3 * (int(counts.sum()) + n)
        j = int(assign[i])
        ops += 2 * int(counts[j])
        counts[j] += 1
    return n_bytes, ops


def bounds_sweep(args, assign) -> tuple:
    """Least time for one sweep.  Bytes: W and ready0 (8 B per cell), the
    dep rows, order, output sizes, available times, the (N, N) comm
    structure read once; assign, est, eft and the counts written once.
    Operations, counted from this run's placements: per task and node two
    per dependency (add, max), three per live interval plus the pad column
    of the gap search (max, add, compare), the finish add, the argmin
    compare and the comm divide; per task two per live interval of the
    chosen node for the insert position.  Also the latency bound: T
    dependent steps of SWEEP_STEP_CYCLES each at the maximum clock."""
    t, n = args[0].shape
    n_bytes, ops = sweep_work(args, assign)
    t_bytes = (n_bytes + 9 * n * n) / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP64_FLOPS * 1e3
    step_ms = t * SWEEP_STEP_CYCLES / H100_CLOCK_HZ * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", step_ms)


def bounds_sweep_many(lanes, assigns) -> tuple:
    """Least time for one many-lane sweep: every lane's bytes and
    operations (`sweep_work`) and the comm structure once, over the
    card's rates; the latency bound is the longest lane's chain of steps
    (`bounds_sweep`), since up to 132 lanes run side by side, a block an
    SM."""
    n = lanes[0][0].shape[1]
    work = [sweep_work(a, x) for a, x in zip(lanes, assigns)]
    t_bytes = (sum(w[0] for w in work) + 9 * n * n) / H100_BYTES_PER_S * 1e3
    t_ops = sum(w[1] for w in work) / H100_FP64_FLOPS * 1e3
    step_ms = max(a[0].shape[0] for a in lanes) * SWEEP_STEP_CYCLES \
        / H100_CLOCK_HZ * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", step_ms)


def bounds_rank(Ws, tables, cluster: int) -> tuple:
    """Least time for one rank launch over B workflows.  Bytes: W read once
    (8 B a cell), avg_comm and the successor and level tables read once,
    the ranks written once; operations: an add a cell, a division a row,
    an add and a max a successor.  Latency: the longest lane's L levels of
    RANK_LEVEL_CYCLES each, plus one pass over its W from the SMs of its
    cluster's workers (all blocks but the leader, or the one block of a
    cluster of one) at SM_FILL_BYTES a cycle each, at the maximum clock.
    -> (bytes or operations bound, which, latency bound)."""
    n_bytes = ops = 0
    latency = 0.0
    for w, tab in zip(Ws, tables):
        t, n = w.shape
        e = tab.succ_idx.shape[0]
        n_bytes += 8 * t * n + 8 * t + 4 * (2 * t + 1 + e) \
            + 4 * tab.level_ptr.shape[0] + 8 * t
        ops += t * n + 2 * e
        cycles = (tab.L * RANK_LEVEL_CYCLES
                  + 8 * t * n / (max(cluster - 1, 1) * SM_FILL_BYTES))
        latency = max(latency, cycles / H100_CLOCK_HZ * 1e3)
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP64_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", latency)


def rank_launch(Ws, tables, route: str, cluster=None, lib=None):
    """`raw_launch` of upward_rank over these lanes on `route` ("shared",
    `cluster` blocks a lane or None for `rank_config`'s size; or "global"),
    shaped by `rank_config` as the wrapper shapes it: the lane by value at
    B = 1, else through a lane table.  The callable's `rank` and `bad` are
    its outputs, `config` its shape."""
    import torch
    from repro_torch.kernels import decision_plane as plane_k
    dev = Ws[0].device
    rows = [[w.data_ptr(), *(x.data_ptr() for x in tab), tab.T, tab.L]
            for w, tab in zip(Ws, tables)]
    b, n = len(Ws), Ws[0].shape[1]
    t = max(tab.T for tab in tables)
    cfg = plane_k.rank_config(
        t, max(tab.E for tab in tables), max(tab.L for tab in tables), n, b,
        plane_k.smem_optin(dev.index), plane_k.sm_count(dev.index),
        aligned=route == "shared", cluster=cluster)
    check(cfg["route"] == route, f"rank_config gives the {cfg['route']} "
          f"route for these lanes, not the {route} route")
    host = np.asarray(rows, np.int64)
    layout = np.asarray(cfg["layout"] or [0], np.int32)
    table = plane_k._lane_table(rows, dev) if b > 1 else None
    rank = torch.empty((b, t), dtype=torch.float64, device=dev)
    bad = torch.empty(b, dtype=torch.int32, device=dev)
    fn = raw_launch("upward_rank", [
        table, None if b > 1 else host.ctypes.data, b, n, t,
        plane_k.RANK_ROUTES.index(route), cfg["cluster"], cfg["tile_rows"],
        cfg["smem_bytes"], layout.ctypes.data if cfg["layout"] else None,
        rank, bad], lib or plane_k._lib())
    fn.host, fn.layout, fn.rank, fn.bad = host, layout, rank, bad
    fn.config = cfg
    return fn


def time_plane(dev, sweep_args) -> dict:
    """Times of fused_cost and eft_sweep at the plan round's shapes."""
    import torch
    from repro_torch.kernels import decision_plane as plane
    from repro_torch.kernels import ref
    from repro_torch.sched.plane import quantile_z
    lib = plane._lib()
    z = quantile_z(PLAN_QUANTILE)
    x, post, base, corr = cost_inputs(np.random.default_rng(13), PLAN_TASKS,
                                      PLAN_NODES)
    batch = plane.pack_cost(dev, x, post, corr)
    bd = torch.from_numpy(base).to(dev)
    w = torch.empty_like(bd)
    launch = raw_launch("fused_cost", [batch.slab, bd, w, PLAN_TASKS,
                                       PLAN_NODES, z, 1], lib)
    out = {"fused_cost": {
        "ms": time_ms(launch), "warm_ms": warm_ms(launch),
        "wrapper_ms": time_ms(lambda: plane.fused_cost(batch, bd, z),
                              host=True),
        "pack_ms": time_ms(lambda: plane.pack_cost(dev, x, post, corr),
                           host=True),
        "plain_ms": time_ms(lambda: ref.fused_cost_ref(batch, bd, z),
                            reps=5, host=True)}}
    a = sweep_args
    t, n = a[0].shape
    f64, i32 = torch.float64, torch.int32

    def sweep_launch(s, route):
        """The sweep's C entry on `route` (0 shared, 1 global), with its
        scratch and outputs allocated once."""
        stacks = [None, None]
        if route:
            stacks = [torch.empty((s, n), dtype=f64, device=dev),
                      torch.empty((s, n), dtype=f64, device=dev)]
        outs = [torch.empty((t + 1, n), dtype=f64, device=dev),
                torch.empty(n, dtype=i32, device=dev),
                torch.zeros(t + 1, dtype=i32, device=dev),
                torch.zeros(t + 1, dtype=f64, device=dev),
                torch.zeros(t + 1, dtype=f64, device=dev)]
        return raw_launch("eft_sweep", [a[0], a[1], a[2], a[2].shape[1],
                                        a[3], a[4], a[5], a[6], a[7], t, n,
                                        s, route] + stacks + outs, lib)

    shared, glob = sweep_launch(48, 0), sweep_launch(S_DIRECT, 1)
    out["eft_sweep"] = {
        "ms": time_ms(shared, reps=10),
        "warm_ms": warm_ms(shared, reps=10, inner=5),
        "wrapper_ms": time_ms(lambda: plane.eft_sweep(*a, S=48), reps=10,
                              host=True),
        "plain_ms": time_ms(lambda: ref.eft_sweep_ref(*a, S=48), reps=3,
                            host=True),
        "global_ms": time_ms(glob, reps=5),
        "global_warm_ms": warm_ms(glob, reps=5, inner=3)}
    return out


def median_q(tally: dict) -> float:
    """The median Q of a {Q: launches} tally, each launch counted."""
    return float(np.median(np.repeat(list(tally), list(tally.values()))))


def q_buckets(tally: dict) -> dict:
    """Launches by Q (a {Q: launches} tally) in decades of Q."""
    out = {}
    for q, n in sorted(tally.items()):
        lo = 10 ** (len(str(q)) - 1)
        key = "1" if q == 1 else f"{max(lo, 2)}-{10 * lo - 1}"
        out[key] = out.get(key, 0) + n
    return out


def time_predict(batch) -> dict:
    """bayes_predict's times on a packed batch on the card, the results
    interleaved."""
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import ref
    q = batch.q
    out = torch.empty((q, 2), dtype=torch.float64, device=batch.slab.device)
    launch = raw_launch("bayes_predict", [batch.slab, q, 0, out])
    return {"ms": time_ms(launch), "warm_ms": warm_ms(launch),
            "wrapper_ms": time_ms(lambda: kernels.bayes_predict(batch),
                                  host=True),
            "plain_ms": time_ms(lambda: ref.bayes_predict_ref(batch),
                                reps=5, host=True)}


def time_slabs(dev, qs) -> dict:
    """The host's side of the predictive's operand at each q (random rows;
    host clock, median of 20, each call ended by a sync): `fill_slab` into
    a pinned buffer; `pack_predict`, the filling and its one copy up
    together; and, for reference, the same x and seven posterior leaves
    sent up as eight copies from pageable memory."""
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.store.compute import LEAVES
    out = {}
    for q in qs:
        x, post = random_posteriors(np.random.default_rng(q), q)
        pinned = torch.empty(kernels.predict_slots(q), dtype=torch.float64,
                             pin_memory=True).numpy()

        def leaves():
            for a in [x] + [post[k] for k in LEAVES]:
                torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        out[q] = {name: median_s(fn, reps=20) * 1e3 for name, fn in (
            ("fill_ms", lambda: kernels.fill_slab(pinned, q, x, post)),
            ("fill_and_copy_ms", lambda: (kernels.pack_predict(dev, x, post),
                                          torch.cuda.synchronize())),
            ("leaf_copies_ms", lambda: (leaves(),
                                        torch.cuda.synchronize())))}
    return out


def time_scatter(dev) -> dict:
    """A scattering bayes_predict as the 38-workflow round after an ingest
    batch makes it (Q = 33,800 random rows into PREDICT_PLANES resident
    planes): the launch through its wrapper and through its C entry point,
    and `pack_predict` of the batch with its table."""
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    q = PREDICT_CHECK_QS[3]
    rng = np.random.default_rng(q + 1)
    x, post = random_posteriors(rng, q)
    share = np.full(PREDICT_PLANES, q // PREDICT_PLANES)
    share[: q % PREDICT_PLANES] += 1
    targets = nan_targets(share, dev)
    dest = np.concatenate([np.arange(n) for n in share])
    pairs = list(zip(targets, share))
    batch = kernels.pack_predict(dev, x, post, dest, pairs)
    launch = raw_launch("bayes_predict", [batch.slab, q, PREDICT_PLANES,
                                          None])
    return {"q": q, "planes": PREDICT_PLANES, "ms": time_ms(launch),
            "wrapper_ms": time_ms(lambda: kernels.bayes_predict(batch),
                                  host=True),
            "fill_and_copy_ms": median_s(lambda: (kernels.pack_predict(
                dev, x, post, dest, pairs), torch.cuda.synchronize()),
                reps=20) * 1e3}


def phase_report(dev, launches, errors, fleet, fleet_out, plan_args,
                 fold, predict_q) -> list:
    import torch
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import ref
    from repro_torch.store import TaskKey
    svc = fleet_out["replan_service"]
    queries = fleet_out["replan_queries"]
    post = svc.store.snapshot().gather(
        [TaskKey(svc.tenant, svc.workflow, q.task) for q in queries])
    q = len(queries)
    pt = time_predict(kernels.pack_predict(
        dev, [qu.input_gb for qu in queries], post))
    p_bound, p_by = bounds_predict(q)
    q_paper = int(median_q(predict_q["paper"]))

    print(f"[report] bayes_predict Q={q}: {pt} bound {p_bound!r} ms")
    by_q = {q: dict(pt, bound_ms=p_bound)}
    for qq, seed in ((1, 21), (q_paper, 22), (1000, 23), (Q_PREDICT_CHECK,
                                                         11)):
        xq, post_q = random_posteriors(np.random.default_rng(seed), qq)
        tq = time_predict(kernels.pack_predict(dev, xq, post_q))
        by_q[qq] = dict(tq, bound_ms=bounds_predict(qq)[0])
        print(f"[report] bayes_predict Q={qq}: {tq} bound "
              f"{by_q[qq]['bound_ms']!r} ms")
    big = by_q[Q_PREDICT_CHECK]
    slope = (big["ms"] - pt["ms"]) / (Q_PREDICT_CHECK - q)   # ms a query
    floor = pt["ms"] - slope * q
    print(f"[report] bayes_predict launch floor: {floor!r} ms (Q={q} less "
          f"the slope to Q={Q_PREDICT_CHECK}); the body streams "
          f"{112 / (slope * 1e-3) / 1e12!r} TB/s "
          f"({112 / (slope * 1e-3) / H100_BYTES_PER_S!r} of the peak); at "
          f"Q={Q_PREDICT_CHECK} the kernel reaches "
          f"{big['bound_ms'] / big['ms']!r} of its bound; Q=1 takes "
          f"{by_q[1]['ms']!r} ms")
    probe = {}
    for blocks, threads in ((1, 32), ((q + 255) // 256, 256)):
        empty = raw_launch("empty", [blocks, threads])
        probe[f"{blocks}x{threads}"] = {"ms": time_ms(empty),
                                        "warm_ms": warm_ms(empty)}
    print(f"[report] launch floor probe (an empty kernel, blocks x threads; "
          f"{blocks} blocks is the Q={q} grid): {probe}; of the floor "
          f"{floor!r} ms the empty launch is "
          f"{probe['1x32']['ms'] / floor!r}")
    slabs = time_slabs(dev, (q_paper, 1000, PREDICT_CHECK_QS[3], q))
    for qq, v in slabs.items():
        print(f"[report] predictive slab Q={qq} (host clock): {v}")
    scatter = time_scatter(dev)
    print(f"[report] bayes_predict scattered into {scatter['planes']} "
          f"planes, Q={scatter['q']}: {scatter}")
    fx, fy, fm = (torch.from_numpy(a).to(dev) for a in fleet)
    t, n = fx.shape
    fout = [torch.empty(t, k, device=dev) for k in (2, 4, 1, 1, 1, 1, 1, 1,
                                                    1)]
    launch = raw_launch("bayes_fit", [fx, fy, fm, t, n] + fout)
    f_ms, f_warm = time_ms(launch), warm_ms(launch)
    # the same buffers 4 bytes past a 16-byte boundary: the cp_async route
    off = [torch.empty(t * n + 1, device=dev)[1:].view(t, n).copy_(a)
           for a in (fx, fy, fm)]
    f_cp = time_ms(raw_launch("bayes_fit", off + [t, n] + fout))
    f_wrapper = time_ms(lambda: kernels.bayes_fit(fx, fy, fm), host=True)
    f_plain = time_ms(lambda: ref.bayes_fit_ref(fx, fy, fm), reps=3,
                      host=True)
    f_bound, f_by = bounds_fit(fleet[2])
    print(f"[report] bayes_fit T={t} N={n}: ms {f_ms!r}, warm_ms "
          f"{f_warm!r}, wrapper_ms {f_wrapper!r}, plain_ms {f_plain!r}, "
          f"bound {f_bound!r} ms; cp_async route (operands off a 16-byte "
          f"boundary) ms {f_cp!r}")
    from repro_torch.kernels import decision_plane as plane
    pl = time_plane(dev, plan_args)
    c_bound, c_by = bounds_cost(PLAN_TASKS, PLAN_NODES, True)
    assign = plane.eft_sweep(*plan_args, S=48)[0]
    s_bound, s_by, s_step = bounds_sweep(plan_args, assign)
    t_plan = plan_args[0].shape[0]
    print(f"[report] fused_cost T={PLAN_TASKS} N={PLAN_NODES}: "
          f"{pl['fused_cost']} bound {c_bound!r} ms ({c_by})")
    print(f"[report] eft_sweep T={t_plan} N={PLAN_NODES} S=48 (shared "
          f"route; global route at S={S_DIRECT}): {pl['eft_sweep']} bound "
          f"{s_bound!r} ms ({s_by}), latency bound {s_step!r} ms, per step "
          f"{pl['eft_sweep']['ms'] / t_plan!r} ms")
    src = "src/repro_torch/kernels/csrc/bayes.cu"
    dsrc = "src/repro_torch/kernels/csrc/decision_plane.cu"
    return [
        {"name": "bayes_fit", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/bayes_fit.py:94",
         "launches": launches["bayes_fit"],
         "max_abs_err": errors["bayes_fit"][0],
         "tolerance": "rtol 5e-3 atol 5e-4",
         "tol_ratio": errors["bayes_fit"][1], "ms": f_ms, "plain_ms": f_plain,
         "bound_ms": f_bound, "bound_by": f_by, "library_ms": None,
         "warm_ms": f_warm, "wrapper_ms": f_wrapper,
         "shape": f"T={fleet[0].shape[0]} N={fleet[0].shape[1]}"},
        {"name": "bayes_predict", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/bayes_fit.py:343",
         "launches": launches["bayes_predict"],
         "max_abs_err": errors["bayes_predict"][0], "tolerance": "bitwise",
         "tol_ratio": errors["bayes_predict"][1], "ms": pt["ms"],
         "plain_ms": pt["plain_ms"], "bound_ms": p_bound, "bound_by": p_by,
         "library_ms": None, "warm_ms": pt["warm_ms"],
         "wrapper_ms": pt["wrapper_ms"], "shape": f"Q={q}",
         "floor_ms": floor, "by_q": by_q, "empty_probe": probe,
         "slabs": slabs, "scatter": scatter,
         "launches_by_q": {path: q_buckets(t)
                           for path, t in predict_q.items()}},
        {"name": "fused_cost", "route": "cuda", "source": dsrc,
         "replaces": "src/repro/kernels/decision_plane.py:111",
         "launches": launches["fused_cost"],
         "max_abs_err": errors["fused_cost"][0], "tolerance": "bitwise",
         "tol_ratio": errors["fused_cost"][1], "ms": pl["fused_cost"]["ms"],
         "plain_ms": pl["fused_cost"]["plain_ms"], "bound_ms": c_bound,
         "bound_by": c_by, "library_ms": None,
         "warm_ms": pl["fused_cost"]["warm_ms"],
         "wrapper_ms": pl["fused_cost"]["wrapper_ms"],
         "pack_ms": pl["fused_cost"]["pack_ms"],
         "shape": f"T={PLAN_TASKS} N={PLAN_NODES}"},
        {"name": "eft_sweep", "route": "cuda", "source": dsrc,
         "replaces": "src/repro/kernels/decision_plane.py:357",
         "launches": launches["eft_sweep"],
         "max_abs_err": errors["eft_sweep"], "tolerance": "bitwise",
         "tol_ratio": 0.0, "ms": pl["eft_sweep"]["ms"],
         "plain_ms": pl["eft_sweep"]["plain_ms"], "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": None,
         "warm_ms": pl["eft_sweep"]["warm_ms"],
         "wrapper_ms": pl["eft_sweep"]["wrapper_ms"],
         "step_bound_ms": s_step, "sweep_route": "shared",
         "global_ms": pl["eft_sweep"]["global_ms"],
         "global_warm_ms": pl["eft_sweep"]["global_warm_ms"],
         "global_shape": f"T={t_plan} N={PLAN_NODES} S={S_DIRECT}",
         "shape": f"T={t_plan} N={PLAN_NODES} S=48"},
        {"name": "nig_fold", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/bayes_fit.py:240",
         "launches": launches["nig_fold"], "max_abs_err": fold["err"],
         "tolerance": "bitwise", "tol_ratio": 0.0, "ms": fold["ms"],
         "plain_ms": fold["plain_ms"], "bound_ms": fold["bound_ms"],
         "bound_by": fold["bound_by"], "library_ms": None,
         "warm_ms": fold["warm_ms"], "wrapper_ms": fold["wrapper_ms"],
         "shape": fold["shape"]},
    ]


# ---------------------------------------------------------------------------
# LM: RecurrentGemma-9B serving
# ---------------------------------------------------------------------------
def tol_check(got, want, tol) -> tuple:
    """(max |got - want|, worst |got - want| / (atol + rtol |want|)) in
    float32; the ratio is at most 1 within the tolerance."""
    import torch
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), "an output is not finite")
    diff = (g - w).abs()
    return (float(diff.max()),
            float((diff / (tol["atol"] + tol["rtol"] * w.abs())).max()))


def flash_mirrors() -> None:
    """The bf16 flash kernel's shape arithmetic in C against its Python
    mirrors, which the CPU tests hold against ref.band_mask: shared memory
    and stages per head dim, and the kind of every tile of the walk."""
    from repro_torch.kernels import flash_attention as flash
    lib = flash._lib()
    smem = {}
    for hd in flash.HEAD_DIMS:
        st = flash.flash_stages(hd)
        smem[hd] = flash.flash_smem_bytes(hd, st)
        check(lib.lotaru_flash_stages(hd) == st
              and lib.lotaru_flash_smem_bytes(hd, st) == smem[hd],
              f"flash_smem_bytes or flash_stages differ from C at hd={hd}")
    n = 0
    for sq, skv in ((1, 1), (64, 64), (130, 130), (200, 200), (1000, 1000),
                    (130, 200), (200, 130)):
        for causal in (True, False):
            for window in (0, 1, 63, 64, 65, 2048):
                for consumers in (1, 2):
                    for q_lo, q_hi, j0, kind in flash.flash_tile_plan(
                            sq, skv, causal, window, consumers=consumers):
                        got = lib.lotaru_flash_tile_kind(
                            q_lo, q_hi, j0, skv, int(causal), window)
                        check(flash.TILE_KINDS[got] == kind,
                              f"tile_kind {got} != {kind} at {(sq, skv)} "
                              f"rows {q_lo}-{q_hi} j0 {j0}")
                        n += 1
    print(f"[kernels] flash_attention: flash_smem_bytes {smem} and "
          f"flash_stages equal to the C formulas; tile_kind equal to "
          f"flash_tile_kind on {n} tiles")


def attention_inputs(gen, b, s, h, kh, hd, dtype, dev, v_mean=0.0):
    """q, k, v from N(0, 1), v shifted by `v_mean` (1 makes every output
    O(1), where a zero-mean v averages to about 0.03 over 2048 keys)."""
    import torch
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))
    return q.to(dtype), k.to(dtype), (v + v_mean).to(dtype)


def phase_lm_kernels(dev) -> dict:
    """Each LM kernel against its plain version on the card, at the serve
    path's shapes and at the edges the path does not reach."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as scan
    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(17)
    shape = (LM_BATCH, LM_PROMPT, cfg.rglru_width)
    a = torch.rand(shape, generator=gen, device=dev) * 0.3 + 0.699
    gx = torch.randn(shape, generator=gen, device=dev) * 0.1
    h0 = torch.randn((LM_BATCH, cfg.rglru_width), generator=gen, device=dev)
    got, want = scan.rglru_scan(a, gx, h0), ref.rglru_scan_ref(a, gx, h0)
    torch.cuda.synchronize()
    bitwise = torch.equal(got, want)
    err = float((got - want).abs().max())
    print(f"[kernels] rglru_scan B={shape[0]} T={shape[1]} W={shape[2]}, "
          f"h0 != 0: bitwise vs plain (on the card) {bitwise}, max |err| "
          f"{err!r}")
    check(bitwise, "rglru_scan differs from its plain version")
    out = {"rglru_scan": (err, 0.0)}
    del a, gx, h0, got, want

    flash_mirrors()
    h, kh, hd, win = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.window)
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, K, hd, window, causal, dtype, v mean): the serve
    # path's shape, then the edges the path does not reach.  Every bf16 case
    # is held at both limits; ragged S at B = 2 shows that no tile reads
    # across batches (the maps zero-fill past S within a batch).
    cases = (
        ("path", LM_BATCH, LM_PROMPT, h, kh, hd, win, True, bf16, 0.0),
        ("path, v mean 1", LM_BATCH, LM_PROMPT, h, kh, hd, win, True, bf16,
         1.0),
        ("path", LM_BATCH, LM_PROMPT, h, kh, hd, win, True, f32, 0.0),
        ("ragged S", LM_BATCH, 1000, h, kh, hd, win, True, bf16, 0.0),
        ("ragged S", LM_BATCH, LM_PROMPT + 1, h, kh, hd, win, True, bf16,
         1.0),
        ("window 0", 1, 1000, h, kh, hd, 0, True, f32, 0.0),
        ("window 0", 1, 1000, h, kh, hd, 0, True, bf16, 0.0),
        ("window 1", LM_BATCH, 1000, h, kh, hd, 1, True, bf16, 1.0),
        ("window 64", LM_BATCH, 1000, h, kh, hd, 64, True, bf16, 0.0),
        ("not causal", LM_BATCH, 1000, h, kh, hd, 0, False, bf16, 0.0),
        ("not causal, window 64", 1, 1000, h, kh, hd, 64, False, bf16, 0.0),
        ("GQA K=2", LM_BATCH, 1000, h, 2, hd, 100, True, bf16, 0.0),
        ("GQA group 2", LM_BATCH, 1000, h, 8, hd, 100, True, bf16, 0.0),
        ("GQA group 3", LM_BATCH, 1000, 12, 4, hd, 100, True, bf16, 0.0),
        ("MHA K=16", LM_BATCH, 1000, h, h, hd, win, True, bf16, 0.0),
        ("MHA K=16, window 1", LM_BATCH, 1000, h, h, hd, 1, True, bf16,
         1.0),
        ("hd 64", LM_BATCH, 1000, h, kh, 64, 100, True, bf16, 0.0),
        ("hd 64, GQA group 3", LM_BATCH, 1000, 12, 4, 64, 64, True, bf16,
         1.0),
        ("hd 128", LM_BATCH, 1000, h, kh, 128, 100, True, bf16, 0.0),
        ("hd 128, MHA, not causal", LM_BATCH, 1000, h, h, 128, 0, False,
         bf16, 0.0))
    for label, b, s, n_h, k_h, d, w, causal, dt, v_mean in cases:
        q, k, v = attention_inputs(gen, b, s, n_h, k_h, d, dt, dev, v_mean)
        got = flash.flash_attention(q, k, v, causal=causal, window=w)
        want = ref.attention_ref(q, k, v, causal=causal, window=w)
        torch.cuda.synchronize()
        check(got.dtype == dt, "flash_attention output dtype")
        route = flash.flash_route(dt, n_h, k_h)
        tols = (F32_TOL,) if dt == f32 else (BF16_TOL, BF16_KERNEL_TOL)
        for tol in tols:
            err, ratio = tol_check(got, want, tol)
            print(f"[kernels] flash_attention {label} B={b} S={s} H={n_h} "
                  f"K={k_h} hd={d} window={w} causal={causal} "
                  f"{str(dt)[6:]}, {route} route: vs plain (on the card) "
                  f"within {tol['rtol']}/{tol['atol']} {ratio <= 1.0}, max "
                  f"|err| {err!r}, |err| / (atol + rtol |want|) {ratio!r}")
            check(ratio <= 1.0, f"flash_attention ({label}, {dt}) outside "
                  f"{tol} of its plain version")
        if label == "path" and dt == bf16:
            out["flash_attention"] = (err, ratio)
            # the limit sees a fault of one key per row: the plain version
            # over a band one key too wide is outside it
            wide = ref.attention_ref(q, k, v, causal=True, window=w + 1)
            ratios = [tol_check(wide, want, t)[1]
                      for t in (BF16_TOL, BF16_KERNEL_TOL)]
            print(f"[kernels] flash_attention {label}: the plain version "
                  f"with window {w + 1} against window {w}, |err| / (atol + "
                  f"rtol |want|) {ratios[0]!r} at 5e-2/5e-2, {ratios[1]!r} "
                  f"at 1e-2/4e-3")
            check(ratios[1] > 1.0, "the bf16 limit does not see a band one "
                  "key too wide")
        del q, k, v, got, want
    return out


def phase_lm(dev) -> None:
    """The LM main path: full-size RecurrentGemma-9B served through
    repro_torch.launch.serve, weights made on the card from LM_SEED."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import lotaru_next_token, serve
    from repro_torch.models import param_count_exact
    cfg = get_config(LM_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = serve(cfg, LM_BATCH, LM_PROMPT, LM_GEN, seed=LM_SEED, device=dev)
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    mean, std = lotaru_next_token(out.decode_s, dev)
    check(out.tokens.shape == (LM_BATCH, LM_GEN), "serve's token shape")
    check(bool(((out.tokens >= 0) & (out.tokens < cfg.vocab_size)).all()),
          "serve returned a token outside the vocabulary")
    dec = out.decode_s * 1e3
    med = float(np.median(dec))
    print(f"[lm] serve {LM_ARCH} on the card, full size ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {param_count_exact(cfg)} "
          f"parameters, {cfg.dtype}, weights made on the card from seed "
          f"{LM_SEED}): B={LM_BATCH}, prompt {LM_PROMPT}, {LM_GEN} "
          f"generated tokens")
    print(f"[lm] prefill {out.prefill_s!r} s "
          f"({LM_BATCH * LM_PROMPT / out.prefill_s!r} prompt tokens/s); "
          f"decode median {med!r} ms/step (min {float(dec.min())!r}, max "
          f"{float(dec.max())!r}, first {float(dec[0])!r}), "
          f"{LM_BATCH * 1e3 / med!r} tokens/s; the serve call {total!r} s "
          f"with making the weights; max_memory_allocated {peak} bytes")
    print(f"[lm] prefill {out.prefill_s!r} s and peak {peak / 1e9!r} GB "
          f"beside {LM_MMA_PREFILL_S} s and {LM_MMA_PEAK_GB} GB with the "
          f"earlier mma.sync flash_attention (PERF.md)")
    print(f"[lm] lotaru next-token prediction {mean * 1e3!r} ms +- "
          f"{std * 1e3!r} ms (steps measured, ms: "
          f"{[round(float(x), 3) for x in dec]})")


def lm_cut_checks(dev) -> None:
    """Full width, depth cut to one (r, r, l) cycle, float32: the card's
    prefill logits against the port's CPU run on the same weights, and
    prefill of S against prefill of S - 1 plus one decode step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import replace
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import decode_step, forward, init_params
    cfg = replace(get_config(LM_ARCH), num_layers=3, dtype="float32")
    t0 = time.perf_counter()
    # made on the card and copied down: the host's generator was most of
    # this check's time
    p_dev = init_params(LM_CUT_SEED, cfg, dev)
    p_cpu = tree_to(p_dev, "cpu")
    tok = torch.from_numpy(make_batch(DataConfig(cfg.vocab_size, LM_CUT_S,
                                                 1, seed=LM_CUT_SEED),
                                      0)["tokens"])
    print(f"[lm] float32 checks at full width, depth 3 (cut from 38: one "
          f"(r, r, l) cycle), weights made on the card from seed "
          f"{LM_CUT_SEED} and copied to the host "
          f"({time.perf_counter() - t0:.1f} s)")
    with torch.inference_mode():
        t_cpu = time.perf_counter()
        want, _ = forward(p_cpu, cfg, {"tokens": tok})
        t_cpu = time.perf_counter() - t_cpu
        got, _ = forward(p_dev, cfg, {"tokens": tok.to(dev)})
        torch.cuda.synchronize()
        err, ratio = tol_check(got.cpu(), want, LOGIT_TOL)
        print(f"[lm] prefill logits S={LM_CUT_S}, card vs the CPU run on "
              f"the same weights: max |err| {err!r}, |err| / (atol + rtol "
              f"|want|) {ratio!r} (tolerance {LOGIT_TOL['rtol']}/"
              f"{LOGIT_TOL['atol']}), max |logit| "
              f"{float(want.abs().max())!r}, the CPU forward "
              f"{t_cpu:.1f} s")
        check(ratio <= 1.0, "the card's prefill logits differ from the CPU "
              "run's")
        del want
        _, _, cache = forward(p_dev, cfg, {"tokens": tok[:, :-1].to(dev)},
                              mode="prefill")
        step, _ = decode_step(p_dev, cfg, tok[:, -1:].to(dev), cache,
                              LM_CUT_S - 1)
        err, ratio = tol_check(step[:, 0], got[:, -1], DECODE_TOL)
    print(f"[lm] prefill S={LM_CUT_S} vs prefill S-1 + one decode step "
          f"(ring of {cfg.window} slots): max |err| {err!r}, |err| / (atol "
          f"+ rtol |want|) {ratio!r} (tolerance {DECODE_TOL['rtol']}/"
          f"{DECODE_TOL['atol']})")
    check(ratio <= 1.0, "decode after prefill differs from the prefill")


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def lm_profile(dev) -> None:
    """Where the serve path's device time goes: one prefill and
    LM_PROFILE_STEPS decode steps under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.serve import _grow
    from repro_torch.models import init_params
    from repro_torch.train.train_step import (make_decode_step,
                                              make_prefill_step)
    cfg = get_config(LM_ARCH)
    params = init_params(LM_SEED, cfg, dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    tok = torch.from_numpy(make_batch(DataConfig(cfg.vocab_size, LM_PROMPT,
                                                 LM_BATCH, seed=LM_SEED),
                                      0)["tokens"]).to(dev)
    with torch.inference_mode():
        prefill(params, {"tokens": tok})          # warm
        torch.cuda.synchronize()

        def window(label, fn):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                host = time.perf_counter() - t0
            # device-side entries only (kernels, copies, sets): the CPU
            # ops that launched them carry the same time again.  "Command
            # Buffer Full" is CUPTI's mark of a host stalled on a full
            # launch queue, not device work.
            evts = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.self_device_time_total > 0
                    and e.key != "Command Buffer Full"]
            busy = sum(e.self_device_time_total for e in evts) / 1e3
            top = sorted(evts, key=lambda e: -e.self_device_time_total)[:6]
            print(f"[lm] profile, {label}: {host * 1e3!r} ms host clock, "
                  f"{busy!r} ms of kernels, busy share "
                  f"{busy / (host * 1e3)!r}, "
                  f"{sum(e.count for e in evts)} device entries; top (name, ms, "
                  f"calls) {[(e.key[:48], round(e.self_device_time_total / 1e3, 3), e.count) for e in top]}")
            return out

        logits, cache = window("prefill", lambda: prefill(params,
                                                          {"tokens": tok}))
        cache = _grow(cache, LM_PROMPT, LM_PROFILE_STEPS)
        nxt = torch.argmax(logits, -1)[:, None]

        def steps():
            c, t = cache, nxt
            for i in range(LM_PROFILE_STEPS):
                lg, c = decode(params, t, c, LM_PROMPT + i)
                t = torch.argmax(lg, -1)[:, None]
            return t
        window(f"{LM_PROFILE_STEPS} decode steps", steps)


def flops_flash(b, s, h, hd, window) -> int:
    """Operations of one causal attention over the visible band: 4 hd per
    (query, key) pair (q.k and p.v, a multiply and an add each)."""
    i = np.arange(s)
    pairs = int(np.minimum(i + 1, window).sum() if window > 0
                else (i + 1).sum())
    return 4 * hd * pairs * b * h


def bounds_flash(b, s, h, kh, hd, window, itemsize) -> tuple:
    """Least time for one attention: the operations of the visible band
    at the bfloat16 tensor-core rate, or q, k, v read and the output
    written once."""
    t_ops = flops_flash(b, s, h, hd, window) / H100_BF16_FLOPS * 1e3
    t_bytes = (2 * b * s * h * hd + 2 * b * s * kh * hd) * itemsize \
        / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes \
        else "bytes"


def bounds_scan(b, t, w) -> tuple:
    """Least time for one scan: a and gx read and h written (12 B per
    element), h0 read; two float32 operations per element."""
    t_bytes = (12 * b * t * w + 4 * b * w) / H100_BYTES_PER_S * 1e3
    t_ops = 2 * b * t * w / H100_FP32_FLOPS * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def report_lm(dev, launches, errors) -> list:
    """Times of both LM kernels at the serve path's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as scan
    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(23)
    b, s, h, kh, hd, w = (LM_BATCH, LM_PROMPT, cfg.num_heads,
                          cfg.num_kv_heads, cfg.head_dim, cfg.window)
    q, k, v = attention_inputs(gen, b, s, h, kh, hd, torch.bfloat16, dev)
    o = torch.empty_like(q)
    launch = raw_launch("flash_attention", [q, k, v, o, 1, b, s, s, h, kh,
                                            hd, 1, w, None], flash._lib())
    fa = {"ms": time_ms(launch, reps=10), "warm_ms": warm_ms(launch, reps=5,
                                                             inner=3),
          "wrapper_ms": time_ms(lambda: flash.flash_attention(
              q, k, v, causal=True, window=w), reps=10, host=True),
          "plain_ms": time_ms(lambda: ref.attention_ref(
              q, k, v, causal=True, window=w), reps=3, host=True)}
    # the library call: SDPA over the band as a boolean mask, on heads-first
    # copies with the kv head expanded (layout set-up, untimed)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).expand(b, h, s, hd).contiguous()
              for x in (k, v))
    mask = ref.band_mask(s, s, True, w, dev)
    fa["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), reps=10)
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    diff = float((sdpa.transpose(1, 2).float()
                  - flash.flash_attention(q, k, v, causal=True,
                                          window=w).float()).abs().max())
    fa["bound_ms"], fa["bound_by"] = bounds_flash(b, s, h, kh, hd, w, 2)
    fa["tflops"] = flops_flash(b, s, h, hd, w) / (fa["ms"] * 1e-3) / 1e12
    fa["warm_tflops"] = (flops_flash(b, s, h, hd, w) / (fa["warm_ms"] * 1e-3)
                         / 1e12)
    fa["kernel_route"] = flash.flash_route(q.dtype, h, kh)
    print(f"[report] flash_attention B={b} S={s} H={h} K={kh} hd={hd} "
          f"window={w} bfloat16: {fa}; SDPA on the same band differs from "
          f"it by at most {diff!r}")
    del q, k, v, o, qt, kt, vt, sdpa

    t, wd = LM_PROMPT, cfg.rglru_width
    a = torch.rand((b, t, wd), generator=gen, device=dev) * 0.3 + 0.699
    gx = torch.randn((b, t, wd), generator=gen, device=dev) * 0.1
    h0 = torch.zeros((b, wd), device=dev)
    hh = torch.empty_like(a)
    launch = raw_launch("rglru_scan", [a, gx, h0, hh, b, t, wd],
                        scan._lib())
    rs = {"ms": time_ms(launch), "warm_ms": warm_ms(launch),
          "wrapper_ms": time_ms(lambda: scan.rglru_scan(a, gx, h0),
                                host=True),
          "plain_ms": time_ms(lambda: ref.rglru_scan_ref(a, gx, h0), reps=3,
                              host=True),
          "library_ms": None}
    rs["bound_ms"], rs["bound_by"] = bounds_scan(b, t, wd)
    print(f"[report] rglru_scan B={b} T={t} W={wd}: {rs}")
    return [
        dict({"name": "flash_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention.py:84",
              "launches": launches["flash_attention"],
              "max_abs_err": errors["flash_attention"][0],
              "tolerance": "rtol 1e-2 atol 4e-3 (bfloat16; also within "
                           "5e-2/5e-2)",
              "tol_ratio": errors["flash_attention"][1],
              "shape": f"B={b} S={s} H={h} K={kh} hd={hd} window={w} bf16"},
             **fa),
        dict({"name": "rglru_scan", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
              "replaces": "src/repro/kernels/rglru_scan.py:48",
              "launches": launches["rglru_scan"],
              "max_abs_err": errors["rglru_scan"][0],
              "tolerance": "bitwise", "tol_ratio": 0.0,
              "shape": f"B={b} T={t} W={wd} f32"}, **rs),
    ]


# ---------------------------------------------------------------------------
# training: the backward kernels and the train path
# ---------------------------------------------------------------------------
TRAIN_ARCH = "smollm-360m"
TRAIN_BATCH, TRAIN_SEQ = 8, 2048           # SmolLM's pretraining context
LSE_TOL = dict(rtol=1e-5, atol=1e-4)       # float32 row statistics


def train_attention_cases():
    """(label, B, S, H, K, hd, window, causal): the two training paths'
    shapes (SmolLM-360M's 15 heads over 5 at hd 64, causal; RecurrentGemma-
    9B's 16 heads over 1 at hd 256, window 2048), then the forward's edges
    (phase_lm_kernels)."""
    return (
        ("smollm path", TRAIN_BATCH, TRAIN_SEQ, 15, 5, 64, 0, True),
        ("recurrentgemma path", 1, 4096, 16, 1, 256, 2048, True),
        ("ragged S", 2, 1000, 16, 1, 256, 2048, True),
        ("ragged S, hd 64", 2, 1001, 15, 5, 64, 0, True),
        ("window 1", 2, 1000, 16, 1, 256, 1, True),
        ("window 64", 2, 1000, 16, 1, 256, 64, True),
        ("not causal", 2, 1000, 16, 1, 256, 0, False),
        ("not causal, window 64", 1, 1000, 16, 1, 256, 64, False),
        ("GQA group 2", 2, 1000, 16, 8, 256, 100, True),
        ("GQA group 3", 2, 1000, 12, 4, 256, 100, True),
        ("MHA K=16", 2, 1000, 16, 16, 256, 2048, True),
        ("hd 64, GQA group 3, window 64", 2, 1000, 12, 4, 64, 64, True),
        ("hd 128", 2, 1000, 16, 1, 128, 100, True),
        ("hd 128, MHA, not causal", 2, 1000, 16, 16, 128, 0, False))


def phase_train_kernels(dev) -> dict:
    """The backward kernels against their plain versions on the card:
    `flash_attention`'s forward with lse bitwise the forward without it
    and its lse within LSE_TOL of the plain one; `flash_attention_bwd` at
    both training paths' shapes and the forward's edges, bf16 at both
    bf16 limits and f32 at 2e-5, bitwise across two launches;
    `rglru_scan_bwd` bitwise its plain version and across two launches."""
    import torch
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as scan
    gen = torch.Generator(device=dev).manual_seed(29)
    out = {}
    for b, t, w, label in ((1, 4096, 4096, "recurrentgemma path"),
                           (LM_BATCH, LM_PROMPT, 4096, "serve shape"),
                           (2, 1001, 136, "ragged")):
        a = torch.rand((b, t, w), generator=gen, device=dev) * 0.3 + 0.699
        gx = torch.randn((b, t, w), generator=gen, device=dev) * 0.1
        h0 = torch.randn((b, w), generator=gen, device=dev)
        g = torch.randn((b, t, w), generator=gen, device=dev)
        h = scan.rglru_scan(a, gx, h0)
        got = scan.rglru_scan_bwd(a, h, h0, g)
        again = scan.rglru_scan_bwd(a, h, h0, g)
        want = ref.rglru_scan_bwd_ref(a, h, h0, g)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(x, y) for x, y in zip(got, want))
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        print(f"[kernels] rglru_scan_bwd {label} B={b} T={t} W={w}, h0 != 0: "
              f"bitwise vs plain (on the card) {bitwise}, bitwise across two "
              f"launches {repeat}, max |err| {err!r}")
        check(bitwise and repeat, "rglru_scan_bwd differs from its plain "
              "version or from its own second launch")
        if label == "recurrentgemma path":
            out["rglru_scan_bwd"] = (err, 0.0)
        del a, gx, h0, g, h, got, again, want

    smem = {}
    for hd in flash.HEAD_DIMS:
        for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            c_bytes = [flash._bwd_lib().lotaru_flash_bwd_smem_bytes(hd, w,
                                                                    code)
                       for w in (0, 1)]
            smem[(hd, str(dt)[6:])] = c_bytes
            check(c_bytes == [flash.bwd_smem_bytes(hd, w, dt)
                              for w in (0, 1)],
                  f"bwd_smem_bytes differs from C at hd={hd}, {dt}: "
                  f"{c_bytes}")
    print(f"[kernels] flash_attention_bwd: bwd_smem_bytes (dK/dV, dQ) by "
          f"(hd, dtype) {smem} equal to the C formulas")
    bf16, f32 = torch.bfloat16, torch.float32
    for label, b, s, h, kh, hd, w, causal in train_attention_cases():
        for dt in (bf16, f32):
            if dt == f32 and "path" not in label and hd != 64:
                continue                 # f32 at the paths and at hd 64
            q, k, v = attention_inputs(gen, b, s, h, kh, hd, dt, dev)
            o_plain = flash.flash_attention(q, k, v, causal=causal, window=w)
            o, lse = flash.flash_attention(q, k, v, causal=causal, window=w,
                                           with_lse=True)
            do = torch.randn(o.shape, generator=gen, device=dev).to(dt)
            got = flash.flash_attention_bwd(q, k, v, o, do, lse,
                                            causal=causal, window=w)
            again = flash.flash_attention_bwd(q, k, v, o, do, lse,
                                              causal=causal, window=w)
            _, lse_want = ref.attention_fwd_ref(q, k, v, causal=causal,
                                                window=w)
            want = ref.attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                         window=w)
            torch.cuda.synchronize()
            same_o = torch.equal(o, o_plain)
            repeat = all(torch.equal(x, y) for x, y in zip(got, again))
            _, lse_ratio = tol_check(lse, lse_want, LSE_TOL)
            check(same_o, f"flash_attention with lse differs from it without "
                  f"({label}, {dt})")
            check(lse_ratio <= 1.0, f"flash_attention's lse outside {LSE_TOL} "
                  f"of the plain one ({label}, {dt})")
            check(repeat, f"flash_attention_bwd differs across two launches "
                  f"({label}, {dt})")
            tols = (F32_TOL,) if dt == f32 else (BF16_TOL, BF16_KERNEL_TOL)
            for tol in tols:
                errs = [tol_check(x, y, tol) for x, y in zip(got, want)]
                err = max(e for e, _ in errs)
                ratio = max(r for _, r in errs)
                print(f"[kernels] flash_attention_bwd {label} B={b} S={s} "
                      f"H={h} K={kh} hd={hd} window={w} causal={causal} "
                      f"{str(dt)[6:]}, {flash.bwd_route(dt, hd)} route: dq, "
                      f"dk, dv vs plain (on the card) "
                      f"within {tol['rtol']}/{tol['atol']} {ratio <= 1.0}, "
                      f"max |err| {err!r}, |err| / (atol + rtol |want|) "
                      f"{[round(r, 4) for _, r in errs]}; bitwise across two "
                      f"launches {repeat}; the forward with lse bitwise "
                      f"without {same_o}, lse ratio {lse_ratio!r}")
                check(ratio <= 1.0, f"flash_attention_bwd ({label}, {dt}) "
                      f"outside {tol} of its plain version")
            if label == "smollm path" and dt == bf16:
                out["flash_attention_bwd"] = (err, ratio)
            del q, k, v, o, o_plain, lse, do, got, again, want, lse_want
            torch.cuda.empty_cache()
    return out


TRAIN_STEPS = 30                # steps of the timed run and of the restart
TRAIN_KILL_AFTER = 15           # the child is killed after this step, once
                                # its first checkpoint (step 10) is on disk
TRAIN_LOG_EVERY = 5
TRAIN_PROFILE_STEPS = 8         # profile_step_time: 4 batch sizes, 2 steps
TRAIN_SEED = 3                  # the gradient checks' weights and tokens
RESUME_RTOL = 1e-3
# A training step's gradients, kernel route against plain route on the
# card: each leaf's ||g_kernel - g_plain|| / ||g_plain||.  The routes
# differ by the kernels' summation order and, in bf16, by the forward
# kernel rounding P to bf16 before P.V (the plain version keeps it
# float32), carried through every layer: the bf16 limit is the reference's
# bf16 kernel tolerance (tests/test_kernels.py, 5e-2), the f32 limit its
# logit tolerance (1e-4).
GRAD_TOL = {"bfloat16": 5e-2, "float32": 1e-4}


def train_argv(ckpt_dir: str, skip_profile: bool, log_every: int) -> list:
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-dir", ckpt_dir,
            "--log-every", str(log_every)]
    return argv + (["--skip-profile"] if skip_profile else [])


def killed_run(ckpt_dir: str) -> tuple:
    """`python -m repro_torch.launch.train` in a child process on the card,
    SIGKILLed at the first step past TRAIN_KILL_AFTER once a checkpoint is
    on disk (a node lost mid-run) -> (the newest checkpoint it left, the
    last step it printed)."""
    from repro_torch.train.checkpoint import latest_step
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train",
         *train_argv(ckpt_dir, True, 1)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
    last = None
    try:
        for line in proc.stdout:
            if line.startswith("step"):
                last = int(line.split()[1])
                if last >= TRAIN_KILL_AFTER and latest_step(ckpt_dir):
                    proc.kill()
                    break
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()
    return latest_step(ckpt_dir), last


def route_grads(params, cfg, batch, plain: bool) -> tuple:
    """One step's loss and gradient leaves on the kernel route or, with
    `plain`, with kernels.ops' two kernels replaced by their plain
    versions on the card (FlashAttention / RGLRUScan with plain=True)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import loss_fn
    from repro_torch.train.optimizer import tree_items
    saved = ops.flash_attention, ops.rglru_scan
    if plain:
        ops.flash_attention = lambda q, k, v, causal=True, window=0: \
            ops.FlashAttention.apply(q, k, v, causal, window, True)
        ops.rglru_scan = lambda a, gx, h0: ops.RGLRUScan.apply(a, gx, h0,
                                                               True)
    try:
        items = list(tree_items(params))
        leaves = [leaf.requires_grad_() for _, leaf in items]
        loss, _ = loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        ops.flash_attention, ops.rglru_scan = saved
        for leaf in leaves:
            leaf.requires_grad_(False)
    return float(loss.detach()), {"/".join(p): g
                                  for (p, _), g in zip(items, grads)}


def grad_check(dev, label: str, cfg, b: int, s: int) -> None:
    """Loss and every gradient leaf of one step, kernel route against
    plain route on the card, at GRAD_TOL; every real-head and RG-LRU leaf
    with a non-zero gradient, the pad heads' rows exactly zero."""
    import torch
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import init_params
    params = init_params(TRAIN_SEED, cfg, dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        DataConfig(cfg.vocab_size, s, b, seed=TRAIN_SEED), 0).items()}
    t0 = time.perf_counter()
    loss_k, gk = route_grads(params, cfg, batch, plain=False)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    loss_p, gp = route_grads(params, cfg, batch, plain=True)
    torch.cuda.synchronize()
    tol = GRAD_TOL[cfg.dtype]
    worst, zero, pad_max = ("", 0.0), [], 0.0
    hp, h = cfg.padded_heads, cfg.num_heads
    for name, g in gk.items():
        want = gp[name].float()
        rel = float((g.float() - want).norm() / want.norm().clamp_min(1e-30))
        if rel > worst[1]:
            worst = (name, rel)
        real = g
        if hp != h and name.endswith(("attn/wq", "attn/wo")):
            pad = g[..., h:, :] if name.endswith("wq") else g[..., h:, :, :]
            pad_max = max(pad_max, float(pad.abs().max()))
            real = g[..., :h, :] if name.endswith("wq") else g[..., :h, :, :]
        if name.split("/")[-2:-1] in (["attn"], ["mix"]) and not bool(
                (real.float().abs().amax(dim=tuple(range(1, real.dim())))
                 > 0).all()):
            zero.append(name)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    print(f"[train] gradients {label} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}) B={b} S={s}, kernel route vs plain "
          f"route on the card: loss {loss_k!r} vs {loss_p!r} (relative "
          f"{rel_loss!r}); worst leaf ||diff|| / ||plain|| {worst[1]!r} "
          f"({worst[0]}), limit {tol}; {len(gk)} leaves; attention and "
          f"RG-LRU leaves with a zero gradient in some layer: {zero}; pad "
          f"heads' rows max |grad| {pad_max!r}; the kernel route's step "
          f"{t_k!r} s")
    check(rel_loss <= tol and worst[1] <= tol,
          f"{label}: the kernel route's loss or gradients differ from the "
          f"plain route's by more than {tol}")
    check(not zero, f"{label}: a real-head or RG-LRU leaf has no gradient")
    check(pad_max == 0.0, f"{label}: a pad head's row has a gradient")


def train_profile(dev) -> None:
    """Where a SmolLM training step's device time goes: one step (after a
    warm one) under torch.profiler: busy share, the top kernels, and the
    attention kernels' sums (the backward's three kernels, the forward)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    cfg = get_config(TRAIN_ARCH)
    oc = OptConfig(warmup_steps=5, total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, oc)
    state = {"opt": init_opt_state(init_params(TRAIN_SEED, cfg, dev), oc)}
    data = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=TRAIN_SEED),
        0).items()}
    state, _ = step(state, data)                      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, data)
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    evts = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and e.key != "Command Buffer Full"]
    busy = sum(e.self_device_time_total for e in evts) / 1e3

    def ms(*names):
        return sum(e.self_device_time_total for e in evts
                   if any(n in e.key for n in names)) / 1e3
    top = sorted(evts, key=lambda e: -e.self_device_time_total)[:8]
    print(f"[train] profile, one {TRAIN_ARCH} step B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ}: {host * 1e3!r} ms host clock, {busy!r} ms of "
          f"kernels, busy share {busy / (host * 1e3)!r}; flash_attention_bwd "
          f"{ms('dkdv_', 'dq_kernel', 'dq_mma_kernel', 'delta_kernel')!r} ms "
          f"(dK/dV {ms('dkdv_')!r}, dQ {ms('dq_kernel', 'dq_mma_kernel')!r}, "
          f"D {ms('delta_kernel')!r}), flash_attention "
          f"{ms('flash_attention_ws_kernel')!r} ms; {sum(e.count for e in evts)}"
          f" device entries; top (name, ms, calls) "
          f"{[(e.key[:48], round(e.self_device_time_total / 1e3, 3), e.count) for e in top]}")


def phase_train(dev) -> dict:
    """The training path: SmolLM-360M at full size through
    repro_torch.launch.train.main (the Lotaru profile, TRAIN_STEPS AdamW
    steps, checkpoints), a child run killed after step TRAIN_KILL_AFTER
    and restarted on its directory (losses against the uninterrupted
    run's), then one step's gradients, kernel route against plain route,
    for SmolLM (2 layers) and RecurrentGemma-9B (one cycle, S = 4096 past
    the window, B = 1) at full width, bf16 and f32."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import replace
    from repro_torch.launch import train
    from repro_torch.models import param_count_exact
    from repro_torch.perf.roofline import PEAK_FLOPS, model_flops
    cfg = get_config(TRAIN_ARCH)
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.empty(0, device=dev)          # a context for the memory stats
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        losses = train.main(train_argv(os.path.join(work, "a"), False,
                                       TRAIN_LOG_EVERY))
        t_run = time.perf_counter() - t0
        stats = dict(train.main.stats)
        peak = torch.cuda.max_memory_allocated(dev)
        step_s = np.asarray(stats["step_s"])
        med = float(np.median(step_s[1:]))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        n_params = param_count_exact(cfg)
        mfu = model_flops(n_params, tokens, "train") / med / PEAK_FLOPS
        check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
              "the training run's losses are not all finite")
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        check(last < first, "the training loss did not fall")
        print(f"[train] {TRAIN_ARCH} on the card, full size ({cfg.num_layers} "
              f"layers, d_model {cfg.d_model}, {n_params} parameters, "
              f"{cfg.dtype} compute, float32 master and moments): B="
              f"{TRAIN_BATCH} S={TRAIN_SEQ} ({tokens} tokens a step), "
              f"{TRAIN_STEPS} AdamW steps after the profile, {t_run!r} s in "
              f"all; loss mean of the first 5 steps {first!r}, of the last 5 "
              f"{last!r}")
        print(f"[train] step median {med * 1e3!r} ms (the first step "
              f"{float(step_s[0]) * 1e3!r} ms excluded; min "
              f"{float(step_s.min()) * 1e3!r}, max "
              f"{float(step_s[1:].max()) * 1e3!r}), {tokens / med!r} tokens/s, "
              f"model-flop utilisation {mfu!r} (6 N D / step / "
              f"{PEAK_FLOPS:.4g} FLOP/s), max_memory_allocated {peak} bytes")
        print(f"[train] lotaru predicted step {stats['predicted_step_s'] * 1e3!r}"
              f" ms +- {stats['predicted_std_s'] * 1e3!r} ms beside the "
              f"measured median {med * 1e3!r} ms; profile points (tokens, "
              f"s) {stats['profile']}; young-daly interval "
              f"{stats['ckpt_interval']} steps")
        check(stats["predicted_step_s"] > 0, "no Lotaru prediction")

        # a node lost mid-run, then the restart on its directory
        torch.cuda.empty_cache()            # the child's memory
        b_dir = os.path.join(work, "b")
        t0 = time.perf_counter()
        saved, killed_at = killed_run(b_dir)
        t_kill = time.perf_counter() - t0
        check(saved is not None and killed_at is not None
              and saved <= killed_at < TRAIN_STEPS,
              f"the child left no checkpoint before it was killed (last "
              f"step {killed_at}, checkpoint {saved})")
        t0 = time.perf_counter()
        resumed = train.main(train_argv(b_dir, True, TRAIN_LOG_EVERY))
        t_resume = time.perf_counter() - t0
        start = train.main.stats["start"]
        check(start == saved, f"the restart resumed at {start}, not at the "
              f"saved step {saved}")
        want = np.asarray(losses[start:])
        got = np.asarray(resumed)
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        print(f"[train] restart: the child killed after step "
              f"{killed_at} ({t_kill!r} s) left step {saved}; main "
              f"on its directory resumed at {start} and ran "
              f"{len(resumed)} steps ({t_resume!r} s): losses against the "
              f"uninterrupted run's, max relative {rel!r} (limit "
              f"{RESUME_RTOL}), bitwise {bool(np.array_equal(got, want))}")
        check(len(got) == len(want) and rel <= RESUME_RTOL,
              "the resumed losses differ from the uninterrupted run's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    for dt in ("bfloat16", "float32"):
        grad_check(dev, TRAIN_ARCH, replace(cfg, num_layers=2, dtype=dt),
                   TRAIN_BATCH, TRAIN_SEQ)
        torch.cuda.empty_cache()
    rg = get_config(LM_ARCH)
    for dt in ("bfloat16", "float32"):
        grad_check(dev, LM_ARCH, replace(rg, num_layers=3, dtype=dt), 1,
                   LM_PROMPT)
        torch.cuda.empty_cache()
    return {"steps": TRAIN_PROFILE_STEPS + TRAIN_STEPS + len(resumed),
            "grad_cfgs": ((2, 0), (2, 0), (1, 2), (1, 2))}


def flops_flash_bwd(b, s, h, hd, window) -> int:
    """Operations of one attention backward over the visible band: 10 hd
    per (query, key) pair (S recomputed, dP = dO V^T, dV, dQ and dK, a
    multiply and an add each; the kernel recomputes S and dP once more in
    its dQ pass, 14 hd, which the bound does not count)."""
    return flops_flash(b, s, h, hd, window) // 4 * 10


def bounds_flash_bwd(b, s, h, kh, hd, window, itemsize) -> tuple:
    """Least time for one attention backward: its operations at the bf16
    tensor-core rate, or q, k, v, o, dO and lse read and dq, dk, dv
    written once."""
    t_ops = flops_flash_bwd(b, s, h, hd, window) / H100_BF16_FLOPS * 1e3
    t_bytes = ((4 * b * s * h * hd + 4 * b * s * kh * hd) * itemsize
               + 4 * b * h * s) / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes \
        else "bytes"


def bounds_scan_bwd(b, t, w) -> tuple:
    """Least time for one scan backward: a, h and g read, da and dgx
    written (20 B per element), h0 read and dh0 written; three float32
    operations per element."""
    t_bytes = (20 * b * t * w + 8 * b * w) / H100_BYTES_PER_S * 1e3
    t_ops = 3 * b * t * w / H100_FP32_FLOPS * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def sdpa_bwd_ms(q, k, v, do, window: int) -> float:
    """SDPA's backward alone on heads-first copies (set-up untimed): causal
    with grouped kv heads (`enable_gqa`) when window is 0, else over the
    band as a boolean mask with the kv heads expanded."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    b, s, h, hd = q.shape
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    dot = do.transpose(1, 2).contiguous()
    if window == 0:
        kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (k, v))
        try:
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
        except TypeError:           # a torch before enable_gqa: expanded
            kt, vt = (x.repeat_interleave(h // x.shape[1], 1).detach()
                      .requires_grad_() for x in (kt, vt))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    else:
        kt, vt = (x.transpose(1, 2).expand(b, h, s, hd).contiguous()
                  .requires_grad_() for x in (k, v))
        out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=ref.band_mask(s, s, True, window, q.device))
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True), reps=10)


def report_train(dev, launches, errors) -> list:
    """Times of both backward kernels at the training paths' shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as scan
    gen = torch.Generator(device=dev).manual_seed(31)
    rows = {}
    for label, b, s, h, kh, hd, w, _ in train_attention_cases()[:2]:
        q, k, v = attention_inputs(gen, b, s, h, kh, hd, torch.bfloat16, dev)
        o, lse = flash.flash_attention(q, k, v, causal=True, window=w,
                                       with_lse=True)
        do = torch.randn(o.shape, generator=gen, device=dev).to(o.dtype)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
        launch = raw_launch("flash_attention_bwd",
                            [q, k, v, o, do, lse, delta, dq, dk, dv, 1, b, s,
                             s, h, kh, hd, 1, w], flash._bwd_lib())
        fa = {"ms": time_ms(launch, reps=10),
              "wrapper_ms": time_ms(lambda: flash.flash_attention_bwd(
                  q, k, v, o, do, lse, causal=True, window=w), reps=10,
                  host=True),
              "plain_ms": time_ms(lambda: ref.attention_bwd_ref(
                  q, k, v, o, do, lse, causal=True, window=w), reps=3,
                  host=True),
              "library_ms": sdpa_bwd_ms(q, k, v, do, w),
              "forward_ms": time_ms(lambda: flash.flash_attention(
                  q, k, v, causal=True, window=w), reps=10)}
        fa["bound_ms"], fa["bound_by"] = bounds_flash_bwd(b, s, h, kh, hd, w,
                                                          2)
        fa["tflops"] = (flops_flash_bwd(b, s, h, hd, w) / (fa["ms"] * 1e-3)
                        / 1e12)
        fa["kernel_route"] = flash.bwd_route(q.dtype, hd)
        print(f"[report] flash_attention_bwd {label} B={b} S={s} H={h} "
              f"K={kh} hd={hd} window={w} bfloat16: {fa}")
        rows[label] = (fa, f"B={b} S={s} H={h} K={kh} hd={hd} window={w} "
                           f"bf16")
        del q, k, v, o, lse, do, dq, dk, dv, delta
        torch.cuda.empty_cache()

    b, t, wd = 1, LM_PROMPT, get_config(LM_ARCH).rglru_width
    a = torch.rand((b, t, wd), generator=gen, device=dev) * 0.3 + 0.699
    h = torch.randn((b, t, wd), generator=gen, device=dev)
    g = torch.randn((b, t, wd), generator=gen, device=dev)
    h0 = torch.zeros((b, wd), device=dev)
    da, dgx, dh0 = (torch.empty_like(x) for x in (a, a, h0))
    launch = raw_launch("rglru_scan_bwd", [a, h, h0, g, da, dgx, dh0, b, t,
                                           wd], scan._lib())
    rs = {"ms": time_ms(launch), "warm_ms": warm_ms(launch),
          "wrapper_ms": time_ms(lambda: scan.rglru_scan_bwd(a, h, h0, g),
                                host=True),
          "plain_ms": time_ms(lambda: ref.rglru_scan_bwd_ref(a, h, h0, g),
                              reps=3, host=True),
          "library_ms": None}
    rs["bound_ms"], rs["bound_by"] = bounds_scan_bwd(b, t, wd)
    print(f"[report] rglru_scan_bwd B={b} T={t} W={wd}: {rs}")
    fa, shape = rows["smollm path"]
    return [
        dict({"name": "flash_attention_bwd", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
              "replaces": "none: the JAX package differentiates plain XLA "
                          "(src/repro/models/attention.py:69)",
              "launches": launches["flash_attention_bwd"],
              "max_abs_err": errors["flash_attention_bwd"][0],
              "tolerance": "rtol 1e-2 atol 4e-3 (bfloat16; also within "
                           "5e-2/5e-2; float32 2e-5)",
              "tol_ratio": errors["flash_attention_bwd"][1],
              "shape": shape}, **fa),
        dict({"name": "rglru_scan_bwd", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
              "replaces": "none: the JAX package differentiates its "
                          "associative scan (src/repro/models/rglru.py)",
              "launches": launches["rglru_scan_bwd"],
              "max_abs_err": errors["rglru_scan_bwd"][0],
              "tolerance": "bitwise", "tol_ratio": 0.0,
              "shape": f"B={b} T={t} W={wd} f32"}, **rs),
    ]


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"the port is not beside this script ({SRC}/repro_torch)")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: this script drives the port on a GPU")
    sys.path.insert(0, SRC)
    global H100_BYTES_PER_S, H100_BF16_FLOPS, H100_FP32_FLOPS, H100_FP64_FLOPS
    from repro_torch.perf import roofline
    H100_BYTES_PER_S, H100_BF16_FLOPS = roofline.HBM_BW, roofline.PEAK_FLOPS
    H100_FP32_FLOPS = roofline.PEAK_FLOPS_FP32
    H100_FP64_FLOPS = roofline.PEAK_FLOPS_FP64
    from repro_torch.configs import get_config
    from repro_torch.kernels import bayes_fit as kernels
    from repro_torch.kernels import decision_plane as plane
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as scan
    from repro_torch.kernels.bayes_fit import pad_ragged
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain fit's Gram
    torch.backends.cudnn.allow_tf32 = False         # products in full fp32
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase_build()
    if ONLY:
        # a short run of the named phases alone, for iterating on them; it
        # prints no kernels line and no result
        errs = {"flash_attention_bwd": (0.0, 0.0),
                "rglru_scan_bwd": (0.0, 0.0)}
        for name in ONLY:
            out = {"train-kernels": lambda: phase_train_kernels(dev),
                   "train": lambda: phase_train(dev),
                   "train-profile": lambda: train_profile(dev),
                   "report-train": lambda: report_train(
                       dev, {"flash_attention_bwd": 0, "rglru_scan_bwd": 0},
                       errs)}[name]()
            if name == "train-kernels":
                errs.update(out)
        print(f"[chip_smoke] only {ONLY}: "
              f"{time.perf_counter() - t_start:.1f} s")
        return
    fleet = pad_ragged(*fleet_buffers(np.random.default_rng(7), N_FLEET))
    errors = phase_kernels(dev, fleet)
    errors.update(phase_lm_kernels(dev))
    errors.update(phase_train_kernels(dev))

    counted = (("bayes_fit", kernels.bayes_fit),
               ("bayes_predict", kernels.bayes_predict),
               ("fused_cost", plane.fused_cost),
               ("eft_sweep", plane.eft_sweep),
               ("upward_rank", plane.upward_rank),
               ("eft_sweep_many", plane.eft_sweep_many),
               ("nig_fold", kernels.nig_fold),
               ("flash_attention", flash.flash_attention),
               ("rglru_scan", scan.rglru_scan),
               ("flash_attention_bwd", flash.flash_attention_bwd),
               ("rglru_scan_bwd", scan.rglru_scan_bwd))
    launches = dict.fromkeys((name for name, _ in counted), 0)
    sweep_routes = dict.fromkeys(plane.SWEEP_ROUTES, 0)
    rank_routes = dict.fromkeys(plane.RANK_ROUTES, 0)
    predict_q = {}                   # path -> {Q: bayes_predict launches}
    dispatch_predict = ops.bayes_predict

    def drive(path, label):
        """Run one main path with every count set to 0 just before it and
        read just after it; its bayes_predict launches are tallied by Q
        (at kernels.ops, through which the store's predictive reaches the
        kernel)."""
        tally = predict_q.setdefault(label, {})

        def tallied(batch):
            before = kernels.bayes_predict.launches
            out = dispatch_predict(batch)
            if kernels.bayes_predict.launches > before:
                tally[batch.q] = tally.get(batch.q, 0) + 1
            return out

        for _, fn in counted:
            fn.launches = 0
        for fn in (plane.eft_sweep, plane.eft_sweep_many):
            fn.launches_by_route = dict.fromkeys(plane.SWEEP_ROUTES, 0)
        plane.upward_rank.launches_by_route = dict.fromkeys(
            plane.RANK_ROUTES, 0)
        flash.flash_attention.route_launches = dict.fromkeys(flash.ROUTES, 0)
        flash.flash_attention_bwd.route_launches = dict.fromkeys(
            flash.BWD_ROUTES, 0)
        ops.bayes_predict = tallied
        try:
            out = path()
        finally:
            ops.bayes_predict = dispatch_predict
        got = {name: fn.launches for name, fn in counted}
        for name, n in got.items():
            launches[name] += n
        for route, n in plane.eft_sweep.launches_by_route.items():
            sweep_routes[route] += n
        for route, n in plane.upward_rank.launches_by_route.items():
            rank_routes[route] += n
        return out, got

    def on_shared_route(label):
        routes = plane.eft_sweep.launches_by_route
        print(f"[launches] {label} eft_sweep by route: {routes}")
        check(routes["global"] == 0 and routes["shared"] > 0,
              f"the {label} path's sweeps did not all take the shared route")

    _, got = drive(lambda: phase_paper(dev), "paper")
    print(f"[launches] paper: {got}")
    check(got["bayes_fit"] == 0, "the paper path launched bayes_fit")
    fleet_out, got = drive(lambda: phase_fleet(dev, fleet), "fleet")
    print(f"[launches] fleet: {got}")
    check(got["bayes_fit"] == 1,
          "the fleet refit did not make exactly one bayes_fit launch")
    plan, got = drive(lambda: phase_plan(dev, fleet_out), "plan")
    print(f"[launches] plan: {got}")
    check(got["fused_cost"] > 0 and got["eft_sweep"] > 0
          and 0 < got["upward_rank"] <= got["eft_sweep"],
          "the plan path launched fused_cost, eft_sweep or upward_rank no "
          "time, or more ranks than sweeps")
    on_shared_route("plan")
    ingest, got = drive(lambda: phase_ingest(dev, fleet_out), "ingest")
    print(f"[launches] ingest: {got}")
    check(all(got[k] > 0 for k in ("nig_fold", "bayes_predict",
                                   "fused_cost", "eft_sweep")),
          "the ingest path launched nig_fold, bayes_predict, fused_cost "
          "or eft_sweep no time")
    on_shared_route("ingest")
    pl, got = drive(lambda: phase_plane(dev, fleet_out), "plane")
    print(f"[launches] plane: {got}")
    check(got["bayes_predict"] > 0 and got["eft_sweep"] > 0,
          "the plane path launched bayes_predict or eft_sweep no time")
    on_shared_route("plane")
    rp, got = drive(lambda: phase_replan(dev, fleet_out), "replan")
    print(f"[launches] replan: {got}")
    print(f"[launches] replan eft_sweep_many by route: "
          f"{plane.eft_sweep_many.launches_by_route}")
    check(got["bayes_predict"] > 0 and got["upward_rank"] > 0
          and got["eft_sweep_many"] > 0 and got["eft_sweep"] == 0,
          "the replan path launched bayes_predict, upward_rank or "
          "eft_sweep_many no time, or a single-workflow sweep")
    ad, got = drive(lambda: phase_adaptive(dev), "adaptive")
    print(f"[launches] adaptive: {got}")
    check(got["bayes_predict"] > 0
          and got["upward_rank"] == ad["device_rounds"]
          and got["eft_sweep"] == ad["sweeps"] >= ad["device_rounds"]
          and all(got[k] == 0 for k in ("bayes_fit", "fused_cost",
                                        "eft_sweep_many", "nig_fold")),
          f"the adaptive path did not launch one upward_rank per device "
          f"round ({ad['device_rounds']}) and one eft_sweep per sweep "
          f"({ad['sweeps']}), bayes_predict, or launched a kernel off its "
          f"path")
    on_shared_route("adaptive")
    rf, got = drive(lambda: phase_refresh(dev, fleet_out, ingest), "refresh")
    print(f"[launches] refresh: {got}")
    check(got["bayes_fit"] == 1 and got["nig_fold"] > 0
          and got["bayes_predict"] == 2,
          "the refresh path did not launch bayes_fit once, nig_fold, and "
          "bayes_predict twice (the plane cold, then after the publish)")
    ck, got = drive(lambda: phase_checkpoint(dev, fleet_out, rf),
                    "checkpoint")
    print(f"[launches] checkpoint: {got}")
    check(got["bayes_predict"] > 0 and got["nig_fold"] > 0
          and got["bayes_fit"] >= 1 and got["upward_rank"] >= 1
          and got["eft_sweep"] >= ck["schedules"]
          and all(got[k] == 0 for k in ("fused_cost", "eft_sweep_many")),
          "the checkpoint path did not launch bayes_predict, nig_fold, "
          "bayes_fit (the attached refresher), upward_rank and an "
          "eft_sweep a plane schedule, or launched a kernel off its path")
    on_shared_route("checkpoint")
    _, got = drive(lambda: phase_serve(dev, fleet_out), "serve")
    print(f"[launches] serve: {got} (the in-process shards, client, "
          f"references and replica; the failover step's shard processes "
          f"launch in their own processes, not counted here)")
    check(got["bayes_predict"] > 0 and got["nig_fold"] > 0
          and got["bayes_fit"] >= 1
          and all(got[k] == 0 for k in ("fused_cost", "eft_sweep",
                                        "eft_sweep_many", "upward_rank")),
          "the serve path did not launch bayes_predict, nig_fold and "
          "bayes_fit (the refresh RPC), or launched a placement kernel "
          "(the tier places nothing)")
    _, got = drive(lambda: phase_lm(dev), "lm")
    print(f"[launches] lm: {got}")
    kinds = get_config(LM_ARCH).layer_kinds()
    check(got["flash_attention"] == kinds.count("local")
          and got["rglru_scan"] == kinds.count("rglru"),
          "the serve path did not launch flash_attention once per local "
          "attention layer and rglru_scan once per RG-LRU layer")
    routes = flash.flash_attention.route_launches
    print(f"[launches] lm flash_attention by route: {routes}")
    check(routes["wgmma_heads"] == got["flash_attention"],
          "the serve path's flash_attention launches did not all take the "
          "wgmma kernel's heads pairing")
    check(got["flash_attention_bwd"] == 0 and got["rglru_scan_bwd"] == 0,
          "the serve path launched a backward kernel")
    tr, got = drive(lambda: phase_train(dev), "train")
    print(f"[launches] train: {got}; flash_attention by route "
          f"{flash.flash_attention.route_launches}; flash_attention_bwd by "
          f"route {flash.flash_attention_bwd.route_launches}")
    layers = get_config(TRAIN_ARCH).num_layers
    want_attn = layers * tr["steps"] + sum(a for a, _ in tr["grad_cfgs"])
    want_scan = sum(r for _, r in tr["grad_cfgs"])
    check(got["flash_attention"] == got["flash_attention_bwd"] == want_attn
          and got["rglru_scan"] == got["rglru_scan_bwd"] == want_scan,
          f"the train path did not launch each forward and backward kernel "
          f"once per attention ({want_attn}) or RG-LRU ({want_scan}) layer "
          f"a step")
    print(f"[launches] main path: {launches}; eft_sweep by route "
          f"{sweep_routes}; upward_rank by route {rank_routes}")
    check(rank_routes == {"shared": launches["upward_rank"], "global": 0},
          "the main path's upward_rank launches did not all take the "
          "shared route")
    for label, tally in predict_q.items():
        print(f"[launches] {label} bayes_predict by Q: {q_buckets(tally)} "
              f"(median Q {median_q(tally)!r})" if tally
              else f"[launches] {label} bayes_predict: none")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    pieces = plan_breakdown(dev, fleet_out, plan)
    errors["eft_sweep"] = phase_plan_checks(dev, fleet_out, plan,
                                            pieces["args"])
    fold = phase_ingest_checks(dev, fleet_out, ingest)
    phase_plane_checks(dev, fleet_out, pl)
    rpc = phase_replan_checks(dev, fleet_out, rp)
    phase_copy_checks(dev, fleet_out)
    warm_round_pairs(dev, fleet_out, rp["problem"])
    errors.update({k: rpc[k] for k in ("upward_rank", "eft_sweep_many")})
    phase_refresh_checks(dev, fleet_out, ingest, rf)
    lm_cut_checks(dev)
    lm_profile(dev)
    train_profile(dev)
    report = phase_report(dev, launches, errors, fleet, fleet_out,
                          pieces["args"], fold, predict_q)
    report += report_replan(launches, errors, time_replan(dev, rpc))
    report += report_lm(dev, launches, errors)
    report += report_train(dev, launches, errors)
    print(f"[chip_smoke] {time.perf_counter() - t_start:.1f} s in all")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(json.dumps({"kernels": report}))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# `--only train-kernels,train,report-train` runs the build and those phases
# alone
ONLY = (sys.argv[sys.argv.index("--only") + 1].split(",")
        if "--only" in sys.argv else [])

if __name__ == "__main__":
    main()
