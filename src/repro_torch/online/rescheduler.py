"""In-flight HEFT rescheduling driven by streaming prediction drift.

The planner plugs into `workflow.simulator.execute_adaptive`: every
completion is fed to the OnlinePredictor; predictions for the not-yet-
started frontier are then re-evaluated in one batched service call (one
`bayes_predict` launch on the card).  When any task's new mean falls
outside the uncertainty band snapshotted at the last planning pass
(|new - ref| > z * ref_std), the frontier is re-planned with HEFT under
the updated posteriors — running tasks keep their nodes, data already
produced constrains ready times (finish + comm from the producing node to
each candidate).

Every planning pass goes through the resident decision plane: a
`FusedPlane` keeps the workflow's predictive rows, scaled matrix and cost
view on the service's device across passes and re-predicts only the rows
whose store blocks moved.  A pass schedules the frontier sub-DAG off the
plane's resident scaled pair (`FusedPlane.schedule`, which reindexes it to
the sub-DAG's topological order on the device), so on the "device" engine
W never crosses to the host: one `upward_rank` and one `eft_sweep` launch
place the frontier.  The drift bands and the speculation policy read the
host `PredictionMatrix` the same pass returns.  Schedules are bitwise the
reference planner's on every engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.extrapolation import MachineBench
from repro_torch.core.microbench import NodeSpec
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.online.events import PredictionQuery, TaskCompletion
from repro_torch.online.predictor import OnlinePredictor
from repro_torch.online.service import PredictionService
from repro_torch.sched.fused import FusedPlane, _context, _PlanContext
from repro_torch.sched.heft import Schedule
from repro_torch.sched.plane import PredictionMatrix, TaskDistribution
from repro_torch.sched.straggler import SpeculationDecision, decide_speculation
from repro_torch.store import DEFAULT_TENANT
from repro_torch.workflow.dag import TaskInstance, WorkflowDAG
from repro_torch.workflow.simulator import ExecRecord, SimState


@dataclass
class RescheduleStats:
    completions: int = 0
    drift_events: int = 0
    reschedules: int = 0


class OnlineReschedulingPlanner:
    def __init__(self, dag: WorkflowDAG, nodes: List[NodeSpec],
                 online: OnlinePredictor,
                 benches: Optional[Mapping[str, MachineBench]] = None,
                 z: float = 1.96, cooldown: int = 0,
                 store=None, tenant: str = DEFAULT_TENANT,
                 workflow: Optional[str] = None,
                 quantile: Optional[float] = None,
                 engine: str = "auto", device=DEFAULT_DEVICE):
        """z: band half-width in predictive stds; cooldown: minimum
        completions between two re-planning passes (0 = none); store: a
        shared PosteriorStore so several concurrent workflows/tenants serve
        from one stack (each planner binds the namespace tenant/workflow,
        defaulting workflow to dag.name — pass a run-unique workflow id
        when executing the same workflow type concurrently); quantile:
        schedule on the pessimistic mean + z*std at this quantile instead
        of the mean; engine: the HEFT engine ('auto' | 'numpy' | 'device',
        all bitwise equal, see sched.fused); device: where the service's
        predictive and the plane live ("cuda" raises without a card)."""
        self.dag = dag
        self.nodes = nodes
        self.online = online
        if benches:
            self.online.benches.update(benches)
        # the merged registry, so a planner built from an already-configured
        # OnlinePredictor needs no benches arg; z forwarded so the drift
        # band widens/narrows with the knob
        self.service = PredictionService(online, online.benches, z=z,
                                         device=device, store=store,
                                         tenant=tenant,
                                         workflow=workflow or dag.name)
        self.z = z
        self.cooldown = cooldown
        self.quantile = quantile
        self.engine = engine
        # resident decision plane over the WHOLE workflow: planning passes
        # re-predict only dirty rows; frontier cost views are row subsets
        # of the resident scaled pair, taken on the device
        self._plane = FusedPlane(self.service, nodes, dag=dag)
        self.stats = RescheduleStats()
        self._since_resched = 10 ** 9
        # uid -> (ref mean, ref std) on its currently-assigned node
        self._band: Dict[str, Tuple[float, float]] = {}
        self._assignment: Dict[str, str] = {}
        # last-planned matrix rows per uid (means/stds over all nodes) —
        # what the speculation policy reads for running tasks
        self._dist_rows: Dict[str, TaskDistribution] = {}

    # ---- one planning pass --------------------------------------------------
    def _plan(self, dag: WorkflowDAG, ready_at=None,
              node_available: Optional[Dict[str, float]] = None
              ) -> Tuple[Schedule, PredictionMatrix]:
        """Schedule `dag` (the workflow or a frontier sub-DAG) off the
        resident plane: one `matrix()` round, its cost view reindexed on
        the device.  -> (schedule, the round's host matrix)."""
        sched = self._plane.schedule(dag, ready_at=ready_at,
                                     node_available=node_available,
                                     quantile=self.quantile,
                                     engine=self.engine)
        mat = self._plane.last_matrix
        for u in dag.tasks:
            self._dist_rows[u] = mat.row(u)
        return sched, mat

    def _snapshot_bands(self, mat: PredictionMatrix,
                        assignment: Dict[str, str],
                        uids: Optional[set] = None) -> None:
        for uid, name in assignment.items():
            if uids is not None and uid not in uids:
                continue
            self._band[uid] = mat.on(uid, name)
        self._assignment.update(assignment)

    # ---- executor protocol --------------------------------------------------
    def initial_schedule(self) -> Schedule:
        sched, mat = self._plan(self.dag)
        self._band.clear()
        self._snapshot_bands(mat, sched.assignment)
        self._since_resched = 10 ** 9
        return sched

    def on_completion(self, rec: ExecRecord, state: SimState
                      ) -> Optional[Schedule]:
        t = self.dag.tasks[rec.uid]
        self.stats.completions += 1
        self._since_resched += 1
        if rec.attempt == 0:
            # failure re-runs (attempt > 0) span recovery downtime — their
            # wall time is not the task's runtime, so they never reach the
            # posterior
            self.online.observe(TaskCompletion(
                workflow=t.workflow, uid=rec.uid, task=t.task_name,
                node=rec.node, input_gb=t.input_gb,
                runtime_s=rec.finish - rec.start, finish_time=rec.finish))

        frontier = [u for u in self.dag.tasks if u not in state.started]
        if not frontier:
            return None
        # one batched predict over the frontier on its assigned nodes
        queries = [PredictionQuery(self.dag.tasks[u].task_name,
                                   self._assignment[u],
                                   self.dag.tasks[u].input_gb)
                   for u in frontier]
        preds = self.service.predict_batch(queries)
        drifted = False
        for u, (mean, _, _) in zip(frontier, preds):
            ref_mean, ref_std = self._band[u]
            if abs(mean - ref_mean) > self.z * max(ref_std, 1e-9):
                drifted = True
                break
        if not drifted:
            return None
        self.stats.drift_events += 1
        if self._since_resched <= self.cooldown:
            return None
        self._since_resched = 0
        self.stats.reschedules += 1
        return self._replan(state, set(frontier))

    # ---- speculation policy -------------------------------------------------
    def decide_speculation(self, uid: str, node: str, elapsed_s: float,
                           idle_nodes: List[NodeSpec],
                           q: float = 0.95) -> SpeculationDecision:
        """Uncertainty-driven straggler verdict for a running task, read
        from its last-planned decision-plane row (simulator protocol for
        `execute_adaptive(speculation=...)`)."""
        row = self._dist_rows.get(uid)
        if row is None or node not in row.node_names:
            return SpeculationDecision(threshold_s=float("inf"),
                                       speculate=False)
        return decide_speculation(elapsed_s, row, node, idle_nodes, q=q)

    # ---- frontier re-planning -----------------------------------------------
    def _frontier_dag(self, frontier: set
                      ) -> Tuple[WorkflowDAG, _PlanContext]:
        """The unstarted sub-DAG and its planning context (topo order,
        comm structure, rank tables), kept in the plane's rank cache."""
        sub = WorkflowDAG(self.dag.name)
        for u in self.dag.topo_order():
            if u not in frontier:
                continue
            t = self.dag.tasks[u]
            sub.add(TaskInstance(
                uid=u, task_name=t.task_name, workflow=t.workflow,
                input_gb=t.input_gb, output_gb=t.output_gb, sample=t.sample,
                deps=[d for d in t.deps if d in frontier]))
        return sub, _context(sub, self.nodes, self._plane.rank_cache)

    def _running_ends(self, state: SimState
                      ) -> Tuple[Dict[str, Tuple[str, float]],
                                 Dict[str, float]]:
        """Where and when every started task's output is ready, and when
        each node frees: finished tasks at their finish, running ones at
        start + predicted duration on their node (never before now), from
        one batched predict.  -> (done_at, node_available)."""
        running = list(state.running.items())
        run_preds = self.service.predict_batch(
            [PredictionQuery(self.dag.tasks[u].task_name, name,
                             self.dag.tasks[u].input_gb)
             for u, (name, _) in running])
        done_at: Dict[str, Tuple[str, float]] = dict(state.finished)
        node_avail = {n.name: state.now for n in self.nodes}
        for (u, (name, start)), (mean, _, _) in zip(running, run_preds):
            est_end = max(state.now, start + float(mean))
            done_at[u] = (name, est_end)
            node_avail[name] = max(node_avail[name], est_end)
        return done_at, node_avail

    def _ready_rows(self, ctx: _PlanContext, frontier: set,
                    done_at: Dict[str, Tuple[str, float]],
                    now: float) -> np.ndarray:
        """The frontier's external ready times as a (T, N) array in
        `ctx.order` rows: max(now, max over started deps d of end_d +
        comm_seconds(output_gb_d, node_of_d, node)), each cell bitwise the
        reference's per-(task, node) closure (max is exact; the comm term
        is `heft.comm_seconds`' own expression, 0 on the same node)."""
        ready = np.full((len(ctx.order), len(ctx.names)), now, np.float64)
        col = {name: j for j, name in enumerate(ctx.names)}
        rows, src, ends, gb8 = [], [], [], []
        for i, u in enumerate(ctx.order):
            for d in self.dag.tasks[u].deps:
                if d in frontier:
                    continue
                name, end = done_at[d]
                rows.append(i)
                src.append(col[name])
                ends.append(end)
                gb8.append(self.dag.tasks[d].output_gb * 8.0)
        if rows:
            src_ix = np.asarray(src, np.int64)
            comm = np.where(ctx.same[src_ix], 0.0,
                            np.asarray(gb8)[:, None] / ctx.gbps_min[src_ix])
            np.maximum.at(ready, np.asarray(rows, np.int64),
                          np.asarray(ends)[:, None] + comm)
        return ready

    def _replan(self, state: SimState, frontier: set) -> Schedule:
        """HEFT over the unstarted sub-DAG; booked/finished work enters as
        ready-time constraints (finish + comm from the producing node).

        Running tasks' finishes are NOT known to a real resource manager —
        they are estimated as start + predicted duration (never before
        now), so the adaptive benchmark measures the online predictor, not
        simulator oracle knowledge."""
        sub, ctx = self._frontier_dag(frontier)
        done_at, node_avail = self._running_ends(state)
        ready = self._ready_rows(ctx, frontier, done_at, state.now)
        new_sched, mat = self._plan(sub, ready_at=ready,
                                    node_available=node_avail)
        self._snapshot_bands(mat, new_sched.assignment, frontier)
        return new_sched
