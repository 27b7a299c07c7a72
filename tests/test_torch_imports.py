"""The port stands alone: importing any `repro_torch` module pulls in
neither JAX nor the JAX package, entry points refuse a CUDA device when
there is no card, and chip_smoke.py refuses to run without one.

The import check runs in a subprocess: this test process already imported
JAX (tests/conftest.py)."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked, ",".join(names))
"""

# the LM serving slice: each of these must be among the modules imported
LM_MODULES = (
    "configs", "configs.base", "configs.recurrentgemma_9b", "data",
    "data.pipeline", "models", "models.layers", "models.rglru",
    "models.attention", "models.transformer", "train", "train.train_step",
    "launch", "launch.serve", "kernels.flash_attention",
    "kernels.rglru_scan", "convert")
# the resident decision plane and the maintenance plane
PLANE_MODULES = ("store.posterior", "sched.fused", "online.maintenance")
# replanning many workflows: the rank and many-lane sweep kernels' wrappers,
# their plain versions and dispatch
REPLAN_MODULES = ("kernels.decision_plane", "kernels.ref", "kernels.ops")
# the online path (rescheduler, adaptive executor, speculation) and the
# planners that consume the predictions
ADAPTIVE_MODULES = ("online.rescheduler", "workflow.simulator",
                    "sched.straggler", "sched.cost", "sched.carbon",
                    "sched.elastic")
# the store's batch-window frontend and the real microbenchmark probes
# (the checkpoint, shipping and migration live in store.posterior)
STORE_MODULES = ("store.frontend", "core.microbench")
# training: SmolLM-360M's config, the optimizer, the train step,
# checkpoints, the launcher, the roofline, and the backward kernels'
# wrappers (in kernels.flash_attention and kernels.rglru_scan)
TRAIN_MODULES = ("configs.smollm_360m", "train.optimizer",
                 "train.checkpoint", "train.train_step", "launch.train",
                 "perf", "perf.roofline")
# the sharded serving tier (the reference's own copies of wire and
# placement, which import no JAX, are not imported either)
SERVE_MODULES = ("serve", "serve.wire", "serve.placement", "serve.failover",
                 "serve.shard", "serve.client", "serve.replica",
                 "serve.rebalance")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    return env


def test_importing_every_module_leaves_jax_out():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert int(out[0]) >= 75            # every module of the slices
    assert out[1] == "[]"
    names = set(out[2].split(","))
    assert {f"repro_torch.{m}" for m in
            LM_MODULES + PLANE_MODULES + REPLAN_MODULES
            + ADAPTIVE_MODULES + STORE_MODULES + SERVE_MODULES
            + TRAIN_MODULES} <= names


def test_no_source_line_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import|from) (jax|repro)\b")
    files = [os.path.join(ROOT, n) for n in ("chip_smoke.py",
                                             "sweep_clocks.py",
                                             "cost_split.py")]
    for d, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(open(f), 1) if pat.match(line)]
    assert bad == []


def test_package_inits_import_only_ported_modules():
    """store/__init__ and online/__init__ export the ported names (the
    frontend's, the maintenance plane's and the rescheduler's among them)
    and import no module of a later slice (the serving tier)."""
    code = ("import sys, repro_torch.store as s, repro_torch.online as o;"
            "print(s.PosteriorStore.__name__, s.TaskKey.__name__,"
            " s.predict_stacked.__name__,"
            " s.AsyncPredictionFrontend.__name__,"
            " s.QueueFullError.__name__, o.PredictionService.__name__,"
            " o.PredictionQuery.__name__, o.TaskCompletion.__name__,"
            " o.OnlinePredictor.__name__, o.IngestStats.__name__,"
            " o.FleetRefresher.__name__, o.RefreshPolicy.__name__,"
            " o.OnlineReschedulingPlanner.__name__,"
            " o.RescheduleStats.__name__);"
            "print(sorted(k for k in sys.modules if k.startswith("
            "'repro_torch.')))")
    lines = subprocess.run([sys.executable, "-c", code], env=_env(),
                           capture_output=True, text=True, timeout=120,
                           check=True).stdout.splitlines()
    assert lines[0].split() == ["PosteriorStore", "TaskKey",
                                "predict_stacked", "AsyncPredictionFrontend",
                                "QueueFullError", "PredictionService",
                                "PredictionQuery", "TaskCompletion",
                                "OnlinePredictor", "IngestStats",
                                "FleetRefresher", "RefreshPolicy",
                                "OnlineReschedulingPlanner",
                                "RescheduleStats"]
    assert "repro_torch.online.maintenance" in lines[1]
    assert "repro_torch.online.rescheduler" in lines[1]
    assert "repro_torch.store.frontend" in lines[1]
    assert "repro_torch.serve" not in lines[1]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")


def test_cuda_entry_points_raise_without_a_card(no_card):
    from repro_torch.core.microbench import run_local_microbench
    from repro_torch.core.predictor import LotaruPredictor
    from repro_torch.device import resolve_device
    from repro_torch.online import PredictionService
    from repro_torch.store import AsyncPredictionFrontend, PosteriorStore
    from repro_torch.store.compute import fit_stacked, predict_stacked
    with pytest.raises(RuntimeError, match="CUDA"):
        LotaruPredictor("G")                     # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictionService(LotaruPredictor("G", device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_stacked(np.zeros(1), {})
    z = np.zeros((1, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_stacked(z, z, z)
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncPredictionFrontend(PosteriorStore())   # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        run_local_microbench()
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_card_or_package(no_card, tmp_path):
    """No card: exit non-zero and print no result.  A directory holding
    chip_smoke.py alone: the same."""
    runs = [subprocess.run([sys.executable, os.path.join(ROOT,
                                                         "chip_smoke.py")],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=120)]
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    runs.append(subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                               capture_output=True, text=True, timeout=120))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_sweep_clocks_refuses_without_card(no_card):
    r = subprocess.run([sys.executable, os.path.join(ROOT, "sweep_clocks.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "[clocks]" not in r.stdout


def test_cost_split_refuses_without_card(no_card):
    r = subprocess.run([sys.executable, os.path.join(ROOT, "cost_split.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "[cost_split]" not in r.stdout


def test_serve_entry_points_raise_without_a_card(no_card):
    """The shard, the replica and a shard child's CLI run on "cuda" unless
    asked for "cpu": without a card they raise, and nothing falls back."""
    from repro_torch.serve import ReplicaServer, ShardMap, ShardServer
    from repro_torch.serve.placement import ShardInfo
    from repro_torch.store import PosteriorStore
    m = ShardMap([ShardInfo("s0", "127.0.0.1", 1)])
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardServer("s0", m, store=PosteriorStore())
    with pytest.raises(RuntimeError, match="CUDA"):
        ReplicaServer()
    assert ReplicaServer(device="cpu").device == torch.device("cpu")
    r = subprocess.run([sys.executable, "-m", "repro_torch.serve.shard",
                        "--shard-id", "s0", "--map", '{"version": 1, '
                        '"vnodes": 64, "shards": [["s0", "127.0.0.1", 0]]}',
                        "--bootstrap", "tests.torch_serve_helpers:bootstrap"],
                       cwd=ROOT, env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "SHARD-READY" not in r.stdout
    assert "CUDA" in r.stderr


def test_lm_entry_points_raise_without_a_card(no_card):
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_decode_cache, init_params
    cfg = get_reduced_config("recurrentgemma-9b")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(cfg, 1, 4, 1)                      # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_decode_cache(cfg, 1, 4)


def test_train_entry_points_raise_without_a_card(no_card, tmp_path):
    """The train launcher and the train state run on "cuda" unless asked
    for "cpu": without a card they raise, and nothing falls back."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import train
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(0, get_reduced_config("smollm-360m"), OptConfig())
    assert not list(tmp_path.iterdir())
