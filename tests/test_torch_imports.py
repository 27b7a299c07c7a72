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
print(len(names), leaked)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    return env


def test_importing_every_module_leaves_jax_out():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 30            # every module of the slice
    assert out[1].strip() == "[]"


def test_no_source_line_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import|from) (jax|repro)\b")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(open(f), 1) if pat.match(line)]
    assert bad == []


def test_package_inits_import_only_ported_modules():
    """store/__init__ and online/__init__ export the ported names and no
    module of a later slice (frontend, predictor, maintenance,
    rescheduler)."""
    code = ("import sys, repro_torch.store as s, repro_torch.online as o;"
            "print(s.PosteriorStore.__name__, s.TaskKey.__name__,"
            " s.predict_stacked.__name__, o.PredictionService.__name__,"
            " o.PredictionQuery.__name__, o.TaskCompletion.__name__);"
            "print(sorted(k for k in sys.modules if k.startswith("
            "'repro_torch.')))")
    lines = subprocess.run([sys.executable, "-c", code], env=_env(),
                           capture_output=True, text=True, timeout=120,
                           check=True).stdout.splitlines()
    assert lines[0].split() == ["PosteriorStore", "TaskKey",
                                "predict_stacked", "PredictionService",
                                "PredictionQuery", "TaskCompletion"]
    for later in ("frontend", "maintenance", "rescheduler",
                  "online.predictor"):
        assert later not in lines[1]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")


def test_cuda_entry_points_raise_without_a_card(no_card):
    from repro_torch.core.predictor import LotaruPredictor
    from repro_torch.device import resolve_device
    from repro_torch.online import PredictionService
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
