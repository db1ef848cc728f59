"""The PyTorch port stands alone: importing it (every module) and
``chip_smoke`` pulls in neither JAX nor any module of the JAX package, and
its entry points refuse to run without a card unless the CPU is asked
for."""

import json
import os
import subprocess
import sys

import pytest
import torch

from animsnapbases_tpu_torch.config.sim_config import default_sim_args
from animsnapbases_tpu_torch.device import (
    resolve_device,
    storage_dtype,
    working_dtype,
)
from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, pkgutil, importlib, sys
import animsnapbases_tpu_torch, chip_smoke
names = [m.name for m in pkgutil.walk_packages(
    animsnapbases_tpu_torch.__path__, "animsnapbases_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "loaded": sorted(sys.modules)}))
"""


def test_port_imports_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    loaded = res["loaded"]
    assert "animsnapbases_tpu_torch.sim.reduced" in res["modules"]
    assert "animsnapbases_tpu_torch.demos.poke" in res["modules"]
    # the recorder and the bases pipeline, with the block forms
    # (bases.constraints, ops.deim_scan, geometry.mesh, io.meshes) and the
    # solves that are not fully reduced (sim.reduced)
    for name in ("ops.svd3", "ops.segment", "ops.cg", "ops.podlinalg",
                 "ops.deim_scan", "sim.projections", "sim.solver",
                 "geometry.mass", "geometry.mesh", "io.binfmt", "io.meshes",
                 "config.bases_config", "snapshots.nonlinear",
                 "bases.greedy", "bases.constraints",
                 "bases.position_reduction", "bases.pipeline",
                 "utils.checks", "utils.timing",
                 # the position workflow
                 "geometry.laplacian", "geometry.geodesics",
                 "geometry.procrustes", "geometry.partitioning",
                 "geometry.volume", "io.h5anim", "snapshots.pipeline",
                 "snapshots.position", "bases.splocs", "bases.pca", "cli",
                 # the scenarios, the command lines and the analysis
                 "demos.scenarios", "demos.interactive", "sim.interaction",
                 "sim.checkpoint", "sim_cli", "analysis",
                 "analysis.accuracy", "analysis.compare", "analysis.viewer",
                 "analysis.figures", "analysis.ps_viewer",
                 "analysis.accuracy_report",
                 # the sharded paths, the native I/O and helpers, the battery
                 "parallel", "parallel.ensemble", "parallel.reduced_tp",
                 "parallel.collectives", "parallel.launch", "dryrun",
                 "io.native", "utils.padding", "utils.transfer",
                 "utils.profiling", "smoke", "sweep", "holds"):
        assert f"animsnapbases_tpu_torch.{name}" in res["modules"], name
        assert f"animsnapbases_tpu_torch.{name}" in loaded, name
    assert "animsnapbases_tpu_torch.ops.resident" in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    # h5py only for .h5 file I/O, matplotlib only where a function draws,
    # polyscope only where a window opens: inside those functions
    for lazy in ("h5py", "matplotlib", "polyscope"):
        assert not [m for m in loaded
                    if m == lazy or m.startswith(lazy + ".")], lazy
    assert not [m for m in loaded if m == "animsnapbases_tpu"
                or m.startswith("animsnapbases_tpu.")]


def test_default_device_needs_a_card():
    """No ``device`` means the card: without one the solver raises rather
    than carry on on the CPU."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnimSnapBasesSolver(default_sim_args())
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_pipeline_entry_points_default_to_the_card(tmp_path):
    """The recorder, the POD, the DEIM scan and the bases take the card
    unless the CPU is asked for: without one they raise."""
    import numpy as np

    from animsnapbases_tpu_torch.bases.constraints import (
        ConstraintComponents,
    )
    from animsnapbases_tpu_torch.bases.position_reduction import (
        position_basis_from_trajectory,
    )
    from animsnapbases_tpu_torch.device import PIPELINE_DTYPE
    from animsnapbases_tpu_torch.ops.deim_scan import deim_rows
    from animsnapbases_tpu_torch.ops.podlinalg import snapshot_pod
    from animsnapbases_tpu_torch.sim.solver import Solver

    assert PIPELINE_DTYPE == torch.float64
    X = np.random.default_rng(0).normal(size=(30, 4))
    assert Solver(device="cpu").device.type == "cpu"
    assert snapshot_pod(X, device="cpu")[0].dtype == torch.float64
    if torch.cuda.is_available():
        return
    param = type("P", (), {"constProj_support": "global"})()
    for call in (Solver, lambda: snapshot_pod(X),
                 lambda: deim_rows(X[:, :, None]),
                 lambda: position_basis_from_trajectory(
                     X.T[:, :, None].repeat(3, 2), 2),
                 lambda: ConstraintComponents(param, snapshots=object())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_position_entry_points_default_to_the_card(tmp_path):
    """The alignment, the position components and the position pipeline
    take the card unless the CPU is asked for: without one they raise."""
    import numpy as np

    from animsnapbases_tpu_torch.bases.pca import PositionComponents
    from animsnapbases_tpu_torch.cli import run_position_pipeline
    from animsnapbases_tpu_torch.geometry.procrustes import align_animation

    V = np.random.default_rng(0).normal(size=(3, 5, 3))
    assert align_animation(V, device="cpu").shape == V.shape
    if torch.cuda.is_available():
        return
    param = type("P", (), {"vertPos_bases_type": "PCA",
                           "run_pca_tests": False})()
    for call in (lambda: align_animation(V),
                 lambda: PositionComponents(param, pos_snapshots=object()),
                 lambda: run_position_pipeline(param)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_cpu_policy():
    dev = resolve_device("cpu")
    assert dev.type == "cpu"
    assert working_dtype(dev) == torch.float64
    assert working_dtype(torch.device("cuda")) == torch.float32
    with pytest.raises(ValueError):
        working_dtype(torch.device("cuda"), torch.float64)
    assert storage_dtype(torch.float32, torch.bfloat16) == torch.bfloat16
    assert storage_dtype(torch.float64) == torch.float64
    with pytest.raises(ValueError):
        storage_dtype(torch.float64, torch.bfloat16)
    with pytest.raises(ValueError):
        storage_dtype(torch.float32, torch.float64)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """``chip_smoke.py`` run without a card, and from a directory that holds
    it and nothing else of the repository, exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke would run for real")
    alone = tmp_path / "alone"
    alone.mkdir()
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    (alone / "chip_smoke.py").write_text(src)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (REPO, str(alone)):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_cpu_path_counts_no_launch(tmp_path):
    """The launch counters are plain integers on the wrappers and count
    kernel launches only: the CPU path (the plain versions) leaves them."""
    import numpy as np

    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
    )
    from animsnapbases_tpu_torch.ops.resident import resident_multistep
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )
    from test_torch_fused_reduced import gravity, small_model

    s = synthetic_reduced_solver(small_model(DeformableModel), device="cpu",
                                 work_dir=str(tmp_path))
    before = (fused_reduced_iterations.launches, resident_multistep.launches)
    assert all(isinstance(n, int) for n in before)
    f = gravity(s.model)
    s.step(f, num_iterations=3)
    s.run_steps(f, 2, num_iterations=3)
    assert s.frame == 3 and np.isfinite(s.model.positions).all()
    assert (fused_reduced_iterations.launches,
            resident_multistep.launches) == before


_DIFF_PROBE = """
import json, sys
import animsnapbases_tpu_torch.sim.diff
import animsnapbases_tpu_torch.demos.fit_material
print(json.dumps(sorted(sys.modules)))
"""


def test_diff_and_fit_demo_import_no_jax_or_optax():
    """The differentiable rollouts and the material-fit demo, in a fresh
    interpreter, load neither JAX nor optax (the card's machine has no
    optax) nor the JAX package; the demo's entry point takes the card
    unless ``--cpu`` is given."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _DIFF_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    for banned in ("jax", "optax", "animsnapbases_tpu"):
        assert not [m for m in loaded
                    if m == banned or m.startswith(banned + ".")], banned
    if torch.cuda.is_available():
        return
    from animsnapbases_tpu_torch.demos import fit_material

    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_material.main([])
