"""The port's tensor-parallel reduced step, ``dryrun_multichip`` and the
mesh and launch helpers on gloo ranks of the CPU, float64.

``make_tp_reduced_step`` over ("model",) at world sizes 2 and 4
(``tests/torch_parallel_ranks.py``), on the row-form and block-form
synthetic solvers of the pinned 10x10 cloth, three steps from rest: against
the port's single-process fully reduced step (``step()``, kernel 1's plain
version) and the row form against the JAX package's ``make_tp_reduced_step``
on a mesh of as many virtual CPU devices, at 1e-10 of the extent (the
partial products are summed in another order).  ``dryrun_multichip(4)``
runs its four paths on a 2x2 mesh with its own holds.
"""

import time

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from animsnapbases_tpu import parallel as jpar
from animsnapbases_tpu.geometry.procedural import cloth_model as jcloth
from animsnapbases_tpu.sim.model import DeformableModel as JModel
from animsnapbases_tpu.utils.synthetic import (
    synthetic_reduced_solver as jsynthetic,
)
from animsnapbases_tpu_torch import dryrun
from animsnapbases_tpu_torch.parallel import ensemble as tens
from animsnapbases_tpu_torch.parallel import launch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=(2, 4))
def ranks(request, tmp_path_factory):
    world = request.param
    return world, R.run(("tp",), world,
                        tmp_path_factory.mktemp(f"tp{world}"))


def close(a, b, tol=1e-10):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    err = float(np.abs(a - b).max())
    assert err <= tol * float(np.abs(b).max()), err


@pytest.mark.parametrize("form", ["row", "block"])
def test_tp_reduced_step_matches_single_process(ranks, form):
    world, res = ranks
    q, v = res[form]
    solver, m = R.synthetic_solver(10, block=form == "block")
    f = R.forces(m, 1)[0]
    for _ in range(3):
        solver.step(f, num_iterations=6)
    close(q, m.positions)
    close(v, m.velocities, 1e-8)


def test_tp_reduced_step_matches_jax(ranks):
    world, res = ranks
    q, _ = res["row"]
    jm = R.build_cloth(jcloth, JModel, 10, False, True)
    js = jsynthetic(jm, K=4, r=6, pallas_mode="off")
    step = jpar.make_tp_reduced_step(
        js, jpar.build_device_mesh((world,), ("model",)))
    f = R.forces(jm, 1)[0]
    p, v = jm.positions, np.zeros_like(jm.positions)
    for _ in range(3):
        p, v = step(p, v, f, num_iterations=6)
    close(q, np.asarray(p))


def test_tp_reduced_step_refuses_what_jax_refuses():
    """Position reduction and every group hyper-reduced are needed; the
    mesh must be a DeviceMesh."""
    from animsnapbases_tpu_torch.parallel import make_tp_reduced_step

    solver, _ = R.synthetic_solver(6, extra={"edge_spring_reduced": False})
    with pytest.raises(ValueError, match="every constraint group"):
        make_tp_reduced_step(solver, object())
    solver, _ = R.synthetic_solver(6)
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_tp_reduced_step(solver, object())


def test_dryrun_multichip_on_four_cpu_ranks(capfd):
    """The four paths of ``dryrun_multichip`` on a (2, 2) mesh of spawned
    CPU ranks, each held by the dryrun itself; rank 0's line names them."""
    dryrun.dryrun_multichip(4, device="cpu", timeout=240.0)
    text = capfd.readouterr().out
    assert "dryrun_multichip OK: mesh (2, 2)" in text
    for part in ("batched-resident-sharded[2x2]",
                 "batched-chunked-sharded[2x2]", "TP-reduced 10201-vertex",
                 "sharded POD 120001x16"):
        assert part in text, part


def test_mesh_helpers_without_a_process_group():
    """Without a process group a mesh cannot be built, and a sharded
    bases request stays on one device with the JAX warning."""
    with pytest.raises(RuntimeError, match="process group"):
        tens.build_device_mesh((2,), ("model",), "cpu")
    assert tens.mesh_from_shards(1, "cpu") is None
    with pytest.warns(UserWarning, match="only 1 devices are visible"):
        assert tens.mesh_from_shards(4, "cpu") is None


def test_run_ranks_fails_fast_on_a_failing_rank():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank exit codes"):
        launch.run_ranks(2, R.fail_on_rank_1, timeout=60.0, threads=1)
    assert time.monotonic() - t0 < 45.0


def test_run_ranks_ends_hung_ranks_at_its_limit():
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        launch.run_ranks(2, R.hang_on_rank_1, (120.0,), timeout=6.0,
                         threads=1)
    assert time.monotonic() - t0 < 45.0
