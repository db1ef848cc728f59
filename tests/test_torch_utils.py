"""The port's small API against the JAX package's, float64 on the CPU:
the padding rules, ``to_host_chunked``, the trace of ``device_trace``, the
checks, ``PhaseTimer``, the COO products and the PCG solver, the segment
sums, the surface-tetrahedralized bar, ``rigid_procrustes`` (a generic
frame at 1e-12; a planar frame by the port's rank-2 rule) and
``make_device_global_solve`` (dense and CG)."""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from animsnapbases_tpu.geometry import procedural as jproc
from animsnapbases_tpu.geometry import procrustes as jprocrustes
from animsnapbases_tpu.ops import cg as jcg
from animsnapbases_tpu.ops import segment as jseg
from animsnapbases_tpu.sim import solver as jsolver
from animsnapbases_tpu.utils import checks as jchecks
from animsnapbases_tpu.utils import padding as jpad
from animsnapbases_tpu.utils import timing as jtiming
from animsnapbases_tpu.utils.transfer import to_host_chunked as jto_host
from animsnapbases_tpu_torch.geometry import procedural, procrustes
from animsnapbases_tpu_torch.ops import cg, segment
from animsnapbases_tpu_torch.sim import solver
from animsnapbases_tpu_torch.utils import checks, padding, profiling, timing
from animsnapbases_tpu_torch.utils.transfer import to_host_chunked

RNG = np.random.default_rng(11)


@pytest.mark.parametrize("T", [0, 1, 3, 4, 5, 8])
@pytest.mark.parametrize("axis", [0, 1])
def test_padding_rules_match_jax(T, axis):
    a = RNG.normal(size=(T, 4, 3) if axis == 0 else (2, T, 3))
    for fn, jfn, args in ((padding.pow2_pad, jpad.pow2_pad, (axis,)),
                          (padding.zero_pad_to_multiple,
                           jpad.zero_pad_to_multiple, (axis, 4))):
        want = jfn(a, *args)
        np.testing.assert_array_equal(fn(a, *args), want)
        got = fn(torch.as_tensor(a), *args)
        assert torch.is_tensor(got)
        np.testing.assert_array_equal(got.numpy(), want)


def test_to_host_chunked():
    x = torch.as_tensor(RNG.normal(size=(37, 5, 3)))
    for max_bytes in (1, 100, 1 << 30):
        out = to_host_chunked(x, max_bytes=max_bytes)
        assert isinstance(out, np.ndarray) and out.dtype == np.float64
        np.testing.assert_array_equal(out, x.numpy())
        np.testing.assert_array_equal(out, jto_host(jnp.asarray(x.numpy()),
                                                    max_bytes=max_bytes))
    np.testing.assert_array_equal(to_host_chunked([1.0, 2.0]), [1.0, 2.0])


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("region_of_interest"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as fp:
        trace = json.load(fp)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "region_of_interest" in names
    with profiling.device_trace(str(tmp_path / "off"), enabled=False) as p:
        assert p is None
    assert not (tmp_path / "off").exists()


def test_checks_match_jax():
    t = RNG.normal(size=(6, 5, 3))
    t[t < 0.3] = 0.0
    for th in (0.3, 0.5, 0.9):
        assert checks.is_sparse(t, th) == jchecks.is_sparse(t, th)
    A = RNG.normal(size=(5, 5))
    A = A @ A.T + 5 * np.eye(5)
    assert checks.check_matrix_properties(A) == \
        jchecks.check_matrix_properties(A)
    for bad, msg in ((np.ones((2, 3)), "not square"),
                     (np.zeros((3, 3)), "singular"),
                     (np.diag([1e6, 1e-7, 1.0]), "condition")):
        with pytest.raises(ValueError, match=msg):
            checks.check_matrix_properties(bad)
        with pytest.raises(ValueError, match=msg):
            jchecks.check_matrix_properties(bad)


def test_phase_timer_writes_the_jax_lines(tmp_path):
    outs = []
    for mod, sub in ((timing, "port"), (jtiming, "jax")):
        t = mod.PhaseTimer(str(tmp_path / sub))
        assert t.path() == str(tmp_path / sub / "function_timings.txt")
        with t.phase("stage_a"):
            pass
        t.record("stage_b", 1.25)
        t.flush()
        with open(t.path()) as fp:
            outs.append(fp.read().splitlines())
    assert [line.split(" executed")[0] for line in outs[0]] == \
        [line.split(" executed")[0] for line in outs[1]]
    assert outs[0][1] == outs[1][1] == ("Function 'stage_b' executed in "
                                        "1.2500 seconds.")
    t = timing.PhaseTimer()
    t.record("x", 0.5)
    path = t.flush(str(tmp_path / "other"))
    assert path == str(tmp_path / "other" / "function_timings.txt")


def spd(n=30):
    A = sp.random(n, n, density=0.15, random_state=4)
    return (A @ A.T + 4.0 * sp.eye(n)).tocoo()


def test_coo_products_and_segment_sums_match_jax():
    A = sp.random(12, 9, density=0.3, random_state=1).tocoo()
    X = RNG.normal(size=(9, 3))
    x = X[:, 0]
    t = torch.as_tensor
    np.testing.assert_allclose(
        cg.coo_matvec(A.row, A.col, t(A.data), t(X), 12).numpy(),
        np.asarray(jcg.coo_matvec(jnp.asarray(A.row), jnp.asarray(A.col),
                                  jnp.asarray(A.data), jnp.asarray(X), 12)),
        rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        segment.coo_matvec(A.row, A.col, A.data, t(x), 12).numpy(),
        np.asarray(jseg.coo_matvec(jnp.asarray(A.row), jnp.asarray(A.col),
                                   jnp.asarray(A.data), jnp.asarray(x), 12)),
        rtol=0, atol=1e-14)
    vals = RNG.normal(size=(20, 3))
    ids = RNG.integers(0, 7, 20)
    np.testing.assert_allclose(
        segment.segment_sum_3d(t(vals), ids, 7).numpy(),
        np.asarray(jseg.segment_sum_3d(jnp.asarray(vals), jnp.asarray(ids),
                                       7)), rtol=0, atol=1e-14)


def test_pcg_solver_matches_jax():
    A = spd()
    rhs = RNG.normal(size=(30, 3))
    diag = A.diagonal()
    solve = cg.make_pcg_solver(A.row, A.col, A.data,
                               torch.as_tensor(diag), 30, tol=1e-13)
    jsolve = jcg.make_pcg_solver(A.row, A.col, A.data, diag, 30, tol=1e-13)
    x, it = solve(torch.as_tensor(rhs))
    jx, jit = jsolve(jnp.asarray(rhs))
    assert it == int(jit)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-12)
    np.testing.assert_allclose(A @ x.numpy(), rhs, atol=1e-10)
    x2, it2 = solve(torch.as_tensor(rhs), x0=x, max_iterations=3)
    assert it2 <= 3


def test_bar_model_surface_tetrahedralized_matches_jax():
    for got, want in zip(procedural.bar_model_surface_tetrahedralized(4, 3, 3),
                         jproc.bar_model_surface_tetrahedralized(4, 3, 3)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_rigid_procrustes_generic_frame():
    frm = RNG.normal(size=(20, 3))
    q, _ = np.linalg.qr(RNG.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    to = frm @ q.T + np.array([0.3, -1.0, 2.0])
    for rigid in (True, False):
        T = procrustes.rigid_procrustes(torch.as_tensor(frm),
                                        torch.as_tensor(to), rigid).numpy()
        J = np.asarray(jprocrustes.rigid_procrustes(
            jnp.asarray(frm), jnp.asarray(to), rigid))
        np.testing.assert_allclose(T, J, atol=1e-12)
    T = procrustes.rigid_procrustes(torch.as_tensor(frm),
                                    torch.as_tensor(to)).numpy()
    np.testing.assert_allclose(frm @ T[:3, :3].T + T[:3, 3], to, atol=1e-12)


def test_rigid_procrustes_planar_frame_takes_the_rank2_rule():
    """A planar frame's m has rank 2: the third pair's sign is fixed so
    that det(u vt) = +1 (ROADMAP Queue C), the same rotation
    ``procrustes_transforms`` gives, and a proper rotation that maps the
    plane onto its rotated copy."""
    frm = np.c_[RNG.normal(size=(25, 2)), np.zeros(25)]
    c, s = np.cos(0.4), np.sin(0.4)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    to = frm @ R.T
    T = procrustes.rigid_procrustes(torch.as_tensor(frm),
                                    torch.as_tensor(to)).numpy()
    r, t, sv = procrustes.procrustes_transforms(
        torch.as_tensor(frm)[None], torch.as_tensor(to))
    assert float(sv[0, 2]) < procrustes.RANK2_RTOL * float(sv[0, 0])
    np.testing.assert_array_equal(T[:3, :3], r[0].numpy())
    assert abs(np.linalg.det(T[:3, :3]) - 1.0) < 1e-12
    np.testing.assert_allclose(frm @ T[:3, :3].T + T[:3, 3], to, atol=1e-12)


@pytest.mark.parametrize("dense_limit", [None, 0])
def test_device_global_solve_matches_jax(dense_limit):
    """Dense Cholesky below the limit, CG in displacement form above it."""
    from animsnapbases_tpu.geometry.procedural import cloth_model as jcloth
    from animsnapbases_tpu.sim.model import DeformableModel as JModel
    from torch_parallel_ranks import build_cloth, cloth

    m, jm = cloth(6, pinned=True), build_cloth(jcloth, JModel, 6, False,
                                              True)
    sn = m.positions + 0.01 * RNG.normal(size=m.positions.shape)
    c = RNG.normal(size=sn.shape)
    prep, apply = solver.make_device_global_solve(
        m, 0.016, "cpu", dense_limit=dense_limit)
    jprep, japply = jsolver.make_device_global_solve(
        jm, 0.016, dense_limit=dense_limit)
    t = torch.as_tensor
    q, u = apply(t(c), t(sn), torch.zeros_like(t(sn)), prep(t(sn)))
    jq, ju = japply(jnp.asarray(c), jnp.asarray(sn),
                    jnp.zeros_like(jnp.asarray(sn)), jprep(jnp.asarray(sn)))
    scale = float(np.abs(np.asarray(jq)).max())
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-10 * scale)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-10 * scale)
