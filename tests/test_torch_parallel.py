"""The port's sharded full-order, bases and serving paths on gloo ranks of
the CPU (``tests/torch_parallel_ranks.py``, world sizes 2 and 4, float64),
each against the port's single-process result and against the JAX
package's sharded function on a mesh of as many of ``tests/conftest.py``'s
8 virtual CPU devices.  The ranks never import JAX; the JAX side runs here.

Tolerances: the full-order steps at 1e-10 of the extent (the element
sums are added in another order, then solved); the POD, greedy components
and residual norms at 1e-12 (the Gram product and the norms sum in another
order), the constraint bases' modes within ``chip_smoke.pod_bounds`` (past
the snapshots' rank the Gram method's modes are set by rounding); DEIM and
greedy picks equal; the serving routes at 1e-10 of the
extent against the port's single-process batch (the CPU's plain versions
round their batched products by batch size) and at 1e-8 against the JAX
package's (its vmapped XLA step sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
import torch_parallel_ranks as R
from animsnapbases_tpu import parallel as jpar
from animsnapbases_tpu.bases import greedy as jgreedy
from animsnapbases_tpu.geometry.procedural import cloth_model as jcloth
from animsnapbases_tpu.ops import deim_scan as jdeim
from animsnapbases_tpu.ops import podlinalg as jpod
from animsnapbases_tpu.sim import solver as jsolver
from animsnapbases_tpu.sim.model import DeformableModel as JModel
from animsnapbases_tpu.utils.synthetic import (
    synthetic_reduced_solver as jsynthetic,
)
from animsnapbases_tpu_torch.bases import greedy
from animsnapbases_tpu_torch.ops import deim_scan, podlinalg
from animsnapbases_tpu_torch.parallel.ensemble import _single_sim_step_core
from animsnapbases_tpu_torch.sim import solver as tsolver

WORLDS = (2, 4)
EXTENT = 1e-10


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request, tmp_path_factory):
    """(world, rank 0's results of the "fom" and "serving" bodies)."""
    world = request.param
    return world, R.run(("fom", "serving"), world,
                        tmp_path_factory.mktemp(f"ranks{world}"))


def jmodel(rows=5, positional=False, pinned=False):
    return R.build_cloth(jcloth, JModel, rows, positional, pinned)


def jmesh(shape, axes):
    return jpar.build_device_mesh(shape, axes)


def close(a, b, tol=EXTENT):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    assert err <= tol * float(np.abs(b).max()), err


def port_core(model, iters=4, **kw):
    core = _single_sim_step_core(model, R.STEP_DT, "cpu")

    def step(p, v, f, targets=None):
        q, v = core(*(torch.as_tensor(np.asarray(x)) for x in (p, v, f)),
                    num_iterations=iters, targets=targets)
        return q.numpy(), v.numpy()

    return step


def test_ensemble_step(ranks):
    world, res = ranks
    m = R.cloth()
    B = 2 * world
    pos, vel, fs = R.batch_inputs(m, B)
    core = port_core(m)
    ref = []
    for b in range(B):
        p, v = core(pos[b], vel[b], fs[b])
        ref.append(core(p, v, fs[b])[0])
    close(res["ensemble"], np.stack(ref))
    step, shard = jpar.make_ensemble_step(jmodel(), R.STEP_DT,
                                          jmesh((world,), ("data",)))
    p, v = step(shard(pos), shard(vel), shard(fs))
    p, _ = step(p, v, shard(fs))
    close(res["ensemble"], np.asarray(p))


def test_element_sharded_step_with_targets(ranks):
    """Dense solve; positional constraints replicated; the second step's
    per-call targets (an animated schedule's frame)."""
    world, res = ranks
    q, q2 = res["element"]
    m = R.cloth(positional=True)
    core = port_core(m)
    f = R.forces(m, 1)[0]
    p1, v1 = core(m.positions, np.zeros_like(m.positions), f)
    close(q, p1)
    close(q2, core(p1, v1, f, targets=R.target_shift(m))[0])
    jm = jmodel(positional=True)
    step = jpar.make_element_sharded_step(jm, R.STEP_DT,
                                          jmesh((world,), ("model",)),
                                          num_iterations=4)
    jq, jv = step(jnp.asarray(jm.positions),
                  jnp.zeros_like(jnp.asarray(jm.positions)), jnp.asarray(f))
    close(q, np.asarray(jq))
    jq2, _ = step(jq, jv, jnp.asarray(f), targets=R.target_shift(jm))
    close(q2, np.asarray(jq2))


def test_element_sharded_step_on_device_cg(ranks, monkeypatch):
    """Above the dense limit (set to 0 here) the replicated solve is the
    device CG in displacement form, in both packages."""
    world, res = ranks
    monkeypatch.setattr(tsolver.Solver, "DENSE_LIMIT", 0)
    monkeypatch.setattr(jsolver.Solver, "DENSE_LIMIT", 0)
    m = R.cloth(8, pinned=True)
    f = R.forces(m, 1)[0]
    core = port_core(m)
    p, v = core(m.positions, np.zeros_like(m.positions), f)
    close(res["element_cg"], core(p, v, f)[0])
    jm = jmodel(8, pinned=True)
    step = jpar.make_element_sharded_step(jm, R.STEP_DT,
                                          jmesh((world,), ("model",)),
                                          num_iterations=4)
    jq, jv = step(jnp.asarray(jm.positions),
                  jnp.zeros_like(jnp.asarray(jm.positions)), jnp.asarray(f))
    jq, _ = step(jq, jv, jnp.asarray(f))
    close(res["element_cg"], np.asarray(jq))


def test_dp_x_element_sharded_step_on_a_2x2_mesh(ranks):
    world, res = ranks
    if world != 4:
        assert "dp_tp" not in res
        return
    m = R.cloth()
    fs = R.forces(m, 2)
    core = port_core(m, iters=2)
    ref = np.stack([core(m.positions, np.zeros_like(m.positions), f)[0]
                    for f in fs])
    close(res["dp_tp"], ref)
    jm = jmodel()
    mesh = jmesh((2, 2), ("data", "model"))
    inner = jpar.make_element_sharded_step(jm, R.STEP_DT, mesh,
                                           num_iterations=2)
    pos = jnp.asarray(np.repeat(jm.positions[None], 2, axis=0))
    q, _ = jax.vmap(inner)(pos, jnp.zeros_like(pos), jnp.asarray(fs))
    close(res["dp_tp"], np.asarray(q))


def test_sharded_pod(ranks):
    world, res = ranks
    X = R.bases_inputs()[0]
    U, s, Vt = res["pod"]
    for ref in ([a.numpy() for a in podlinalg.snapshot_pod(X, "cpu")],
                [np.asarray(a) for a in jpod.snapshot_pod_sharded(
                    jnp.asarray(X), jmesh((world,), ("model",)))]):
        signs = np.sign(np.sum(U * ref[0], axis=0))
        close(U * signs, ref[0], 1e-12)
        close(s, ref[1], 1e-12)
        close(np.abs(Vt), np.abs(ref[2]), 1e-12)


def test_sharded_deim_picks_equal(ranks):
    """Rows split over the ranks (blocks of whole elements in the block
    form), 203 and 101 elements on 2 or 4 ranks: the picks are those of one
    device and of the JAX sharded scan."""
    world, res = ranks
    _, A, Bk, _ = R.bases_inputs()
    mesh = jmesh((world,), ("model",))
    Pt = res["deim_rows"]
    np.testing.assert_array_equal(Pt, deim_scan.deim_rows(A, device="cpu")[
        0].numpy())
    np.testing.assert_array_equal(Pt, np.asarray(jdeim.deim_rows(
        A, mesh=mesh)[0]))
    alphas = res["deim_blocks"]
    np.testing.assert_array_equal(alphas, deim_scan.deim_blocks(
        Bk, 2, device="cpu").numpy())
    np.testing.assert_array_equal(alphas, np.asarray(jdeim.deim_blocks(
        Bk, 2, mesh=mesh)))


def test_sharded_greedy_extraction(ranks):
    world, res = ranks
    R0 = R.bases_inputs()[3]
    C, W, sig, rn, idx, Rf = res["greedy"]
    one = [x.numpy() for x in greedy.extract_global(torch.as_tensor(R0), 9)]
    jax_ = [np.asarray(x) for x in jgreedy.extract_global(
        jnp.asarray(R0), 9, mesh=jmesh((world,), ("model",)))]
    for ref in (one, jax_):
        np.testing.assert_array_equal(idx, ref[4])
        for got, want in zip((C, W, sig, rn, Rf),
                             (ref[0], ref[1], ref[2], ref[3], ref[5])):
            close(got, want, 1e-12)


@pytest.mark.parametrize("block", [False, True])
def test_sharded_constraint_bases(ranks, tmp_path, block):
    """``device_mesh_shards`` = the world size: the config builds the mesh,
    the POD's Gram product is an all_reduce and the device DEIM scan is
    split; the components agree with one device's, the picks are equal;
    and with the JAX package's sharded run of the same config."""
    world, res = ranks
    comps, S, Pt, sharded = res["cc_block" if block else "cc"]
    assert sharded
    X = R.p_tensor()
    K = 5 if block else 10
    c1, s1, p1, _ = R.constraint_components(str(tmp_path / "one"), X, K, 0,
                                            block=block)
    np.testing.assert_array_equal(Pt, p1)
    close(S, s1, 1e-12)
    within_pod_bounds(s1, c1, comps)

    from test_torch_bases import make_cc

    cc = make_cc("jax", tmp_path, X, p=2, K=K, **(
        {"interpolation_type": "deim_block_form"} if block else {}))
    cc.param.device_mesh_shards = world
    cc.__init__(cc.param, cc.nonlinearSnapshots)
    assert cc.pod_mesh is not None
    cc.St = R.scipy.sparse.identity(X.shape[1], format="csr")
    cc.compute_components_store_singvalues()
    cc.post_process_components()
    if block:
        cc.deim_blocksForm(device=True)
    else:
        cc.deim()
    np.testing.assert_array_equal(Pt, cc.geom_Pt)
    within_pod_bounds(s1, cc.comps, comps)


def within_pod_bounds(S_ref, comps_ref, comps):
    """Each sign-aligned mode within ``chip_smoke.pod_bounds`` (the Gram
    method's rounding, which sets the modes past the snapshots' rank)."""
    K = len(comps_ref)
    _, du = cs.pod_bounds(S_ref, K)
    assert (cs.sign_aligned_diff(comps_ref, comps) <= du).all()


def port_batch(label, B, rows=8):
    solver, m = R.synthetic_solver(
        rows, **({"CHUNKED_TIER1_MIN_VERTS": 0} if label == "chunked"
                 else {}))
    pos, vel, fs = R.batch_inputs(m, B)
    fs[-1] *= 40.0
    return solver, m, pos, vel, fs


def jax_batch(B, rows=8, **extra):
    solver = jsynthetic(jmodel(rows, pinned=True), K=4, r=6,
                        pallas_mode="off", extra_args=extra or None)
    return solver


@pytest.mark.parametrize("label", ["resident", "chunked"])
def test_sharded_serving_routes(ranks, label):
    """``make_batched_run(mesh)`` on both routes, the last sim slammed into
    the floor (on the large-model route its rank's kernel 5 exits first and
    the ranks agree on the committed steps), and ``make_batched_step``."""
    world, res = ranks
    B = 2 * world
    p, v, path = res[label]
    kind = "resident" if label == "resident" else "chunked"
    assert path.startswith(f"batched-{kind}-sharded[{world}x2]"), path
    solver, m, pos, vel, fs = port_batch(label, B)
    p1, v1 = solver.make_batched_run()(pos, vel, fs, 5, num_iterations=4)
    close(p, p1)
    close(v, v1)
    ps, spath = res[label + "_step"]
    assert spath == f"batched-step-sharded[{world}x2]"
    close(ps, solver.make_batched_step()(pos, vel, fs, 4)[0])
    js = jax_batch(B)
    mesh = jmesh((world,), ("data",))
    jp, _ = js.make_batched_run(mesh)(pos, vel, fs, 5, num_iterations=4)
    close(p, np.asarray(jp), 1e-8)
    jp, _ = js.make_batched_step(mesh)(pos, vel, fs, num_iterations=4)
    close(ps, np.asarray(jp), 1e-8)


def test_sharded_serving_per_sim_timelines(ranks):
    """Per-sim target timelines (B, T, e, 3) split with the batch."""
    world, res = ranks
    p, tl, path = res["per_sim"]
    assert path == f"batched-resident-sharded[{world}x2]"
    solver, m = R.synthetic_solver(8)
    pos, vel, fs = R.batch_inputs(m, 2 * world)
    close(p, solver.make_batched_run()(pos, vel, fs, 5, num_iterations=4,
                                       targets_seq=tl)[0])
    jp, _ = jax_batch(2 * world).make_batched_run(
        jmesh((world,), ("data",)))(pos, vel, fs, 5, num_iterations=4,
                                    targets_seq=tl)
    close(p, np.asarray(jp), 1e-8)


def test_sharded_serving_not_fully_reduced(ranks):
    """A full edge_spring group: the batched full-space step, sims split."""
    world, res = ranks
    p, path = res["full"]
    assert path == f"batched-full-sharded[{world}x2]"
    solver, m = R.synthetic_solver(8, extra={"edge_spring_reduced": False})
    pos, vel, fs = R.batch_inputs(m, 2 * world)
    close(p, solver.make_batched_run()(pos, vel, fs, 2, num_iterations=4)[0])
    js = jax_batch(2 * world, edge_spring_reduced=False)
    jp, _ = js.make_batched_run(jmesh((world,), ("data",)))(
        pos, vel, fs, 2, num_iterations=4)
    close(p, np.asarray(jp), 1e-8)
