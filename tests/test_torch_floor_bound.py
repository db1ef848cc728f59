"""Kernel 5's floor test in the PyTorch port: the per-mode interval bound
beside the Cauchy-Schwarz one (``animsnapbases_tpu_torch.ops.affine_chunked``
``floor_bound``, ``interval_clears``), on the plain version, float32 state
on the CPU, with float32 and bfloat16 storage of the lift, on two position
bases of the small cloth (``chip_smoke.small_scene``, r = 8): the random
orthonormal one (``chip_smoke.free_position_basis``, umax ~0.45, where the
Cauchy-Schwarz bound is the tighter) and a stretched one like a PCA basis
(:func:`stretched_position_basis`, umax ~7.7, where the interval bound is).

A step either bound certifies never has an exact y row under the floor, and
on a floor-clear window the interval bound takes over from the exact check
the steps the Cauchy-Schwarz bound trips on, leaving every output as it
was.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke as cs
from animsnapbases_tpu_torch.geometry.procedural import cloth_model
from animsnapbases_tpu_torch.ops import affine_chunked as k5
from animsnapbases_tpu_torch.ops.affine import AffineContext, affine_operands
from animsnapbases_tpu_torch.ops.resident import storage_round
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.utils import profiling
from animsnapbases_tpu_torch.utils.synthetic import synthetic_reduced_solver
from test_torch_tracing import chunk_inputs

R = 8
DRAWS = 4096
# a floor-clear window on which the stretched basis's Cauchy-Schwarz bound
# trips: (lift, gravity scale, steps)
CLEAR = (3.0, 1.0, 64)


def stretched_position_basis(model, r, path, stretch=30.0, seed=1):
    """A per-dim position basis like a PCA one, written as ``components``
    (r, N, 3): orthonormal columns, zero at the pinned vertices, the first
    the free vertices' constant (smooth: what gravity moves), the others
    random, and the last stretched by ``stretch``, so that its largest
    entries set umax while the motion sits in the smooth mode."""
    rng = np.random.default_rng(seed)
    comps = np.empty((r, model.n_verts, 3))
    for d in range(3):
        X = rng.normal(size=(model.n_verts, r))
        X[:, 0] = 1.0
        X[model.fixed_flags] = 0.0
        Q, _ = np.linalg.qr(X)
        Q[:, -1] *= stretch
        comps[:, :, d] = Q.T
    np.savez(path, components=comps)
    return path


def small_solver(basis, storage, device="cpu"):
    """The small cloth, float32 state, the lift stored in ``storage``, on
    the position basis ``basis`` ("small" or "stretched")."""
    model = cs.small_scene(DeformableModel, cloth_model)
    make = (cs.free_position_basis if basis == "small"
            else stretched_position_basis)
    with tempfile.TemporaryDirectory() as tmp:
        pos = make(model, R, os.path.join(tmp, "pos.npz"))
        s = synthetic_reduced_solver(
            model, K=6, r=R, work_dir=tmp, device=device,
            dtype=torch.float32, matmul_dtype=storage,
            extra_args={"damping": 0.07, "position_basis_file": pos})
    return model, s


def change(fn):
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: v - before[k] for k, v in after.items()}


def no_interval(monkeypatch):
    """The floor test without the interval bound: the Cauchy-Schwarz bound
    alone, as before it."""
    monkeypatch.setattr(k5, "interval_clears",
                        lambda ao, lb_aff, *a: torch.zeros_like(
                            lb_aff, dtype=torch.bool))


@pytest.fixture(scope="module", params=[
    (basis, storage) for basis in ("small", "stretched")
    for storage in (torch.float32, torch.bfloat16)],
    ids=lambda p: f"{p[0]}-{str(p[1]).split('.')[-1]}")
def solved(request):
    """(basis, model, solver)."""
    return (request.param[0], *small_solver(*request.param))


def test_y_range_is_the_lift_rows_extremes(solved):
    """``y_range`` holds each y row's minimum and maximum over every vertex,
    pinned included, of the stored lift widened to the working dtype."""
    _, _, s = solved
    ao = s._affine
    uy = ao.res.U_liftT[1].to(torch.float32)
    assert ao.y_range.dtype == torch.float32
    assert ao.y_range.shape == (2, R)
    assert torch.equal(ao.y_range[0], uy.min(dim=1).values)
    assert torch.equal(ao.y_range[1], uy.max(dim=1).values)


def test_a_certified_step_never_has_an_exact_row_under_the_floor(solved):
    """Many predictors drawn near the floor on anchors whose lowest vertex
    holds every y row's minimum of the lift, so that for w >= 0 the
    interval bound is attained there in exact arithmetic and only its
    slack stands between a rounded bound and the exact row: with the floor
    one unit of rounding above the exact row's minimum no step is certified,
    in either form of the Cauchy-Schwarz bound; with floors drawn below it
    the bounds certify steps, each with its exact row above the floor."""
    _, model, s = solved
    ro = s._affine.res
    P = s._to_device(model.init_positions)
    gen = torch.Generator().manual_seed(20)
    V = 0.1 * torch.randn(P.shape, generator=gen)
    V[1] = 0.3                                 # every vertex at its minimum
    fa = torch.zeros_like(P)
    v0 = int(P[1].argmin())
    U = ro.U_liftT.clone()
    U[1][:, v0] = U[1].amin(dim=1)
    ao = s._affine
    ao = affine_operands(dataclasses.replace(ro, U_liftT=U),
                         ao.M_utac.double().numpy(),
                         ao.U_selT.double().numpy())
    asn = torch.zeros(DRAWS, 3, 3)
    asn[:, 1, 0] = 0.5 + torch.rand(DRAWS, generator=gen)
    asn[:, 1, 1] = 0.05 * (2 * torch.rand(DRAWS, generator=gen) - 1)
    asn[:, 1, 2] = torch.rand(DRAWS, generator=gen)
    asn[DRAWS // 2:, 1, 1] = asn[DRAWS // 2:, 1, 1].abs()
    scale = 10.0 ** (4 * torch.rand(DRAWS, 1, generator=gen) - 3)
    wsn = torch.zeros(DRAWS, 3, R)
    wsn[:, 1] = scale * torch.randn(DRAWS, R, generator=gen) / ao.umax
    wsn[DRAWS // 2:, 1] = wsn[DRAWS // 2:, 1].abs()   # attained at v0
    ymm = P.new_empty(6)
    k5.fill_ymm(ymm, P, V, fa, True)
    ymm = ymm.expand(DRAWS, 6)
    ctx = AffineContext(ao, fa)
    low = ctx.y_predictor(ctx.init_anchors(P, V), asn, wsn).min(-1).values
    # the attained draws: the exact row's minimum is lb_aff + the interval
    # sum to rounding
    a = asn[:, 1]
    lb = torch.where(a >= 0, a * ymm[:, :3], a * ymm[:, 3:]).sum(-1)
    wy = storage_round(wsn[:, 1], U.dtype)
    lo, hi = ao.y_range
    iv = torch.where(wy >= 0, wy * lo, wy * hi).sum(-1)
    ia = (wy.abs() * torch.maximum(-lo, hi)).sum(-1)
    half = slice(DRAWS // 2, None)
    assert torch.allclose(low[half], (lb + iv)[half], rtol=0, atol=1e-4)
    above = torch.nextafter(low, torch.full_like(low, np.inf))
    # floors from the exact row's minimum down past the interval bound's
    # threshold lb_aff + iv - 0.25 ia: about half of them certified
    below = low - torch.rand(DRAWS, generator=gen) * 2 * (
        low - lb - iv + 0.5 * ia + 1e-4)
    for sqrt_free in (True, False):
        trip = k5.floor_bound(ao, asn, wsn, ymm, above, sqrt_free,
                              interval=True)
        assert bool(trip.all())
        trip = k5.floor_bound(ao, asn, wsn, ymm, below, sqrt_free,
                              interval=True)
        certified = ~trip
        assert int(certified.sum()) > DRAWS // 4
        assert int(trip.sum()) > DRAWS // 4
        assert bool((low[certified] >= below[certified]).all())


def test_the_interval_bound_takes_over_checks_on_a_floor_clear_window(
        solved, monkeypatch):
    """The small cloth lifted 3 units under gravity for 64 steps, one chunk
    (tier 1 serves every step): against the floor test without the interval
    bound, the exact checks fall by the steps the interval bound clears,
    every output the same bit for bit; on the stretched basis it clears
    most of the steps the Cauchy-Schwarz bound trips on, on the random
    basis (where the Cauchy-Schwarz bound is the tighter) none."""
    basis, model, s = solved
    ao = s._affine
    lift, g, steps = CLEAR
    _, P, V, F = chunk_inputs(s, model, lift, g)
    rb = s._rb_extra()

    def run():
        return k5.affine_chunked_plain(ao, P, V, F, rb, steps, 4,
                                       rebase_every=steps)

    got, moved = change(run)
    with monkeypatch.context() as m:
        no_interval(m)
        want, before = change(run)
    assert got[2] == want[2] == steps
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert before["k5.interval_clears"] == 0
    assert before["k5.exact_checks"] > 0
    assert moved["k5.exact_checks"] + moved["k5.interval_clears"] == \
        before["k5.exact_checks"]
    if basis == "stretched":
        assert moved["k5.interval_clears"] > moved["k5.exact_checks"]
    else:
        assert moved["k5.interval_clears"] == 0


def test_the_exact_free_build_keeps_the_cauchy_schwarz_stop(solved):
    """The exact-free build stops at the Cauchy-Schwarz bound's first trip
    (its k is the JAX package's), whatever the interval bound would say:
    on the floor-clear window it stops where that bound first trips, and
    counts neither checks nor interval clears."""
    _, model, s = solved
    ao = s._affine
    lift, g, steps = CLEAR
    _, P, V, F = chunk_inputs(s, model, lift, g)
    rb = s._rb_extra()
    trips = []
    real = k5.floor_bound

    def spy(*a, **kw):
        out = real(*a, **kw)
        trips.append(bool(out.any()))
        return out

    k5.floor_bound = spy
    try:
        got, moved = change(lambda: k5.affine_chunked_plain(
            ao, P, V, F, rb, steps, 4, rebase_every=steps,
            options=k5.ChunkOptions(floor_exact=False)))
    finally:
        k5.floor_bound = real
    assert got[2] == trips.index(True) < steps
    assert moved["k5.exact_checks"] == moved["k5.interval_clears"] == 0
