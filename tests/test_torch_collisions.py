"""The port's self-collision functions (``sim/collisions.py``,
``sim/collisions_device.py``) against the JAX package's, float64 on the
CPU, on the jittered 8x8 cloth of ``tests/test_self_collision.py`` (vertex
spacing ~4x min_dist, some non-adjacent pairs inside it): the closest point
on a triangle, both host resolvers, the device pass, the exact clearance
probe and the lower bound, each to 1e-12; the row slabs against the single
slab; the bound at most the probe."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from animsnapbases_tpu.geometry.procedural import cloth_model
from animsnapbases_tpu.sim import collisions as jcol
from animsnapbases_tpu.sim import collisions_device as jdev
from animsnapbases_tpu_torch.sim import collisions, collisions_device

TOL = 1e-12


def crumpled_cloth(scale=0.004, seed=0):
    V, F = cloth_model(8, 8)
    rng = np.random.default_rng(seed)
    V = V * scale
    V = V + rng.normal(scale=0.3 * scale, size=V.shape)
    return V, F


def folded_cloth(seed=0):
    """The 6x12 cloth of ``tests/test_self_collision.py`` folded onto
    itself, the layers 0.6 min_dist apart, jittered: close triangle pairs
    for the triangle-pair pass."""
    V, F = cloth_model(6, 12)
    V = V * 0.004
    y = V[:, 1]
    top = y > 5.5 * 0.004
    V[top, 1] = 11 * 0.004 - y[top]
    V[top, 2] += 0.0006
    V = V + np.random.default_rng(seed).normal(scale=2e-5, size=V.shape)
    return V, F


def tensors(V, F):
    return torch.as_tensor(V), torch.as_tensor(F, dtype=torch.int64)


def test_closest_point_matches_jax_and_host():
    rng = np.random.default_rng(3)
    tri = rng.normal(size=(200, 3, 3))
    p = rng.normal(size=(200, 3))
    # points in each Voronoi region: near the corners and the edges too
    p[:30] = tri[:30, 0] - 0.3 * (tri[:30, 1] + tri[:30, 2] - 2 * tri[:30, 0])
    p[30:60] = 0.5 * (tri[30:60, 1] + tri[30:60, 2]) + rng.normal(
        scale=0.05, size=(30, 3))
    got = collisions_device.closest_point_on_triangle(
        *(torch.as_tensor(x) for x in (p, tri[:, 0], tri[:, 1], tri[:, 2])))
    for i in range(len(p)):
        want = np.asarray(jdev.closest_point_on_triangle(
            jnp.asarray(p[i]), *map(jnp.asarray, tri[i])))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=TOL)
        d_host, c_host = collisions._point_triangle_closest(p[i], *tri[i])
        d_jax, c_jax = jcol._point_triangle_closest(p[i], *tri[i])
        np.testing.assert_array_equal(c_host, c_jax)
        assert d_host == d_jax
        np.testing.assert_allclose(got[i].numpy(), c_host, rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_resolvers_match_jax(seed):
    V, F = crumpled_cloth(seed=seed)
    fast = collisions.resolve_self_collision_fast(V, F)
    assert np.abs(fast - V).max() > 0            # contacts resolved
    np.testing.assert_array_equal(fast, jcol.resolve_self_collision_fast(V, F))
    Vf, Ff = folded_cloth(seed)
    tri = collisions.resolve_triangle_self_collisions(Vf, Ff)
    assert np.abs(tri - Vf).max() > 0
    np.testing.assert_array_equal(
        tri, jcol.resolve_triangle_self_collisions(Vf, Ff))
    both = collisions.resolve_self_collisions(V, F)
    np.testing.assert_array_equal(
        both, jcol.resolve_triangle_self_collisions(
            jcol.resolve_self_collision_fast(V, F), F))
    vel = np.random.default_rng(seed).normal(size=V.shape)
    np.testing.assert_array_equal(
        collisions.tangential_friction_response(vel, both - V, 0.3, 0.1),
        jcol.tangential_friction_response(vel, both - V, 0.3, 0.1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_pass_probe_and_bound_match_jax(seed):
    V, F = crumpled_cloth(seed=seed)
    q, f = tensors(V, F)
    jq, jf = jnp.asarray(V), jnp.asarray(F)
    out = collisions_device.resolve_self_collision_device(q, f).numpy()
    assert np.abs(out - V).max() > 0            # the pass pushes
    np.testing.assert_allclose(
        out, np.asarray(jdev.resolve_self_collision_device(jq, jf)),
        rtol=0, atol=TOL)
    # the device pass is the host vertex pass (no ties on jittered input)
    np.testing.assert_allclose(
        out, collisions.resolve_self_collision_fast(V, F), rtol=0, atol=TOL)
    probe = float(collisions_device.min_clearance_device(q, f))
    bound = float(collisions_device.min_clearance_lower_bound_device(q, f))
    assert abs(probe - float(jdev.min_clearance_device(jq, jf))) <= TOL
    assert abs(bound - float(
        jdev.min_clearance_lower_bound_device(jq, jf))) <= TOL
    assert bound <= probe
    np.testing.assert_array_equal(
        collisions_device.candidates(q, f).numpy(),
        np.argsort(((V[:, None] - V[F].mean(1)[None]) ** 2).sum(-1),
                   axis=1, kind="stable")[:, :5])


def test_blocked_equals_unblocked():
    """Past the pair budget the candidates and the bound's minimum are
    computed in row slabs: per-row topk and minima give the same rows."""
    V, F = crumpled_cloth()
    q, f = tensors(V, F)
    m = F.shape[0]
    for rows in (1, 7, 16, 63):
        tiny = rows * m
        for fn in (collisions_device.resolve_self_collision_device,
                   collisions_device.min_clearance_device,
                   collisions_device.min_clearance_lower_bound_device,
                   collisions_device.candidates):
            whole = fn(q, f)
            assert torch.equal(fn(q, f, max_pairs=tiny), whole), (
                fn.__name__, rows)
    assert collisions_device._block_rows(64, m, 16 * m) == 16
    assert collisions_device._block_rows(64, m, 1) == 1


def test_bound_is_sound_and_positive_when_clear():
    """bound <= probe on crumpled cloths (the direction the serving tier
    needs), and the bound certifies a flat, well-separated cloth."""
    rng = np.random.default_rng(7)
    for trial in range(5):
        V, F = crumpled_cloth()
        V = V + 0.03 * rng.normal(size=V.shape)
        q, f = tensors(V, F)
        lb = float(collisions_device.min_clearance_lower_bound_device(q, f))
        exact = float(collisions_device.min_clearance_device(q, f))
        assert lb <= exact, (trial, lb, exact)
    V, F = cloth_model(12, 12)
    lb = float(collisions_device.min_clearance_lower_bound_device(
        *tensors(V, F)))
    assert lb > 0.0


def test_make_collide_and_float32():
    """``make_collide`` holds the faces on the device once; the pass in
    float32 agrees with float64 to float32 rounding on the same cloth."""
    V, F = crumpled_cloth()
    collide = collisions_device.make_collide(F, "cpu")
    assert collide.faces.dtype == torch.int64
    q = torch.as_tensor(V)
    np.testing.assert_array_equal(
        collide(q).numpy(),
        collisions_device.resolve_self_collision_device(
            q, torch.as_tensor(F)).numpy())
    out32 = collide(q.float()).double().numpy()
    np.testing.assert_allclose(out32, collide(q).numpy(), rtol=0,
                               atol=1e-6 * np.abs(V).max())


def test_one_distance_for_the_pass_and_the_tier():
    """The pass and the reduced solver's serving tier read one distance,
    ``collisions_device.MIN_DIST`` (the JAX package's 0.001): the tier's
    certificate (the pass is the identity while the probed clearance is
    at least it) would not hold for a pass at another distance, so the
    solver offers no switch for it."""
    import inspect

    from animsnapbases_tpu_torch.sim import reduced

    assert collisions_device.MIN_DIST == 0.001
    assert inspect.signature(
        collisions_device.resolve_self_collision_device).parameters[
            "min_dist"].default == collisions_device.MIN_DIST
    assert reduced.MIN_DIST is collisions_device.MIN_DIST
    assert not hasattr(reduced.AnimSnapBasesSolver, "self_collision_min_dist")
    # at a clearance just above MIN_DIST the pass is the identity
    V, F = cloth_model(6, 6)
    V = V * 1.5 * collisions_device.MIN_DIST
    q, f = tensors(V, F)
    assert float(collisions_device.min_clearance_device(q, f)) >= \
        collisions_device.MIN_DIST
    np.testing.assert_array_equal(
        collisions_device.make_collide(F, "cpu")(q).numpy(), V)
