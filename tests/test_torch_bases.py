"""The bases pipeline of the PyTorch port (``config/bases_config.py``,
``snapshots/nonlinear.py``, ``ops/podlinalg.py``, ``ops/deim_scan.py``,
``bases/{greedy,constraints,position_reduction}.py``, ``geometry/mass.py``,
``io/binfmt.py``, ``utils/{checks,timing}.py``) against the JAX package,
float64 on the CPU, on the same seeded inputs.

Inputs: synthetic low-rank snapshot tensors from numpy seeds, random
bases (DEIM at K = 40 and 80, either side of DEIM_DEVICE_MIN_K = 64), and
a recording of the 10x10 cloth by the port's full-order solver (16 frames,
read by both packages from the same files).

Tolerances.  The POD is the Gram method in both packages (X^T X, then a
symmetric eigensolver), whose modes are determined by the data only as
far as the Gram product's rounding allows: ``chip_smoke.pod_bounds`` gives
per mode the first-order bound (Weyl for the singular values,
Davis-Kahan for the vectors) for Gram products that differ by 16 float64
units of the largest eigenvalue.  Leading modes are held at 1e-9 up to
sign and singular values at 1e-10 relative, as far as that bound allows;
DEIM picks must be equal or ties of the greedy's argmax
(``chip_smoke.deim_picks_agree``).  Everything else (configs, files,
masses, picks on random bases) exactly or to 1e-12.
"""

import os
import types
import warnings

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp

import chip_smoke as cs
from animsnapbases_tpu.bases import constraints as jcons
from animsnapbases_tpu.bases import greedy as jgreedy
from animsnapbases_tpu.bases.position_reduction import (
    position_basis_from_trajectory as jax_position_basis,
)
from animsnapbases_tpu.config.bases_config import BasesConfig as JaxConfig
from animsnapbases_tpu.geometry import mass as jmass
from animsnapbases_tpu.io import binfmt as jbin
from animsnapbases_tpu.io.meshes import save_obj
from animsnapbases_tpu.ops import deim_scan as jdeim
from animsnapbases_tpu.ops import podlinalg as jpod
from animsnapbases_tpu.snapshots.nonlinear import (
    NonlinearSnapshots as JaxSnapshots,
)
from animsnapbases_tpu.utils import checks as jchecks
from animsnapbases_tpu_torch.bases import constraints as tcons
from animsnapbases_tpu_torch.bases import greedy
from animsnapbases_tpu_torch.bases.position_reduction import (
    position_basis_from_trajectory,
)
from animsnapbases_tpu_torch.config.bases_config import BasesConfig
from animsnapbases_tpu_torch.geometry import mass
from animsnapbases_tpu_torch.geometry.procedural import cloth_model
from animsnapbases_tpu_torch.io import binfmt
from animsnapbases_tpu_torch.ops import deim_scan, podlinalg
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.solver import Solver
from animsnapbases_tpu_torch.snapshots.nonlinear import NonlinearSnapshots
from animsnapbases_tpu_torch.utils import checks, timing

PACKAGES = {
    "jax": (JaxConfig, JaxSnapshots, jcons.ConstraintComponents, {}),
    "torch": (BasesConfig, NonlinearSnapshots, tcons.ConstraintComponents,
              {"device": "cpu"}),
}


def synthetic_p_tensor(F=14, e=9, p=2, rank=4, seed=0, noise=0.01):
    """Smooth low-rank constraint-projection snapshots (F, e*p, 3)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, F)
    modes = rng.normal(size=(rank, e * p, 3))
    weights = np.stack([np.sin(2 * np.pi * (k + 1) * t + rng.uniform(0, 1))
                        for k in range(rank)])
    X = np.einsum("kf,knd->fnd", weights, modes)
    return X + noise * rng.normal(size=X.shape)


def config_dict(tmp_path, F, p=2, K=8, **cp):
    d = {
        "object": {"experiment_dir": str(tmp_path) + "/", "mesh": "m",
                   "volumetric": False, "experiment": "e",
                   "snap_format": ".off"},
        "vertexPos_bases": {"computeState": {"compute": False}},
        "constraintProj_bases": {
            "computeState": {"compute": True, "run_main": True,
                             "testingComputations": "_Release"},
            "constraintType": {"name": "tris_strain", "elements": "_tris",
                               "p_snaps_folder": "/x",
                               "assembly_file_name": "assembly_ST.npz",
                               "assembly_key": "tris_strain",
                               "snaps_pattern_full_p": "/t.npz",
                               "constrained_elements": "", "rowSize": p},
            "snapshots": {"numFrames": F, "frame_increment": 1,
                          "preAlignement": "_noAlignement",
                          "reduced_snaps_available": False},
            "basis_type": "pod_vectorized", "interpolation_type": "deim",
            "desired_num_components": K, "bases_res_tol": 1e-20, "dim": 3,
            "max_element_per_geom_vert": 100, "rest_shape": "first",
            "massWeighted": "_nonWeighted",
            "standarized": "_nonStandarized", "supported": "_Global",
            "orthogonalized": "_nonOrthogonalized",
            "store_sing_val": False, "store_to_files": False,
            "run_tests": False, "visualize_geom_elements": False,
            "visualize_elements_at_bases_num": 0},
    }
    d["constraintProj_bases"].update(cp)
    return d


def make_cc(pkg, tmp_path, X, p=2, K=8, **cp):
    """``pkg``'s ConstraintComponents on the snapshot tensor X."""
    config, snaps, components, kw = PACKAGES[pkg]
    param = config.from_dict(config_dict(tmp_path / pkg, X.shape[0], p, K,
                                         **cp),
                             results_dir=str(tmp_path / pkg / "results"))
    os.makedirs(param.constProj_output_directory, exist_ok=True)
    nl = snaps(param)
    nl.config()
    nl.snapTensor = X.copy()
    nl.test_snapTensor = X.copy()
    nl.num_constained_elements = X.shape[1] // p
    nl.frs = X.shape[0]
    cc = components(param, nl, **kw)
    cc.St = scipy.sparse.identity(X.shape[1], format="csr")
    return cc


def gram_singular_values(X2d):
    return np.asarray(jpod.snapshot_pod(jnp.asarray(X2d))[1])


def assert_pod_close(S_ref, comps_ref, S, comps, K):
    """Singular values and sign-aligned components within
    ``chip_smoke.pod_bounds``; the leading modes it allows within 1e-10 /
    1e-9."""
    ds, du = cs.pod_bounds(S_ref, K)
    d_s = np.abs(np.asarray(S[:K]) - S_ref[:K])
    d_u = cs.sign_aligned_diff(comps_ref[:K], comps[:K])
    assert (d_s <= ds).all(), (d_s / ds).max()
    assert (d_u <= du).all(), (d_u / du).max()
    assert d_u[0] <= 1e-9 and d_s[0] <= 1e-10 * S_ref[0]
    return d_u


# ---------------------------------------------------------------------------
# POD
# ---------------------------------------------------------------------------

def test_snapshot_pod_matches_jax():
    X = synthetic_p_tensor(F=20, e=30, rank=6, seed=1)
    X2d = X.reshape(20, -1).T
    U_j, s_j, Vt_j = (np.asarray(a) for a in jpod.snapshot_pod(
        jnp.asarray(X2d)))
    U, s, Vt = (a.numpy() for a in podlinalg.snapshot_pod(X2d, "cpu"))
    assert_pod_close(s_j, U_j.T, s, U.T, 20)
    np.testing.assert_allclose(U * s, X2d @ Vt.T, rtol=0, atol=1e-12)
    U_h, s_h, Vt_h = podlinalg.snapshot_pod_host(X2d, n_modes=5)
    U_hj, s_hj, _ = jpod.snapshot_pod_host(X2d, n_modes=5)
    np.testing.assert_array_equal(U_h, U_hj)
    np.testing.assert_array_equal(s_h, s_hj)
    assert U_h.shape == (X2d.shape[0], 5)


def rank_deficient(F, e, rank, seed):
    """Snapshots whose frames past ``rank`` are zero: the Gram matrix has
    exactly zero eigenvalues (a rank deficiency within rounding leaves
    singular values near sqrt(eps) of the first, above the zero-fill)."""
    X = synthetic_p_tensor(F=F, e=e, rank=rank, seed=seed)
    X[rank:] = 0.0
    return X


def test_snapshot_pod_zero_fills_past_the_rank():
    X = rank_deficient(10, 20, 3, 2)
    U, s, _ = podlinalg.snapshot_pod(X.reshape(10, -1).T, "cpu")
    rank = int((s > 1e-12 * s[0]).sum())
    assert rank == 3
    assert not U[:, rank:].any()
    U_j, _, _ = jpod.snapshot_pod(jnp.asarray(X.reshape(10, -1).T))
    assert not np.asarray(U_j)[:, rank:].any()


@pytest.mark.parametrize("std,orth,weighted", [
    (False, False, False), (True, False, False), (False, True, False),
    (True, True, False)])
def test_pod_vectorized_and_post_process_match_jax(tmp_path, std, orth,
                                                   weighted):
    X = synthetic_p_tensor(F=16, e=12, rank=5, seed=3)
    cp = {"standarized": "_Standarized" if std else "_nonStandarized",
          "orthogonalized": ("_Orthogonalized" if orth
                             else "_nonOrthogonalized")}
    ccs = {pkg: make_cc(pkg, tmp_path, X, K=6, **cp) for pkg in PACKAGES}
    for cc in ccs.values():
        if std:
            cc.nonlinearSnapshots.standardize()
        cc.compute_components_store_singvalues()
    S_ref = gram_singular_values(
        ccs["jax"].nonlinearSnapshots.snapTensor.reshape(16, -1).T)
    assert_pod_close(S_ref, ccs["jax"].comps, ccs["torch"].singVals,
                     ccs["torch"].comps, 6)
    # a mode's sign is free in both packages; the post-processing (which
    # adds the mean back) is held on sign-aligned modes
    a, b = ccs["jax"].comps, ccs["torch"].comps
    sign = np.where((a * b).sum(axis=(1, 2)) < 0, -1.0, 1.0)
    ccs["torch"].comps = b * sign[:, None, None]
    for cc in ccs.values():
        cc.post_process_components()
    np.testing.assert_allclose(ccs["torch"].nonlinearSnapshots.snapTensor,
                               ccs["jax"].nonlinearSnapshots.snapTensor,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ccs["torch"].comps, ccs["jax"].comps, rtol=0,
                               atol=1e-9)


def test_pod_vectorized_truncates_to_the_rank_with_a_warning(tmp_path):
    X = rank_deficient(12, 10, 3, 4)
    out = {}
    for pkg in PACKAGES:
        cc = make_cc(pkg, tmp_path, X, K=6)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            cc.compute_pod_vectorized()
        out[pkg] = (cc.numComp, [str(x.message) for x in w
                                 if "snapshot rank" in str(x.message)])
    assert out["torch"] == out["jax"] and out["torch"][0] == 3
    assert out["torch"][1]


def test_storage_matches_jax(tmp_path):
    X = synthetic_p_tensor(F=10, e=8, rank=4, seed=5)
    files = {}
    for pkg in PACKAGES:
        cc = make_cc(pkg, tmp_path, X, K=4)
        cc.compute_pod_vectorized()
        cc.comps = synthetic_p_tensor(F=4, e=8, seed=6)   # the same comps
        cc.deim(device=False)
        npz = cc.store_components_n_interpol_points()
        cc.store_components_gradually_to_files(1, 2, 1, ".bin")
        d = cc.param.constProj_output_directory
        files[pkg] = (np.load(npz), {n: open(os.path.join(d, n), "rb").read()
                                     for n in sorted(os.listdir(d))
                                     if n.endswith(".bin")})
    a, b = files["jax"][0], files["torch"][0]
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(b[k], a[k])
    assert files["torch"][1] == files["jax"][1] and files["torch"][1]


# ---------------------------------------------------------------------------
# DEIM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [40, 80])
def test_deim_rows_scan_matches_jax(K):
    """The device scan on a random basis, K either side of 64: the JAX
    scan's picks and residual norms."""
    bases = np.random.default_rng(K).normal(size=(600, K, 3))
    Pt_j, res_j = jdeim.deim_rows(jnp.asarray(bases))
    Pt, res = deim_scan.deim_rows(bases, device="cpu")
    np.testing.assert_array_equal(Pt.numpy(), np.asarray(Pt_j))
    np.testing.assert_allclose(res.numpy(), np.asarray(res_j), rtol=1e-10)
    Pt3, alphas, ranges = deim_scan.deim_rows_host_result(bases, 3, K - 5,
                                                          device="cpu")
    want = jdeim.deim_rows_host_result(jnp.asarray(bases), 3, K - 5)
    for got, w in zip((Pt3, alphas, ranges), want):
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("K", [40, 80])
def test_deim_backends_match_jax(tmp_path, monkeypatch, K):
    """ConstraintComponents.deim on both backends, and the default backend
    (the host loop below 64 modes, the scan at and above): the JAX host
    loop's picks."""
    comps = np.random.default_rng(K + 1).normal(size=(K, 500, 3))
    ccs = {pkg: make_cc(pkg, tmp_path, synthetic_p_tensor(), K=K)
           for pkg in PACKAGES}
    for cc in ccs.values():
        cc.comps = comps.copy()
        cc.numComp = K
    ccs["jax"].deim(device=False)
    want = (ccs["jax"].geom_Pt, ccs["jax"].geom_alpha,
            ccs["jax"].geom_alpha_ranges)
    calls = []
    real = tcons.deim_rows_host_result
    monkeypatch.setattr(tcons, "deim_rows_host_result",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cc = ccs["torch"]
    for device in (False, True, None):
        calls.clear()
        cc.deim(device=device)
        for got, w in zip((cc.geom_Pt, cc.geom_alpha, cc.geom_alpha_ranges),
                          want):
            np.testing.assert_array_equal(got, w)
        assert bool(calls) == (device or (device is None and K >= 64))


@pytest.mark.parametrize("device", [False, True])
def test_deim_truncates_at_a_zero_residual(tmp_path, monkeypatch, device):
    """A rank-deficient basis (mode 4 lies in the span of modes 0-3 on every
    row): the host loop truncates at mode 4 with a warning.  On the scan,
    duplicate picks (forced here: the scan's picks past a zero residual are
    the argmax of rounding noise, whose rows differ between any two
    implementations) warn and re-run on the host.  Both as in the JAX
    package."""
    rng = np.random.default_rng(9)
    comps = rng.normal(size=(6, 80, 3))
    comps[4] = 0.5 * comps[0] - 2.0 * comps[2]
    dup = (np.array([60, 71, 21, 6, 60, 0]), np.array([30, 35, 10, 3, 30, 0]),
           np.arange(1, 7))
    monkeypatch.setattr(tcons, "deim_rows_host_result", lambda *a, **k: dup)
    monkeypatch.setattr(jdeim, "deim_rows_host_result", lambda *a, **k: dup)
    out = {}
    for pkg in PACKAGES:
        cc = make_cc(pkg, tmp_path, synthetic_p_tensor(), K=6)
        cc.comps = comps.copy()
        cc.numComp = 6
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            cc.deim(device=device)
        out[pkg] = (cc.numComp, cc.geom_Pt.tolist(), len(cc.comps),
                    [str(x.message) for x in w])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 4
    assert any("zero residual at mode 4" in m for m in out["torch"][3])
    assert device == any("duplicate selections" in m
                         for m in out["torch"][3])


def test_deim_picks_agree_accepts_ties_only():
    """chip_smoke.deim_picks_agree: a basis with two equal rows (7 and 29),
    one of which the greedy picks: the other of the pair picked instead is
    a tie; a row that is not the argmax is not."""
    rng = np.random.default_rng(3)
    comps = rng.normal(size=(5, 40, 3))
    comps[:, 7] = comps[:, 29]
    Pt = deim_scan.deim_rows(comps.swapaxes(0, 1), device="cpu")[0].numpy()
    zero = np.zeros(5)
    assert cs.deim_picks_agree(comps, Pt, Pt, zero) == (True, [])
    k = int(np.nonzero((Pt == 7) | (Pt == 29))[0][0])
    alt = Pt.copy()
    alt[k] = 36 - Pt[k]
    ok, ties = cs.deim_picks_agree(comps, Pt, alt, zero)
    assert ok and ties[0][:3] == (k, Pt[k], alt[k]) and ties[0][3] < 1e-12
    bad = Pt.copy()
    bad[k + 1] = next(i for i in range(40) if i not in Pt and i != 7)
    assert not cs.deim_picks_agree(comps, Pt, bad, zero)[0]


# ---------------------------------------------------------------------------
# the recorded cloth, read by both packages
# ---------------------------------------------------------------------------

FRAMES = 16


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    V, F = cloth_model(10, 10)
    V = V.copy()
    V[:, 2] += 0.15 * V[:, 0]
    model = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                            floor_collision=True, init_height_shift=0.3)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.add_edge_spring_constraint(wi=1e4)
    model.compute_cloth_corner_indices()
    model.fix_surface_side_vertices("left")
    s = Solver("host", device="cpu")
    s.set_model(model)
    args = types.SimpleNamespace(dt=0.016, damping=0.01)
    s.prepare(args)
    path = str(tmp_path_factory.mktemp("rec"))
    s.store_assembly_matrices(path)
    s.set_record_path(path)
    s.set_store_p(True)
    s.max_p_snapshots_num = FRAMES - 1
    f = np.zeros_like(model.positions)
    f[:, 1] = -98.1
    traj = s.run_steps(f, FRAMES, 10, record=True)
    return path, traj, model


@pytest.mark.parametrize("gname", ["tris_strain", "edge_spring"])
def test_recorded_bases_match_jax(recording, tmp_path, gname):
    """bench.py's bases config on the recorded group through both
    packages: DEIM picks equal or ties, components and singular values
    within the Gram method's rounding (the leading modes at 1e-9 and
    1e-10)."""
    import bench
    from animsnapbases_tpu_torch.bases.pipeline import build_group_basis

    path, traj, model = recording
    p = model.groups[gname].p
    K = 8
    _, nl_j, cc_j = bench.build_group_basis(path, gname, p, K, FRAMES - 1,
                                            str(tmp_path / "jax"))
    cc = build_group_basis(path, gname, p, K, FRAMES - 1,
                           str(tmp_path / "torch"), str(tmp_path / "bases"),
                           device="cpu")
    np.testing.assert_array_equal(cc.nonlinearSnapshots.snapTensor,
                                  nl_j.snapTensor)
    S_ref = gram_singular_values(nl_j.snapTensor.reshape(FRAMES - 1, -1).T)
    d_u = assert_pod_close(S_ref, cc_j.comps, cc.singVals, cc.comps, K)
    ok, ties = cs.deim_picks_agree(cc_j.comps, cc_j.geom_Pt, cc.geom_Pt,
                                   d_u)
    assert ok, ties
    np.testing.assert_array_equal(cc.geom_alpha, cc.geom_Pt // p)
    np.testing.assert_array_equal(
        np.load(os.path.join(tmp_path, "bases", gname, "basis.npz"))["Pt"],
        cc.geom_Pt)


def test_position_basis_matches_jax(recording):
    _, traj, _ = recording
    got = position_basis_from_trajectory(traj, 10, device="cpu")
    want = jax_position_basis(traj, 10)
    for d in range(3):
        S = gram_singular_values(traj[:, :, d].T)
        assert_pod_close(S, want[:, :, d], S, got[:, :, d], 10)


def test_position_basis_completes_a_rank_deficient_trajectory():
    """Fewer independent frames than modes (three of five frames zero: the
    Gram matrix's last eigenvalues are exactly zero): the same seeded QR
    completion as the JAX package, orthonormal."""
    rng = np.random.default_rng(4)
    traj = np.zeros((5, 30, 3))
    traj[:2] = rng.normal(size=(2, 30, 3))
    got = position_basis_from_trajectory(traj, 4, device="cpu")
    want = jax_position_basis(traj, 4)
    for d in range(3):
        np.testing.assert_allclose(got[:, :, d] @ got[:, :, d].T, np.eye(4),
                                   rtol=0, atol=1e-12)
        assert cs.sign_aligned_diff(want[:, :, d], got[:, :, d]).max() \
            <= 1e-9


# ---------------------------------------------------------------------------
# config, snapshots, masses, files, checks
# ---------------------------------------------------------------------------

def test_bases_config_matches_jax(tmp_path):
    import dataclasses

    cfg = config_dict(tmp_path, 12, standarized="_Standarized",
                      massWeighted="_Volkwein", supported="_Localized",
                      deim_device=True)
    a = JaxConfig.from_dict(cfg, results_dir=str(tmp_path / "r"))
    b = BasesConfig.from_dict(cfg, results_dir=str(tmp_path / "r"))
    for f in dataclasses.fields(a):
        assert getattr(b, f.name) == getattr(a, f.name), f.name
    b.ensure_dirs()
    assert os.path.isdir(b.constProj_output_directory)
    # the config reads device_mesh_shards as the JAX config does; the
    # bases compute decides what it does (one device here, with a warning:
    # tests/test_torch_block_bases.py)
    for shards in (2, 1):
        cfg["constraintProj_bases"]["device_mesh_shards"] = shards
        assert BasesConfig.from_dict(cfg).device_mesh_shards == shards
        assert JaxConfig.from_dict(cfg).device_mesh_shards == shards


def test_nonlinear_snapshots_match_jax(tmp_path):
    """Reading frame-keyed .npz and per-frame .bin snapshots, the element
    masses from a .bin file and from the mesh, the mass weighting and the
    standardization, as the JAX package does them."""
    V, F = cloth_model(4, 4)
    e, p = len(F), 2
    rng = np.random.default_rng(8)
    frames = {str(i): rng.normal(size=(e * p, 3)) for i in range(7)}
    np.savez(tmp_path / "t.npz", **frames)
    for i, a in frames.items():
        with open(tmp_path / f"f{i}.bin", "wb") as fh:
            fh.write(np.array([e * p, 3], dtype="<i4").tobytes())
            fh.write(a.T.astype("<f8").tobytes())
    mesh_dir = tmp_path / "m"
    mesh_dir.mkdir()
    save_obj(str(mesh_dir / "m.obj"), V, F)
    out = {}
    for pkg, (config, snaps, _, _) in PACKAGES.items():
        cfg = config_dict(tmp_path, 5, massWeighted="_Volkwein",
                          standarized="_Standarized")
        param = config.from_dict(cfg, results_dir=str(tmp_path / "r"))
        param.constProj_train_test_jump = 2
        for src in ("npz", "bin", "mass bin"):
            nl = snaps(param)
            nl.config()
            nl.snapshots_file = (str(tmp_path / "t.npz") if src == "npz"
                                 else str(tmp_path / "f"))
            nl.mass_file = (str(tmp_path / "mass.bin") if src == "mass bin"
                            else "")
            if src == "mass bin":
                jbin.write_masses_bin(nl.mass_file,
                                      np.linspace(1.0, 2.0, e * p))
            nl.read(".npz" if src == "npz" else ".bin")
            nl.load_factorize_masses()
            nl.snapTensor *= nl.massL[:, None]
            nl.standardize()
            out[(pkg, src)] = (nl.snapTensor, nl.test_snapTensor, nl.mass,
                               nl.pre_scale_factor)
    for src in ("npz", "bin", "mass bin"):
        for a, b in zip(out[("jax", src)], out[("torch", src)]):
            np.testing.assert_array_equal(b, a)


def test_masses_and_checks_match_jax():
    V, F = cloth_model(6, 5)
    V = V + 0.1 * np.random.default_rng(1).normal(size=V.shape)
    vm = mass.vertex_masses_voronoi(V, F)
    np.testing.assert_array_equal(vm, jmass.vertex_masses_voronoi(V, F))
    np.testing.assert_array_equal(mass.tri_element_masses(vm, F),
                                  jmass.tri_element_masses(vm, F))
    T = np.array([[0, 1, 6, 7], [1, 2, 7, 8]])
    np.testing.assert_array_equal(mass.lumped_mass_normalized(V, T),
                                  jmass.lumped_mass_normalized(V, T))
    comps = np.random.default_rng(2).normal(size=(4, 30, 3))
    comps[0, :5] = 0.0
    m = np.linspace(1.0, 2.0, 30)
    assert checks.utmu_orthogonality_error(comps, m) == \
        jchecks.utmu_orthogonality_error(comps, m)
    np.testing.assert_array_equal(checks.sparsity_fractions(comps),
                                  jchecks.sparsity_fractions(comps))
    assert checks.ranks_per_dim(comps) == jchecks.ranks_per_dim(comps)


def test_binfmt_writers_match_jax(tmp_path):
    comps = np.random.default_rng(3).normal(size=(4, 9, 3))
    pts = np.arange(7)
    for pkg, mod in (("jax", jbin), ("torch", binfmt)):
        d = tmp_path / pkg
        d.mkdir()
        mod.write_components(str(d / "c"), 10, 4, 9, 3, comps)
        mod.write_points_vector(str(d / "p"), 10, 4, pts)
        jbin.write_masses_bin(str(d / "m.bin"), np.linspace(0, 1, 9))
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    np.testing.assert_array_equal(
        binfmt.read_masses_bin(str(tmp_path / "torch" / "m.bin")),
        jbin.read_masses_bin(str(tmp_path / "jax" / "m.bin")))


def test_greedy_weights_and_timing_match_jax():
    w = np.random.default_rng(5).normal(size=20)
    for x in (w, -w, np.zeros(20)):
        np.testing.assert_array_equal(
            greedy.signed_nonneg_weight(torch.as_tensor(x)).numpy(),
            np.asarray(jgreedy.signed_nonneg_weight(jnp.asarray(x))))

    @timing.log_time
    def stage():
        return 3

    before = len(timing.global_timer().records)
    assert stage() == 3
    assert timing.global_timer().records[before][0] == "stage"
