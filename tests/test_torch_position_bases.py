"""The port's position bases (``bases/{greedy,splocs,pca}.py``,
``snapshots/position.py``) against the JAX package, float64 on the CPU, on
the inputs and at the tolerances of ``tests/test_bases_pos.py``: its
``synthetic_cloth_animation`` (a 6x6 cloth, 12 frames).

Held: the global extraction (picks equal, sigma0 1e-9 relative, residual
norms 1e-8 relative, reconstructions 1e-8), the local-support steps
(weights 1e-8, components 1e-7), one SPLOCS iteration (weights 1e-8,
components 1e-7, energy and E_rms 1e-8 relative); ``PositionComponents``
end to end on the same aligned .h5 files as the JAX class (local-support
PCA, then SPLOCS): the snapshots exactly, the extracted and post-processed
components 1e-9 of their largest entry, the stored ``.bin`` files with
equal headers and sizes and values within 1e-12 of the largest entry (the
two float64 implementations round in other orders: they part by ~4e-14),
the SPLOCS energies 1e-9 relative.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from animsnapbases_tpu.bases import greedy as jgreedy
from animsnapbases_tpu.bases import splocs as jsplocs
from animsnapbases_tpu.bases.pca import PositionComponents as JaxComponents
from animsnapbases_tpu.geometry.geodesics import GeodesicDistance
from animsnapbases_tpu.io import binfmt as jbin
from animsnapbases_tpu_torch.bases import greedy, splocs
from animsnapbases_tpu_torch.bases.pca import PositionComponents
from animsnapbases_tpu_torch.config.bases_config import BasesConfig
from animsnapbases_tpu_torch.io import binfmt
from animsnapbases_tpu_torch.snapshots.position import PositionSnapshots
from test_bases_pos import _write_config_and_data, synthetic_cloth_animation


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _centered_anim():
    anim, faces = synthetic_cloth_animation()
    return anim - anim.mean(axis=0, keepdims=True), faces


def test_extract_global_matches_jax():
    R0, _ = _centered_anim()
    K = 6
    C, W, sig, res, idxs, R = greedy.extract_global(torch.as_tensor(R0), K)
    Cj, Wj, sigj, resj, idxj, Rj = jgreedy.extract_global(jnp.asarray(R0), K)
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(idxj))
    np.testing.assert_allclose(sig.numpy(), np.asarray(sigj), rtol=1e-9)
    np.testing.assert_allclose(res.numpy(), np.asarray(resj), rtol=1e-8,
                               atol=1e-10)
    # the rank-1 terms are sign-invariant: compare reconstructions
    rec = np.einsum("fk,knd->fnd", W.numpy(), C.numpy())
    rec_j = np.einsum("fk,knd->fnd", np.asarray(Wj), np.asarray(Cj))
    np.testing.assert_allclose(rec, rec_j, atol=1e-8)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-8)
    with pytest.raises(TypeError, match="DeviceMesh"):
        greedy.extract_global(torch.as_tensor(R0), K, mesh=object())


def test_local_support_steps_match_jax():
    R0, faces = _centered_anim()
    gd = GeodesicDistance(R0[0], faces)

    def support(idx):
        phi = gd(idx)
        return 1.0 - (np.clip(phi, 0.1, 2.0) - 0.1) / (2.0 - 0.1)

    R, Rj = torch.as_tensor(R0), jnp.asarray(R0)
    for _ in range(4):
        idx = int(greedy.select_vertex(R))
        assert idx == int(jgreedy.select_vertex(Rj))
        sigma0, wk = greedy.dominant_mode(R, idx)
        sj, wj = jgreedy.dominant_mode(Rj, idx)
        np.testing.assert_allclose(float(sigma0), float(sj), rtol=1e-9)
        wk = greedy.signed_nonneg_weight(wk)
        wj = jgreedy.signed_nonneg_weight(wj)
        np.testing.assert_allclose(wk.numpy(), np.asarray(wj), atol=1e-8)
        s = support(idx)
        ck, R = greedy.deflate(R, wk, torch.as_tensor(s))
        cj, Rj = jgreedy.deflate(Rj, wj, jnp.asarray(s))
        np.testing.assert_allclose(ck.numpy(), np.asarray(cj), atol=1e-7)


def test_splocs_iteration_matches_jax():
    X, _ = _centered_anim()
    K, F = 4, X.shape[0]
    C0, W0, *_ = jgreedy.extract_global(jnp.asarray(X), K)
    C0, W0 = np.array(C0), np.array(W0)
    C0[2] = 0.0                      # a zero component: zero activation
    Lambda = np.abs(np.random.default_rng(1).normal(size=(K, X.shape[1])))
    rho = 10.0

    def run(lib, t):
        Xflat = t(X.reshape(F, -1))
        C, W = t(C0), t(W0)
        Rflat = Xflat - W @ C.reshape(K, -1)
        Rflat, W = lib.update_weights(Rflat, C.reshape(K, -1), W)
        C, U, Z = lib.admm_update(C, C * 0.0, W, Xflat, t(Lambda), rho, 5)
        R, sparsity, e_rms, energy = lib.splocs_energy(Xflat, W, Z,
                                                       t(Lambda))
        idx = lib.component_magnitude_argmax(Z)
        return [np.asarray(x) for x in (Rflat, W, C, U, Z, R, sparsity,
                                         e_rms, energy, idx)]

    got = run(splocs, torch.as_tensor)
    ref = run(jsplocs, jnp.asarray)
    names = ("Rflat", "W", "C", "U", "Z", "R", "sparsity", "e_rms",
             "energy")
    for name, a, b in zip(names, got, ref):
        tol = 1e-8 if name in ("W", "sparsity", "e_rms", "energy") else 1e-7
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)
    assert (got[1][:, 2] == 0).all()
    np.testing.assert_array_equal(got[-1], ref[-1])
    x = torch.zeros(2, 3, 3)
    assert (splocs.prox_l1l2(torch.ones(2, 3), x, 0.1) == 0).all()


def _jax_param(tmp_path, splocs_compute):
    from animsnapbases_tpu.config.bases_config import BasesConfig as JaxConf

    jparam = _write_config_and_data(tmp_path, splocs_compute=splocs_compute)
    param = BasesConfig.from_dict(jparam.raw, results_dir=str(
        tmp_path / "results"))
    assert isinstance(jparam, JaxConf)
    return param, jparam


@pytest.mark.parametrize("kind", ["PCA local", "SPLOCS"])
def test_position_components_end_to_end_match_jax(tmp_path, kind):
    param, jparam = _jax_param(tmp_path, kind == "SPLOCS")
    # the port's outputs in a directory of their own
    jparam.vertPos_output_directory = str(tmp_path / "jax_out")
    os.makedirs(jparam.vertPos_output_directory)

    bases = PositionComponents(param, device="cpu")
    ref = JaxComponents(jparam)
    np.testing.assert_array_equal(bases.pos_snapshots.snapTensor,
                                  ref.pos_snapshots.snapTensor)
    assert bases.pos_snapshots.test_verts.shape == ref.pos_snapshots.\
        test_verts.shape
    bases.compute_components_store_singvalues()
    ref.compute_components_store_singvalues()
    top = np.abs(ref.comps).max()
    np.testing.assert_allclose(bases.comps, ref.comps, rtol=0,
                               atol=1e-9 * top)
    np.testing.assert_allclose(bases.weigs, ref.weigs, rtol=0, atol=1e-9)
    np.testing.assert_allclose(bases.measures_at_largeDeforVerts,
                               ref.measures_at_largeDeforVerts, rtol=1e-9)
    if kind == "SPLOCS":
        assert len(bases.splocs_history) == 2
        np.testing.assert_allclose(np.array(bases.splocs_history),
                                   np.array(ref.splocs_history), rtol=1e-9)
    fro = bases.test_convergence(1, 5, 2)
    for a, b in zip(fro, ref.test_convergence(1, 5, 2)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)

    bases.post_process_components()
    ref.post_process_components()
    top = np.abs(ref.comps).max()
    np.testing.assert_allclose(bases.comps, ref.comps, rtol=0,
                               atol=1e-9 * top)
    assert bases.is_utmu_orthogonal(atol=1e-8) and ref.is_utmu_orthogonal()
    assert bases.linear_independent == ref.linear_independent
    np.testing.assert_allclose(bases.test_basesSingVals(),
                               ref.test_basesSingVals(), rtol=1e-9)
    np.testing.assert_array_equal(bases.sparsity, ref.sparsity)

    bases.store_components_to_files(1, 5, 1, ".bin")
    ref.store_components_to_files(1, 5, 1, ".bin")
    for k in range(1, 6):
        name = f"q_pos_F10K{k}.bin"
        ours = os.path.join(param.vertPos_output_directory, name)
        theirs = os.path.join(jparam.vertPos_output_directory, name)
        with open(ours, "rb") as f, open(theirs, "rb") as g:
            raw_a, raw_b = f.read(), g.read()
        assert raw_a[:8] == raw_b[:8] and len(raw_a) == len(raw_b)
        a = binfmt.read_components_bin(ours)
        np.testing.assert_allclose(a, jbin.read_components_bin(theirs),
                                   rtol=0, atol=1e-12 * top)
        np.testing.assert_array_equal(a, bases.comps[:k])
    bases.store_animations(param.vertPos_output_directory)
    assert os.path.exists(os.path.join(param.vertPos_output_directory,
                                       "components.h5"))


def test_position_snapshots_from_arrays_equal_the_h5_path(tmp_path):
    param, _ = _jax_param(tmp_path, False)
    train = os.path.join(param.aligned_snapshots_directory,
                         param.train_aligned_snapshots_animation_file)
    read = PositionSnapshots(train, None, "average", build_geodesics=False)
    from animsnapbases_tpu_torch.io.h5anim import read_animation_h5

    verts, tris, _ = read_animation_h5(train)
    mem = PositionSnapshots.from_arrays(verts.astype(np.float32), tris,
                                        rest_shape="average",
                                        build_geodesics=False)
    for key in ("snapTensor", "mean", "mass", "massL", "invMassL"):
        np.testing.assert_array_equal(getattr(mem, key), getattr(read, key))
    assert mem.pre_scale_factor == read.pre_scale_factor
    assert mem.test_verts is None
    with pytest.raises(ValueError):
        PositionSnapshots.from_arrays(verts, tris, rest_shape="middle")
