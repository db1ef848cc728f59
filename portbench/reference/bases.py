"""The benchmark's own bases maker: record, POD, row DEIM, position POD.

Plain float64 rewrites of, at commit
694e46ca6bbdc322cf66d9b3fd65d3e4c5b05da3:

* ``ops/podlinalg.py`` ``snapshot_pod_host`` (the method of snapshots:
  the Gram matrix's eigenvectors, columns past the numerical rank zero);
* ``bases/constraints.py`` ``compute_pod_vectorized`` (one POD of the
  flattened (e p 3, F) snapshots, truncated at the snapshot rank),
  ``post_process_components`` (standardization undone) and the host loop
  of ``deim`` (row DEIM, per-dimension least squares, the row of largest
  residual energy; ``np.argmax`` takes the first of equal rows, a fixed
  tie-break), and ``snapshots/nonlinear.py`` ``standardize``;
* ``bases/position_reduction.py`` ``position_basis_from_trajectory``.

The files are those ``bases/pipeline.py`` ``reduced_args`` points the
program at: ``<dir>/<group>/basis.npz`` (``components``,
``interpol_alphas``, ``Pt``, ``interpol_verts``,
``interpol_alpha_ranges``) and ``pos_basis.npz`` (``components`` (r, N,
3)).  A group's modes (``bases.modes``) are one number for every group or
a ``{group: number}`` map.  The bases depend on the configuration alone
and are cached under ``portbench/cache/<digest>/``, a fixed directory
inside the checkout; the digest covers the configuration's recipe, the
maker's shared sources and the scene and kind files the configuration
names, so that a kind file added later leaves other configurations'
digests alone.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import shutil
import time
from pathlib import Path

import numpy as np

from portbench.reference import fom
from portbench.reference.scene import (build_scene, gravity, part_path,
                                       per_group)

CACHE = Path(__file__).resolve().parents[1] / "cache"
RECIPE_KEYS = ("scene", "groups", "dt", "damping", "recording", "bases")
MAKER_SOURCES = ("scene.py", "fom.py", "bases.py")


def snapshot_pod(X: np.ndarray):
    """(U (n, F), s (F,)) of X (n, F) by its Gram matrix, descending;
    columns whose singular value is below 1e-12 of the first are zero."""
    w, W = np.linalg.eigh(X.T @ X)
    w, W = w[::-1], W[:, ::-1]
    s = np.sqrt(np.maximum(w, 0.0))
    denom = np.where(s > 1e-12 * (s[0] + 1e-30), s, np.inf)
    return (X @ W) / denom[None, :], s


def pod_vectorized(snaps: np.ndarray, k: int, standardized: bool):
    """(F, e p, 3) snapshots -> components (k', e p, 3), k' = min(k,
    rank); standardized as the reference's ``_Standarized`` (the first
    frame subtracted, scaled by 1 / std, undone on the components)."""
    X = snaps.astype(float)
    if standardized:
        mean = X[0].copy()
        X = X - mean[None]
        scale = 1.0 / np.std(X)
        X = X * scale
    F = X.shape[0]
    U, s = snapshot_pod(X.reshape(F, -1).T)
    rank = int((s > 1e-12 * (s[0] + 1e-30)).sum())
    k = min(k if k > 0 else F, rank)
    comps = U[:, :k].T.reshape(k, X.shape[1], 3)
    if standardized:
        comps = comps / scale + mean[None]
    return comps


def deim_rows(comps: np.ndarray, p: int):
    """Row DEIM on (K, e p, 3) components -> (Pt, alphas, ranges)."""
    bases = comps.swapaxes(0, 1)                      # (ep, K, d)
    K, d = comps.shape[0], comps.shape[2]
    sel = np.empty(K, dtype=np.int64)
    VT = np.empty((d, K, bases.shape[0]))
    for k in range(K):
        vk = bases[:, k, :]
        if k == 0:
            r = vk
        else:
            c = np.empty(vk.shape)
            for i in range(d):
                sol = np.linalg.lstsq(VT[i, :k][:, sel[:k]].T,
                                      vk[sel[:k], i], rcond=None)[0]
                c[:, i] = sol @ VT[i, :k]
            r = c - vk
        sel[k] = int(np.argmax((r ** 2).sum(axis=1)))
        VT[:, k, :] = vk.T
    return sel.copy(), sel // p, np.arange(1, K + 1)


def position_basis(traj: np.ndarray, r: int) -> np.ndarray:
    """(F, N, 3) -> (min(r, F), N, 3), orthonormal per dimension."""
    F, N, _ = traj.shape
    r = min(r, F)
    comps = np.empty((r, N, 3))
    for d in range(3):
        U, s = snapshot_pod(traj[:, :, d].T)
        Ud = U[:, :r]
        if s[r - 1] <= 1e-12 * (float(s[0]) + 1e-30):
            Ud, _ = np.linalg.qr(Ud + 1e-12 * np.random.default_rng(0)
                                 .standard_normal(Ud.shape))
        comps[:, :, d] = Ud.T
    return comps


def digest(cfg: dict, root=None) -> str:
    h = hashlib.sha256(json.dumps({k: cfg[k] for k in RECIPE_KEYS},
                                  sort_keys=True).encode())
    here = Path(__file__).resolve().parent
    named = [part_path("scenes", cfg["scene"]["kind"], root)] + [
        part_path("kinds", k, root) for k in sorted(cfg["groups"])]
    for f in [here / f for f in MAKER_SOURCES] + named:
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def make(cfg: dict, log=print, root=None) -> dict:
    """The bases of configuration ``cfg``, its scene and kinds read from
    the checkout at ``root``, made once and cached -> {"dir": <basis dir>,
    "pos": <pos_basis.npz>, "tail_velocity": (N, 3), "seconds": made here
    (0 when cached)}."""
    out = CACHE / digest(cfg, root)
    done = out / "ready.json"
    made = 0.0
    CACHE.mkdir(parents=True, exist_ok=True)
    with open(str(out) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            t0 = time.perf_counter()
            part = Path(str(out) + ".partial")
            shutil.rmtree(part, ignore_errors=True)
            part.mkdir(parents=True)
            _make_into(cfg, part, log, root)
            made = time.perf_counter() - t0
            (part / "ready.json").write_text(json.dumps({"seconds": made}))
            shutil.rmtree(out, ignore_errors=True)
            os.replace(part, out)
    return {"dir": str(out / "bases"), "pos": str(out / "pos_basis.npz"),
            "tail_velocity": np.load(out / "tail_velocity.npy"),
            "seconds": made}


def _make_into(cfg: dict, out: Path, log, root) -> None:
    scene = build_scene(cfg, root)
    rec, bcfg = cfg["recording"], cfg["bases"]
    t0 = time.perf_counter()
    traj, snaps = fom.record(scene, rec["frames"], rec["iterations"],
                             cfg["dt"], cfg["damping"], gravity(scene),
                             rec.get("events", ()))
    log(f"portbench: recorded {rec['frames']} frames of {scene.n} vertices "
        f"in {time.perf_counter() - t0:.2f} s")
    tail = (traj[-1] - traj[-2]) / cfg["dt"]
    tail[scene.pinned] = 0.0
    np.save(out / "tail_velocity.npy", tail)
    inc = int(bcfg["frame_increment"])
    for name, g in scene.groups.items():
        s = snaps[name][0:bcfg["frames"] * inc:inc]
        comps = pod_vectorized(s, per_group(bcfg["modes"], name), bool(
            bcfg["standardized"]))
        Pt, alphas, ranges = deim_rows(comps, g.p)
        gdir = out / "bases" / name
        gdir.mkdir(parents=True)
        np.savez(gdir / "basis.npz", components=comps,
                 interpol_alphas=alphas, Pt=Pt,
                 interpol_verts=np.empty(0, dtype=np.int64),
                 interpol_alpha_ranges=ranges)
        log(f"portbench: {name}: {comps.shape[0]} modes from {len(s)} "
            f"snapshots, {len(Pt)} DEIM rows")
    pos = traj - scene.positions[None] if bcfg["position"] == (
        "displacements") else traj
    np.savez(out / "pos_basis.npz",
             components=position_basis(pos, int(bcfg["position_modes"])))
