"""The plain reference of the reduced solve: operands and stepping.

Works out again, from the scene and the bases files alone, what the
program's ``prepare`` derives (at commit
694e46ca6bbdc322cf66d9b3fd65d3e4c5b05da3: ``sim/reduced.py``
``prepare_reduced_group`` and ``prepare_global_matrix``), and steps the
hyper-reduced projective dynamics in plain PyTorch, B sims at once:

* per dimension d, ``Ar_d = U_d^T A_d U_d`` and ``U_d^T A_c`` with ``A_c =
  A_d - M / dt^2`` (the displacement form q = s + U u);
* per group, the DEIM rows kept for ``oversample x modes`` modes (the
  group's ``served.modes``: one number for every group or a ``{group:
  number}`` map) and ``W_d = U_d^T (S^T V)_d (PtV_d^T PtV_d + la_d I)^-1
  PtV_d^T`` with the program's Tikhonov term ``la_d = 1e-8 tr / K + 1e-12
  (max tr / K + 1e-30)``;
* a step: s = P + dt eta V + dt^2 f / m, its y row clamped at the floor;
  c = -U^T A_c s; rb = 0, then ``iterations`` times: u = Ar^-1 rb, the
  selected rows projected at s + U u by their kind's ``rows``, rb = c +
  sum W p; finally u = Ar^-1 rb, q = s + U u, V = (q - P) / dt.

``precision="float64"`` is the reference.  ``precision="tf32"`` is the
control: float32 state and operands, every matrix product's operands
rounded to TF32 (10 explicit mantissa bits) and summed in float32, as the
tensor cores compute a float32 product with TF32 on; it is emulated, so it
runs alike on the CPU and on the card.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import torch

from portbench.reference.fom import tensor_data
from portbench.reference.scene import (FLOOR_HEIGHT, Scene, global_block,
                                       per_group)

PRECISIONS = {"float64": torch.float64, "tf32": torch.float32}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero in
    magnitude), kept in float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class ReducedReference:
    def __init__(self, scene: Scene, cfg: dict, basis_dir: str,
                 pos_path: str, device="cpu", precision="float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.scene, self.device, self.precision = scene, device, precision
        self.dtype = PRECISIONS[precision]
        self.dt, self.eta = float(cfg["dt"]), 1.0 - float(cfg["damping"])
        self.iterations = int(cfg["iterations"])
        served = cfg["served"]
        comps = np.load(pos_path)["components"]
        r = int(served["position_modes"])
        U = comps[:r].transpose(1, 0, 2)                       # (N, r, 3)
        A = global_block(scene, self.dt)
        Ac = (A - scipy.sparse.diags(scene.masses / self.dt ** 2)).tocsr()
        Ar = np.stack([U[:, :, d].T @ (A @ U[:, :, d]) for d in range(3)])
        UtAc = np.stack([(Ac.T @ U[:, :, d]).T for d in range(3)])
        groups, sel_verts = [], []
        for g in scene.groups.values():
            W, alphas, rows = self._group(g, basis_dir, served, U)
            corners = g.kind.corners(g.data)[alphas]          # (m, c)
            sel_verts.append(corners.reshape(-1))
            data = {k: (v[alphas] if isinstance(v, np.ndarray)
                        and v.ndim and len(v) == g.num else v)
                    for k, v in g.data.items()}
            groups.append((g.kind, W, corners, rows, data))
        sel = np.unique(np.concatenate(sel_verts))
        lookup = np.full(scene.n, -1, dtype=np.int64)
        lookup[sel] = np.arange(len(sel))
        t = self._t
        self.r, self.n_sel = r, len(sel)
        self.sel = torch.as_tensor(sel, device=device)
        self.U = t(U.transpose(2, 0, 1))                       # (3, N, r)
        self.U_sel = t(U[sel].transpose(2, 0, 1))              # (3, n_sel, r)
        self.inv = t(np.linalg.inv(Ar))                        # (3, r, r)
        self.UtAc = t(UtAc)                                    # (3, r, N)
        self.inv_mass = t(1.0 / scene.masses)
        self.ops = []
        for kind, W, corners, rows, data in groups:
            self.ops.append((kind, t(W),
                             torch.as_tensor(lookup[corners], device=device),
                             torch.as_tensor(rows, device=device),
                             tensor_data(data, device, self.dtype)))

    def _t(self, x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=self.dtype,
                               device=self.device)

    @staticmethod
    def _group(g, basis_dir, served, U):
        """(W (3, r, n_pt), picked elements (n_pt,), row of each pick)."""
        data = np.load(f"{basis_dir}/{g.name}/basis.npz")
        asked = per_group(served["modes"], g.name)
        Vj = data["components"].swapaxes(0, 1)[:, :asked, :]   # (ep, K, 3)
        K = Vj.shape[1]
        ranges = data["interpol_alpha_ranges"]
        idx = min(int(round(asked * float(served["oversample"]))),
                  len(ranges))
        n_pt = int(ranges[idx - 1])
        alphas = data["interpol_alphas"][:n_pt].astype(np.int64)
        Pt = data["Pt"][:n_pt].astype(np.int64)
        PtV = Vj[Pt]                                           # (n_pt, K, 3)
        AtA = np.einsum("nad,nbd->abd", PtV, PtV)
        tr = np.trace(AtA)
        la = 1e-8 * tr / K + 1e-12 * (np.max(tr) / K + 1e-30)
        W = []
        for d in range(3):
            proj = g.ST @ Vj[:, :, d]                          # (N, K)
            inv_pt = np.linalg.solve(AtA[:, :, d] + la[d] * np.eye(K),
                                     PtV[:, :, d].T)
            W.append(U[:, :, d].T @ (proj @ inv_pt))
        return np.stack(W), alphas, Pt % g.p

    # ------------------------------------------------------------------
    def _mm(self, eq, a, b):
        if self.precision == "tf32":
            a, b = tf32_round(a), tf32_round(b)
        return torch.einsum(eq, a, b)

    def _project(self, q_sel):
        """rb's group terms sum_g W_g p_g of the selected rows at q_sel
        (B, 3, n_sel) -> (B, 3, r)."""
        total = 0.0
        pts = q_sel.transpose(1, 2)                            # (B, n_sel, 3)
        for kind, W, corners, rows, data in self.ops:
            p_all = kind.rows(pts[:, corners], data)           # (B, m, p, 3)
            p = torch.gather(p_all, 2, rows.view(1, -1, 1, 1).expand(
                p_all.shape[0], -1, 1, 3))[:, :, 0]            # (B, m, 3)
            total = total + self._mm("drn,bnd->bdr", W, p)
        return total

    def step(self, P, V, fext):
        """One step of B sims, (B, 3, N) each -> (P', V', clamped (B,))."""
        sn = P + self.dt * self.eta * V + self.dt * self.dt * fext * (
            self.inv_mass)
        clamped = torch.zeros(P.shape[0], dtype=torch.bool,
                              device=P.device)
        if self.scene.floor:
            y = sn[:, 1]
            clamped = (y < FLOOR_HEIGHT).any(dim=1)
            sn = torch.cat([sn[:, :1], y.clamp(min=FLOOR_HEIGHT)[:, None],
                            sn[:, 2:]], dim=1)
        c = -self._mm("drn,bdn->bdr", self.UtAc, sn)
        s_sel = sn[:, :, self.sel]
        rb = torch.zeros_like(c)
        for _ in range(self.iterations):
            u = self._mm("dsr,bdr->bds", self.inv, rb)
            q_sel = s_sel + self._mm("dnr,bdr->bdn", self.U_sel, u)
            rb = c + self._project(q_sel)
        u = self._mm("dsr,bdr->bds", self.inv, rb)
        q = sn + self._mm("dnr,bdr->bdn", self.U, u)
        return q, (q - P) / self.dt, clamped

    def rollout(self, P0, V0, fext, steps: int):
        """``steps`` steps of B sims from host (B, N, 3) float64 states and
        forces -> dict of host float64 arrays: "P", "V" (B, N, 3), "disp"
        (B,) the largest |q - P0| entry over the rollout, "speed" (B,) the
        largest |V| entry, "clamp_steps" (B,) the steps whose predictor the
        floor clamped."""
        def dev(x):
            return self._t(np.asarray(x).transpose(0, 2, 1))

        P, V, F = dev(P0), dev(V0), dev(fext)
        start = P.clone()
        zero = torch.zeros(P.shape[0], dtype=self.dtype, device=self.device)
        disp, speed = zero.clone(), zero.clone()
        clamps = torch.zeros(P.shape[0], dtype=torch.int64,
                             device=self.device)
        for _ in range(steps):
            P, V, cl = self.step(P, V, F)
            disp = torch.maximum(disp, (P - start).abs().amax(dim=(1, 2)))
            speed = torch.maximum(speed, V.abs().amax(dim=(1, 2)))
            clamps += cl
        out = {k: v.transpose(1, 2).double().cpu().numpy()
               for k, v in (("P", P), ("V", V))}
        out.update(disp=disp.double().cpu().numpy(),
                   speed=speed.double().cpu().numpy(),
                   clamp_steps=clamps.cpu().numpy())
        return out
