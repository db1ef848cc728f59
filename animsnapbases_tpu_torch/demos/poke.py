"""Poke trajectories and seed selection for the cloth poke scenes.

Counterpart of ``animsnapbases_tpu/demos/poke.py``: the z-motion of an
animated (``user_defined``) positional target and the Voronoi seeds it is
applied at.
"""

from __future__ import annotations

import numpy as np


def create_poke_z_motion_with_jumps(f_l: int, f_j: int, k: int,
                                    z_range: float = 1.0) -> np.ndarray:
    """z-motion repeating k times: 0 -> -z -> +z -> -z -> 0 over f_l frames,
    then f_j paused frames.  Returns (k*(f_l+f_j), 3) with x = y = 0.

    One cycle is made of four ramps (three open quarter ramps and a closed
    return ramp that takes the ``f_l % 4`` remainder) and tiled k times."""
    q = f_l // 4
    z = float(z_range)
    ramps = ((0.0, -z, q, False),
             (-z, +z, q, False),
             (+z, -z, q, False),
             (-z, 0.0, f_l - 3 * q, True))
    cycle = np.concatenate(
        [np.linspace(a, b, m, endpoint=closed)
         for a, b, m, closed in ramps] + [np.zeros(f_j)])
    z_all = np.tile(cycle, k)
    motion = np.zeros((z_all.size, 3))
    motion[:, 2] = z_all
    return motion


def voronoi_seeds_and_partition(V: np.ndarray, F: np.ndarray, k: int):
    """The vertex nearest the centre and k farthest-point seeds on the 2D
    (x, y) projection, with each vertex's nearest seed (a Euclidean
    Voronoi partition).  Returns (seeds (k+1,), labels (n,))."""
    V2 = np.asarray(V)[:, :2]
    center_2d = V2.mean(axis=0)
    center_idx = int(np.argmin(np.linalg.norm(V2 - center_2d, axis=1)))

    seeds = [center_idx]
    for _ in range(k):
        d = np.min(np.linalg.norm(V2[:, None, :] - V2[None, seeds, :],
                                  axis=2), axis=1)
        d[seeds] = -1
        seeds.append(int(np.argmax(d)))
    seeds = np.array(seeds)

    dist_to_seeds = np.linalg.norm(V2[:, None, :] - V2[None, seeds, :],
                                   axis=2)
    labels = np.argmin(dist_to_seeds, axis=1)
    return seeds, labels
