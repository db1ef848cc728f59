"""Smoke of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``.

Drives the port's serving path on the card at the bench scene's full
width and holds each hand-written kernel against its plain PyTorch
version.  Phases, each of which fails the run when it fails:

1. device and build: the card's name and power limit, torch/CUDA/nvcc
   versions, and the build of every kernel from
   ``animsnapbases_tpu_torch/csrc``;
2. the bench scene (the 120x120 procedural cloth of ``bench.py``, 14,400
   vertices, r = 64, 40 DEIM rows per group, random bases made from fixed
   seeds, bfloat16 matrices and float32 state) through
   ``prepare -> step -> run_steps(64)`` on the tiers (kernel 5 serves the
   whole window), then a contact scene (the cloth 0.05 above the floor,
   falling at 2 units/s) whose tier 1 exits early and whose contact tier
   (kernel 3) finishes the window; the same with
   ``resident_chunked_tier1 = False`` (kernel 4, then kernel 3), with
   ``resident_contact_mode = True`` (kernel 5, then kernel 3's contact-mode
   build), with contact mode and ``resident_chunked_tier1 = False`` (no
   tier 1: the contact-mode build alone) and with
   ``CHUNKED_TIER1_MIN_VERTS`` forcing kernel 2 as the contact tier.  Each
   of these runs is a path of its own: the launch counters of all eleven
   wrappers are set to 0 just before it and read just after, and the
   path's own kernels must have launched and no other.  A small scene is
   held against the float64 plain version on the CPU;
3. each kernel against its plain version on the card, from the same state,
   step by step: in one-step calls, and in the steps that one call carries
   inside it (step s of a call of s steps against one plain step from the
   state that the kernel's call of s - 1 steps left, for every s up to
   64; for the contact-mode build also on the contact scene with rebases
   every 3 and 16 steps, so that the mode is entered, carried and left on
   the card, with the y state it carries), and the drift of contact mode's
   incremental projections after 16, 64 and 256 steps;
4. times (CUDA events, median of the repetitions after warm-up; kernel
   1's device time per launch from launches run back to back) beside each
   kernel's bound from its bytes and operations; for kernels 1 and 5, on
   the cluster loop, their staging plans (what each block of the cluster
   keeps in shared memory, what it reads from L2, its bytes, the clusters
   the card holds at once), the loop's slope per iteration and intercept,
   and their operations' time on the cluster's 3 SMs;
2-4 for ensemble serving (:func:`ensemble`): ``make_batched_run`` on a
   ring-down ensemble of 64 sims over 2,000 steps and on a mixed batch of
   16, half of it falling onto the floor, on the default route (batched
   kernel 3's contact-mode build) and with ``resident_contact_mode =
   False`` (its lean build), on a crumpling ensemble of 64 sims on the
   default route, on the mixed batch with ``CHUNKED_TIER1_MIN_VERTS = 0``
   (batched kernels 5 and 2), and ``make_batched_step`` on 64 sims
   (batched kernel 1), each a counted path; every sim of each batched
   kernel against the solo kernel from its state, bit for bit (kernels 2
   and 3, both builds, on the mixed batch and on 64 sims), batched kernel
   5's whole-batch k against the sims' solo k, one step of kernels 2, 3
   (both builds) and 5 against the plain versions on both batches; times at
   1 to 128 sims, with torch.profiler breakdowns; then kernel 4's batched
   build (:func:`exit_batched`, row 4b, which no entry point takes),
   launched directly as a counted path: the ring-down ensemble at 8 and 64
   sims certified over 2,000 steps, the mixed batch's whole-batch exit at
   its first contact sim's first clamp (the plain version's k, two
   launches), carried steps and one step against the plain version, each
   sim bit for bit against solo kernel 4 run for as many steps, times at 1,
   8 and 64 sims in turns with batched kernel 3 (lean);
2-4 for the tet, bending and block-form kinds (:func:`tet_bending`): five
   scenes at full width, from the reference's JSON configs (the tet bar of
   ``bar_automated_deformationgradient.json`` with tets_deformation_gradient
   in DEIM row form and in block form, the same bar with tets_strain and
   verts_bending, and the bench cloth with the bending group of
   ``cloth_automated_bend_spring_strain.json`` in row form and in block
   form), each through ``prepare -> step -> run_steps(64)`` (kernels 1 and
   5), a contact window (kernels 5 and 3's contact-mode build),
   ``make_batched_step`` and ``make_batched_run`` at 8 sims, each a counted
   path, the bar with tets_strain and verts_bending also through every tier
   switch (kernels 4, 3 lean and 2) and the batched routes of kernels 3
   lean, 5 and 2; kernel 1 held against float64, kernels 2-5 against their
   plain versions step by step, every batched sim bit for bit against its
   solo call; times and bounds per scene;
2-4 for animated positional targets (:func:`animated`): the bench cloth
   with the poke of ``scripts/bench_poke.py`` (a 1,536-frame z-motion of
   its vertex nearest the centroid, wi = 1e5, damping doubled), through
   ``run_steps`` on the default tiers (a 2,048-step poke window on kernel 5
   across a chunk and past the schedule's end; the contact scene, kernel 5
   then kernel 3', across the schedule's end), with
   ``resident_chunked_tier1 = False`` and ``resident_contact_mode = False``
   (kernels 4 and 3) and with ``CHUNKED_TIER1_MIN_VERTS = 0`` (kernels 5
   and 2), ``make_batched_run`` with per-sim timelines at 16 sims (batched
   3', 3 lean, and 5 with windows on 2) and a shared one at 64 sims, and
   ``run_steps(record=True)``, each a counted path; every kernel against
   its plain version step by step with a schedule that ends inside the
   window, each batched sim bit for bit against the solo kernel from its
   own schedule, the recorded trajectory bit for bit against a ``step()``
   loop; each kernel timed with the schedule and with a static term in
   turns, beside its bound with the schedule's bytes;
2-4 for kernel 5's build options (:func:`chunk_options`): every option set
   a caller can reach held on the bench scene's tier-1 window and contact
   scene, then the exact-free build and the bound, fold_vc,
   sqrt_free_bound and static_rb off, each through run_steps on the tiers
   and make_batched_run at 8 sims (counted paths), held against its plain
   version, its batched chunk bit for bit against the solo one, timed in
   turns with the default build;
2-4 ``scale`` (:func:`scale_phase`): the 250,000-vertex megacloth of
   ``scripts/bench_megacloth.py`` on the large-model route (kernel 5, then
   kernel 2): run_steps over a 20,000-step rest window on the default,
   exact and exact-free builds (certified, the two builds' end states bit
   for bit equal), a near-floor window on both builds (tier 1, then kernel
   2; the exact-free exit at or before the exact one), make_batched_run
   at 8 sims on the exact-free build, each a counted path; the carried
   steps, the near-floor window and kernel 2 against the plain versions,
   the batched chunk bit for bit against the solo one; the builds timed in
   turns;
6. ``pipeline`` (:func:`pipeline_phase`): bench.py's flagship path on the
   card with real bases, on the bench scene: the full-order recording
   (``Solver(global_solve="host")``, 48 frames at 10 iterations, its
   seconds split into the local stage, the transfers and the LU solves),
   the constraint bases (40 modes, ``pod_vectorized``, row DEIM) and the
   position basis (r = 48), the reduced solver prepared from those files
   as bench.py prepares it, ``run_steps(48)`` (the reduced-vs-FOM mean,
   p99 and max) and ``step()``: one counted path (kernels 1 and 5).  Held:
   a second recording on the card bit for bit, the CPU's first 12 frames
   within 1e-6 of the scene's extent; the bases again on the CPU (DEIM
   picks equal or ties of the greedy's argmax, the POD within the Gram
   method's rounding bound), no warning of the bases pipeline; the
   ring-down window (2,000 steps) certified by tier 1 and floor-clear;
   kernels 1 and 5 against their plain versions on these bases; times,
   kernel 5's floor bound and the stages' seconds;
7. ``per-group`` (:func:`per_group_phase`): the reference's own workflow
   (record a full-order run, compute each constraint group's bases from
   its ``configs/examples/*.json`` config, replay with the reduced solver)
   at the reference's sizes: (a) the demo cloth of
   ``cloth_automated_bend_spring_strain.json`` (20x20, its groups, weights
   and fixed corners) recorded for 200 frames (dense tier), its groups'
   bases from the six ``cloth_automated_{deim,geom}_*`` configs, served as
   the demo asks (``deim_pod_vectorized``, positions full: the dense
   Cholesky on the card) and on the geom bases under a block type; (b) the
   bench cloth on phase [6]'s recording and bases with the positions full
   (the host LU) and with the positions reduced and ``edge_spring`` full;
   each of those solves held step by step against the CPU (one step from
   the CPU's state, within CPU_DEVIATION of the extent) with its
   reduced-vs-FOM statistic; (c) the bar of
   ``bar_automated_deformationgradient.json`` recorded for 71 frames (its
   examples' 70 frames read at increment 1), with
   ``pca_blocks`` + ``deim_block_form`` and ``pod_vectorized`` + ``geom``
   bases from its example configs and a position basis of the recorded
   displacements, served fully reduced under ``deim_pca_blocks`` and
   ``geom_pca_blocks_withSt``: kernels 1 and 5 in their block-form builds
   on real bases, a counted path each, held against their plain versions
   and timed; ``make_batched_run`` and ``make_batched_step`` at 8 sims on
   the demo's dense solve and the bench cloth's mixed one, each sim
   against its solo run on the card (:func:`batched_full`), and both
   refusing the host LU (:func:`refuses_batched`); each stage's seconds
   beside the card's name and power limit;
8. ``self-collision`` (:func:`self_collision_phase`): (a) the 160x160 cloth
   of ``scripts/bench_selfcollision.py`` (25,600 vertices, r = 32, bf16
   matrices) under ``enable_self_collision="device"``: a 40,000-step
   ring-down through ``run_steps``, a counted path (kernel 5 alone) that
   tier 1 must certify, its time by part, the probe, lower bound and pass
   against float64 on the CPU, kernel 5 against its plain version and
   ``self_collision_resident=False`` (kernel 1 with the pass, counted)
   against the tier; (b) the cloth folded onto itself 0.5 min_dist apart:
   ``run_steps(64)`` on kernel 1 with the pass (counted), each step
   rebuilt and held against float64, the pass pushing the layers apart,
   kernel 1 against float64 and timed; the full-order solver's two modes
   against the CPU;
9. ``diff`` (:func:`diff_phase`): differentiable rollouts
   (``sim/diff.py``, float64 plain torch, no kernel) on phase [6]'s
   recording and bases (r = 48): a rollout and its gradients with respect
   to the scales, a force multiplier and the positional targets (two pins
   added) held against the same calls on the CPU, the scales' gradient
   against central differences; the ``--bench`` fit of
   ``demos/fit_material.py`` (its fitted scales, errors, losses, ms an Adam
   step, a rollout's forward and backward, peak memory), which must
   converge; the twin experiment end to end, which must pass the script's
   ``ok``;
10. ``position bases`` (:func:`position_phase`): the reference's
   position-bases workflow (``configs/examples/bunny_gFall_posSubspace.json``,
   the bench cloth in place of the bunny) on the card from the port's own
   recording: the bench scene recorded for 200 frames (its first 48 bit
   for bit phase [6]'s), every 2nd frame imported and aligned
   (``_centered``; the cloth hangs in its plane, so every frame takes the
   rank-2 Procrustes rule), global PCA (100 components), local-support PCA
   and SPLOCS, each held against the CPU's float64 run on the same arrays
   (greedy picks and sigma0 above the residual cut, reconstructions,
   aligned frames, SPLOCS energies), the global components post-processed
   (U^T M U = I) and their first 48 served as the position basis on phase
   [6]'s constraint bases: ``run_steps(48)`` + ``step()``, a counted path
   (kernels 1 and 5), the reduced-vs-FOM statistic beside phase [6]'s POD
   basis; kernel 1 against float64, kernel 5 step by step and in carried
   steps; seconds per stage;
11. ``scenarios`` (:func:`scenarios_phase`): the reference's loop through
   the port's own command lines: (a) ``cloth_automated_bend_spring_strain``
   on its demo config (20x20 cloth, 240 frames, the sides fixed and
   released at frames 20, 60 and 140) recorded by ``sim_cli`` (``Solver``,
   ``--record --record-positions``), the bases of the three
   ``cloth_automated_deim_*`` example configs by ``cli.main`` (npz,
   convergence CSVs, ``function_timings.txt``), the reduced replay by
   ``sim_cli`` (``animSnapBasesSolver``, positions full: the dense
   Cholesky on the card) and ``compute_accuracy`` on the two ``.off``
   sequences; held: each event through 3 frames on the CPU from the
   card's state (recording and replay), the bases against the CPU's run of
   each config, the CSV against the in-memory trajectories; (b) the same
   scenario fully reduced (r = 30 of the recording, float32 state and
   matrices), every frame on kernel 1 through ``run_steps(record=True)``,
   a counted path, prepared again at every event: cond(Ar) per segment,
   at each prepare the card's state through 3 frames on the CPU in
   float64 and float32 (the card held as its float32 twin is), kernel 1
   against float64 on the first step after each prepare, the per-frame
   rel-L2 and normal angle beside the CPU's float64 replay's per segment;
   (c) the accuracy report
   (``analysis/accuracy_report.py``) on phase [6]'s recording and bases:
   48 frames on kernel 1, a counted path, with bfloat16 and with float32
   matrices, under the JAX script's gates (a gate crossed fails the run);
   heat maps only where matplotlib imports;
12. ``multichip`` (:func:`multichip_phase`): (a) the sharded paths
   (``parallel/``) on MC_RANKS ranks on the one card, each a process of a
   gloo group (:func:`multichip_rank`): the bench scene's ring-down
   ensemble (64 sims over 2,000 steps) through ``make_batched_run(mesh)``
   on the resident route (batched kernel 3's contact-mode build) and on
   the large-model route (batched kernel 5, and on the mixed batch its
   windows on batched kernel 2), each rank's launches counted, each sim
   bit for bit against the single-process batch on both routes (the
   large-model route's ranks commit the same least k at every whole-batch
   exit); the TP-reduced step against the single-process step from the
   same state (:func:`tp_against_steps`: its float64 plain version, its
   float32 peer, kernel 1); the element-sharded FOM step (device CG) against
   ``Solver.step``; the 120,001 x 16 sharded POD within ``pod_bounds``;
   phase [6]'s recording through ``ConstraintComponents`` with
   ``device_mesh_shards`` = MC_RANKS (picks equal to the unsharded device
   scan's, modes within ``pod_bounds``, ties of phase [6]'s host DEIM);
   seconds and µs a step per rank; (b) the smoke battery
   (``python -m animsnapbases_tpu_torch.smoke``, nine PASS lines) and the
   sweep (``python -m animsnapbases_tpu_torch.sweep``, ``--jobs 3``) over
   phase [11]'s three example configs, each output against phase [11]'s
   in-process ``cli.main``; (c) the native library of ``io/native.py``
   built, its readers equal to the Python ones;
5. the ``kernels`` line (22 entries: six solo kernels, six batched
   builds, each with its times on the new scenes under ``scenes``, with a
   target schedule under ``animated``, at 250,000 vertices under
   ``megacloth`` and, for kernels 1 and 5, on real bases under
   ``real_bases``, on the bar's block-form bases under ``per_group``,
   under self-collision under ``self_collision`` and on the PCA position
   basis under ``position_bases``, kernel 1 on phase [11]'s replays under
   ``scenarios``, batched kernels 3 (contact mode), 5 and 2 on phase
   [12]'s sharded serving under ``multichip``, then kernel 5's five option
   builds, solo and batched),
   then the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  Without a card it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

from animsnapbases_tpu_torch import holds
# the holds of a kernel against its plain version (one copy, beside the
# smoke battery's)
from animsnapbases_tpu_torch.holds import (  # noqa: F401
    ACC_RATIO,
    F32_EPS,
    REBASE_EVERY,
    STEP_TOL,
    WITNESS_DRAWS,
    as_accurate,
    as_f64,
    hold_step,
    max_abs,
    step_by_step,
    step_share,
)

# published H100 SXM peaks (NVIDIA data sheet, dense; float32 and float64
# on the CUDA cores, where these kernels compute): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.  An operand that the design keeps on the
# chip between steps (shared memory or L2: the loop's operands, M_utac,
# the maps to the gathered values, the y slice of the floor test) counts
# once per call; the passes over the (3, r, N) matrices count where the
# algorithm makes them (each step of kernel 2 and each contact step of
# kernel 3, each chunk or rebase of kernels 3-5).  All bytes are priced at
# the HBM rate: NVIDIA publishes no L2 rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
# the SMs a cluster of kernels 1 and 5 occupies (one block a dimension)
# and their float32 lanes at the H100 SXM's 1,980 MHz boost clock (data
# sheet): the least time the cluster loop's operations take there, beside
# the card-wide bound, which spreads them over all 132 SMs
CLUSTER_SMS = 3
SM_F32_LANES = 128
SM_CLOCK_HZ = 1.98e9
# floating-point operations of one projection row (one column of the
# element table; a block-form element has p of them), counted from
# csrc/iteration.cuh and csrc/strain3d.cuh: the 2x2 clamp with its two
# half-angle steps; the spring row; the tet row: F from the edge vectors
# (54), F^T F (30), 5 sweeps of 3 Jacobi rotations at ~57 each (the
# rotation's 2 divisions and 2 square roots, the 2x2 update, the two
# off-diagonal entries and the 3x2 column update of V: 855), the 3-sort
# (24), the 3 singular values, F V (30), Gram-Schmidt and the cross
# product (36), U diag(d) V^T (72) and the row blend (15); the bending row
TRI_FLOPS = 110
SPRING_FLOPS = 20
TET_FLOPS = 1120
BENDING_FLOPS = 25
KIND_FLOPS = {"tris_strain": TRI_FLOPS, "edge_spring": SPRING_FLOPS,
              "tets_strain": TET_FLOPS, "tets_deformation_gradient":
              TET_FLOPS, "verts_bending": BENDING_FLOPS}

SCENE_STEPS = 64
ITERATIONS = 10
WINDOW_STEPS = 2000
REPS = 50
# the small scene on the card (float32) against the plain float64
# version on the CPU
TOL_SMALL = 1e-3
# the solver's default chunk of kernel 5 (its rebase cadence; kernels 3
# and 4 rebase every REBASE_EVERY steps)
CHUNK_EVERY = 1024
# the contact scene: the bench cloth with its lowest vertex this far above
# the floor, falling at this speed (units/s)
CONTACT_GAP = 0.05
CONTACT_SPEED = 2.0
# calls of the plain versions' 64-step timings (~1-3 s each on the card,
# no warm-up: their time is the function's definition, not a yardstick)
PLAIN_REPS = 1
# seconds of calls before a device time (device_ms), so that the card has
# left its idle clock
DEVICE_WARMUP_S = 0.5
# ensemble serving (make_batched_run / make_batched_step): the ring-down
# ensemble's size, the sizes its per-step time is taken at, and the
# spread of its excitations (sim b: (1 - SPREAD b) x a tenth of the main
# path's end velocity, which the 1.0 x window of phase 4 holds floor-clear
# over WINDOW_STEPS steps: at (1 + 0.02 b) the faster of 64 sims reached
# the floor); the mixed batch's size, half
# of it in the contact scene (contact sim j: CONTACT_RISE + CONTACT_STEP j
# above the contact scene's gap), and the resident_rebase_every of its
# large-model route (kernel 5's chunks, kernel 2's windows).  SIM_ROWS is
# the batched kernels' grouping of sims: a block of kernel 3's O(N)
# launches serves the sims b, b + SIM_ROWS, ... (affine.cu SIM_Y), and
# kernel 2's projection and lift and kernel 3's floor test serve groups of
# SIM_ROWS sims (resident.cu SIM_GROUP, affine.cu Y_GROUP).  The mixed
# batch spans two groups and puts its contact sims at b % SIM_ROWS >=
# SIM_ROWS / 2, so that clamping sims share blocks.
ENSEMBLE = 64
ENSEMBLE_SIZES = (1, 8, 64, 128)
SPREAD = 0.004
MIXED = 16
SIM_ROWS = 8
CONTACT_RISE = 0.15
CONTACT_STEP = 0.1
MIXED_EVERY = 16
# rounds of the in-turns timing of batched kernels 4 and 3 over the window
EXIT_ROUNDS = 3
# contact mode (kernel 3's contact-mode build): the rebase cadences of its
# carried holds on the contact scene (256: none in 64 steps; 3 and 16: the
# mode entered, carried and left), the last also that of its first drift
# reading; the steps of its last drift reading (the last step before the
# default cadence's rebase); and the crumpling ensemble: CRUMPLE sims of
# the contact scene under gravity, sim b lifted CRUMPLE_STEP b more
CONTACT_EVERY = (REBASE_EVERY, 3, 16)
DRIFT_STEPS = REBASE_EVERY
CRUMPLE = 64
CRUMPLE_STEP = 0.01


# the scenes of the tet, bending and block-form kinds
# (:func:`tet_bending_scenes`):
# the reference's sim configs they take their settings from, the bar's
# size, the bench's widths (bench.py: 30 modes per group, 4/3
# oversampled to 40 rows; damping), the depth of their step-by-step holds
# and plain timings (8: cut from 16, half their plain steps, to keep the
# whole script near half its time limit; the tet, bending and block scenes
# took 169.0-194.5 s at 16 and 115.8 s at 8 on an H100), the depth of the
# bar's block-form holds in phase [7] (16: kernel 5's drift from its plain
# version grows with the steps there, and the bar's steps are cheap), the
# size of their batches (make_batched_run) and the scene that takes every
# tier switch
BAR_DEMO = "configs/demos/bar_automated_deformationgradient.json"
CLOTH_DEMO = "configs/demos/cloth_automated_bend_spring_strain.json"
BAR_SIZE = (40, 5, 5)
BAR_LIFT = 6.0
BENCH_MODES = 30
OVERSAMPLE = 4.0 / 3.0
BENCH_DAMPING = 2e-3
NEW_DEPTH = 8
BAR_DEPTH = 16
NEW_BATCH = 8
SWITCH_SCENE = "bar, strain and bending"
# animated targets (:func:`animated`): the poke of scripts/bench_poke.py on
# the bench cloth, z-motion cycles of POKE_CYCLE (f_l, f_j) frames, POKE_Z
# deep, POKE_CYCLES of them (1,536 frames), at wi = POKE_WI; the window of
# its run_steps path (across a kernel-5 chunk and past the schedule's end);
# the frames before the schedule's end at which its tiered runs' contact
# scene and the recorded run start; the rows of make_batched_run's
# timelines (a call of SCENE_STEPS steps runs past them) and the size of
# its shared-timeline ensemble; the depth of the step-by-step holds, whose
# schedule is POKE_DEPTH / 2 rows of the poke's first ramp from frame
# POKE_RAMP; the rounds of the timings in turns
POKE_CYCLE = (40, 8)
POKE_CYCLES = 32
POKE_Z = 0.05
POKE_WI = 1e5
POKE_WINDOW = 2048
POKE_TAIL = 32
POKE_ROWS = 48
POKE_SHARED = 64
POKE_DEPTH = 16
POKE_RAMP = 0
POKE_ROUNDS = 20
# kernel 5's other builds (:func:`chunk_options`): each option of
# ops/affine_chunked.py ChunkOptions set off alone on the bench scene (the
# exact-free build: floor_exact=False), with the lines of
# pallas_resident.py that each changes; the rounds of their timings in
# turns against the default build
OPTION_BUILDS = (
    ("exact-free", {"floor_exact": False},
     ":1212-1233, :1334-1344, :1443-1452, :1511-1515, :1602-1608"),
    ("bound off", {"floor_bound_skip": False}, ":1200-1210, :1453-1458"),
    ("fold_vc off", {"fold_vc": False},
     ":1235-1248, :1283-1295, :1474-1482, :1507-1511, :1609-1622"),
    ("sqrt_free_bound off", {"sqrt_free_bound": False},
     ":1259-1266, :1419-1435"),
    ("static_rb off", {"static_rb": False}, ":1254-1258, :1365-1369"))
OPTION_ROUNDS = 20
# the megacloth (:func:`megacloth_scene`, scripts/bench_megacloth.py): its
# rows and the synthetic solver's r and K (the script's defaults); the rest
# window (the script times 120,000 steps) and the near-floor window (the
# lowest vertex MEGA_GAP above the floor under MEGA_GRAVITY x gravity);
# make_batched_run's batch and window (sims drifting at MEGA_DRIFT units/s
# along z, sim b at (1 - SPREAD b) of it); the depth of the carried and
# step-by-step holds; the rounds of the timings in turns
MEGA_ROWS = 500
MEGA_R = 48
MEGA_K = 6
MEGA_REST = 20000
MEGA_NEAR = 64
MEGA_GAP = 0.05
MEGA_GRAVITY = 4.0
MEGA_BATCH = 8
MEGA_BATCH_STEPS = 2000
MEGA_DRIFT = 0.1
MEGA_DEPTH = 16
MEGA_ROUNDS = 9
# the pipeline phase (:func:`pipeline_phase`), bench.py's flagship path on
# real bases: the full-order recording (frames, iterations), the bases'
# widths (position modes, modes a group, the reduced solver's modes a
# group), the ring-down's excitation (a share of the recording's tail
# velocity) and warm-up steps, the chunk of the window's comparison run,
# the card's recording against the CPU's (a
# share of the scene's extent); POD_GAMMA bounds the rounding of two
# float64 Gram products of one snapshot matrix, as a share of the largest
# eigenvalue (16 float64 units: the JAX package's and the port's Gram
# matrices of the bench scene's snapshots part by at most 0.12 of one,
# tools/pipeline_parity.py), PICK_RTOL the tie of two rows' residual
# energies in a DEIM step
FOM_FRAMES = 48
FOM_ITERS = 10
POS_MODES = 64
CONSTR_MODES = 40
REDUCED_MODES = 30
EXCITE = 0.1
PIPE_WARMUP = 50
PIPE_CHUNK = 64
CPU_DEVIATION = 1e-6
# the CPU's recording, held against the card's first frames (the whole 48
# on the CPU took 18.6-20.9 s of the run's limit)
CPU_FRAMES = 12
POD_GAMMA = 16 * 2.0 ** -52
PICK_RTOL = 1e-10
# ---- [7] the reference's per-group workflow (:func:`per_group_phase`) ----
# the recording lengths the example configs read: the cloth's
# max_numFrames (200; 100 frames at increment 2) and, for the bar, its
# examples' 70 frames read at increment 1 (BAR_OVERRIDES; at the configs'
# increment 2 the bar demo records 140, 29.9 s of the run's limit), one
# frame longer than read (the p-snapshots stop a frame short)
GROUP_FRAMES = 200
BAR_FRAMES = 71
# the steps of each reduced solve: phase [6]'s reduced-vs-FOM statistic
GROUP_STEPS = 48
# entries of the example configs replaced (none: the configs' own frames
# and component counts), and those of the bar's examples
GROUP_OVERRIDES = {}
BAR_OVERRIDES = {"frame_increment": 1}
CLOTH_EXAMPLE = "configs/examples/cloth_automated_{}_{}Subspace.json"
CLOTH_KINDS = {"tris_strain": "triStrain", "edge_spring": "edgeSpring",
               "verts_bending": "vertBending"}
BAR_EXAMPLE = ("configs/examples/bar_automated_{}_"
               "tetDeformationGradientSubspace.json")
# the bar's position basis: the POD of its recorded displacements from the
# rest shape (the reference's position configs subtract the first frame),
# so that it is zero at the pinned vertices, whose 1e10 masses would
# otherwise enter U^T A U; at 16 modes, where its per-dimension POD nears
# the Gram method's rounding floor (the bar sags 0.3 units in 140 frames).
# On the CPU's recording: cond(Ar) 6.9e8 at 16 modes, 2.2e11 at 32, 8.9e15
# at 64 (there the rounding-set modes make the solve diverge); a POD of the
# positions themselves at 32 modes leaves float32 1 % of |u| off float64
BAR_POS_MODES = 16
# the reduction type each selection is served under: row DEIM as the demo
# config asks, the block selections under the block types
SERVED_AS = {"deim": "deim_pod_vectorized",
             "geom": "geom_pca_blocks_withSt",
             "deim_block_form": "deim_pca_blocks"}
# the batched runners on phase [7]'s solves that are not fully reduced:
# the sims, the steps of make_batched_run on each solve and each sim's
# distance from its solo run on the card, in the extent.  The batched
# solve sums in other orders than the solo one (a right-hand side per sim
# in one cholesky_solve, batched products), and the reduced step map
# amplifies rounding (:func:`card_and_cpu`): on an H100 the demo's dense
# solve parted by 3.6e-11 of the extent in 4 steps, so it is held over one
FULL_BATCH = 8
FULL_BATCH_STEPS = {"dense": 1, "mixed": 4}
SOLO_DEVIATION = 1e-12
# ---- [8] self-collision (:func:`self_collision_phase`) -----------------
# the cloth of scripts/bench_selfcollision.py at SC_ROWS=160 (25,600
# vertices, 50,562 triangles: 1.29e9 vertex-triangle pairs, five slabs of
# collisions_device.MAX_PAIRS), r = 32 synthetic bases, the window cap of
# that script, and the ring-down window served on tier 1 (at least
# 20,000 steps; two windows at the cap)
SC_ROWS = 160
SC_R = 32
SC_CAP = 32768
SC_WINDOW = 40000
SC_MIN_DIST = 0.001
# the fold of scene (b): the upper half 0.5 min_dist above the lower,
# every vertex moved in the plane by a normal draw of this size (ties of
# the centroid distances broken well above their float32 rounding at
# coordinates ~160: ~3e-3 in a squared distance)
SC_GAP = 0.5 * SC_MIN_DIST
SC_JITTER = 0.05
# the proximity path's window (the solver's self_collision_contact_window)
SC_FOLD_STEPS = 64
# steps of kernel 5 against its plain version, and of the short window
# that self_collision_resident=False serves against the tier: from the rest
# shape with the free vertices kicked at SC_KICK units/s along z (at rest
# the reduced step moves the cloth by less than a float32 rounding of its
# coordinates), held within SC_OFF_REL of the window's own largest
# displacement (a path that left the state frozen parts by 1)
SC_DEPTH = 16
SC_SHORT = 64
SC_KICK = 1.0
SC_OFF_REL = 1e-2
# calls timed of the probe, the lower bound and the pass (~10-100 ms each)
SC_REPS = 5
# float32 on the card against float64 from the same positions, where the
# candidate sets agree: the clear state's clearances and corrections within
# this many float32 roundings of the extent (F32_EPS x max |P|; a distance
# comes from a closest point computed at coordinates of the extent's size,
# a handful of roundings; measured 9.8e-6 absolute, 0.5 roundings, on the
# 160x160 cloth on an H100).  On the fold, where the pass pushes, its
# corrections within SC_FOLD_REL of the largest float64 correction of the
# run: a distance's few roundings at the fold's gap are a few per cent of
# a push (min_dist - d) there, while a pass at half stiffness parts by
# 0.5 and one that tests the nearest candidate alone drops whole pushes;
# both planted faults are read beside the sound pass in every run and
# must exceed the limit.  The solve of each fold step (kernel 1 in float32
# against the plain version in float64) within SC_STEP_TOL of the extent
# (measured 2.3e-8 there)
SC_ROUND = 8
SC_FOLD_REL = 0.1
SC_STEP_TOL = 1e-6
# the full-order solver's fold: the 6x12 cloth of
# tests/test_self_collision.py at 0.004 units a cell
SC_FOM = (6, 12)
# phase [9], differentiable rollouts on phase [6]'s bases: the rollout of
# the holds (the --bench fit's horizon and iterations); positional pins
# added to the bench scene for the targets' gradient; the card against the
# CPU, both float64, relative to the largest entry, within DIFF_ROUNDINGS
# float64 roundings of the largest condition number of Ar (the two LU
# factorizations part by ~cond * eps: 1.2e-6 on the targets' gradient at
# cond 1.0e9 on an NVIDIA H100 80GB HBM3); central differences at three eps (the JAX test's
# 1e-4 and below) against its limit, each entry's gap relative to the
# largest entry, held at the closest of the three: the strain clamps make
# the loss piecewise smooth, and an interval that crosses a clamp boundary
# parts by 1e-2 to 1 (on the card's bench bases: 1.9e-2 at 1e-4, 5.9e-2 at
# 3e-5, 2.5e-3 at 1e-5; on the CPU's, 0.70 at 1e-3, 7e-4 at 1e-4),
# while a wrong gradient parts at every eps; repetitions of the rollout's
# timing
DIFF_HORIZON = 12
DIFF_ITERS = 6
DIFF_PINS = 2
DIFF_ROUNDINGS = 64
DIFF_FD_EPS = (1e-4, 3e-5, 1e-5)
DIFF_FD_TOL = 5e-3
DIFF_REPS = 5
# Adam steps of the two fits (None: the script's defaults, 250 and 150)
DIFF_FIT_STEPS = None
# ---- [10] position bases (:func:`position_phase`) ----------------------
# the reference's position config (its frames, increment, alignment,
# weighting, standardization, orthogonalization, support radii, 100
# components, SPLOCS iterations, lambda and rho); entries of the
# BasesConfig replaced (none: the config's own); the bench scene recorded
# for POSB_FRAMES frames at phase [6]'s settings (its first FOM_FRAMES
# frames are phase [6]'s recording); the first POSB_SERVE post-processed
# global components served as the position basis at phase [6]'s
# configuration and storage (POSB_MATMUL); the holds of the greedy picks
# and sigma0 cover the steps whose residual entering them exceeds
# POSB_CUT of the first (standardization zeroes frame 0, so the last
# steps' residual is rounding); the card's and the CPU's extractions may
# part only where rounding sets a step's choice: a pick by a tie of
# POSB_TIE in the residual's largest row energy, or (local support) the
# cone side of wk where one side's largest entry is within POSB_NOISE of
# max|wk| (on an NVIDIA H100 80GB HBM3 the bench cloth's local PCA parted
# so at step 39 of 100: the positive side 1.9e-19 of max|wk|, the CPU's
# run taking it); the
# card against the CPU's float64 run on the same arrays: sigma0 and the
# residual after each step POSB_SIGMA relative, reconstructions and
# aligned frames POSB_EXTENT of the extent, SPLOCS energies POSB_ENERGY
# relative
POSB_CONFIG = "configs/examples/bunny_gFall_posSubspace.json"
POSB_OVERRIDES = {}
POSB_FRAMES = 200
POSB_SERVE = 48
POSB_MATMUL = "bfloat16"
POSB_CUT = 1e-8
POSB_TIE = 1e-12
POSB_NOISE = 1e-10
POSB_SIGMA = 1e-10
POSB_EXTENT = 1e-9
POSB_ENERGY = 1e-9
# ---- [11] scenarios, command lines and analysis (:func:`scenarios_phase`)
# the reference's event demo at its own size (the demo config's 20x20
# cloth, its 240 frames, the sides fixed and released at frames 20, 60
# and 140), SCEN_SYSTEM replacing entries of its cloth and SCEN_FRAMES
# (None: all) cutting its frames; at each event the card's state through
# the event and SCEN_HOLD_STEPS frames on the CPU within CPU_DEVIATION
# (the float64 solves) or, for the fully reduced replay in float32, within
# ACC_RATIO times the CPU's float32 run's distance from its float64 run
# (:func:`as_accurate`); the example configs' entries replaced (none); the
# fully reduced replay's position basis, r = SCEN_POS_MODES modes of the
# recording; the accuracy
# CSV read back against the in-memory trajectories within CSV_RTOL
# relative (the .off writer writes each float's shortest repr, which
# reads back exact)
SCEN_NAME = "cloth_automated_bend_spring_strain"
SCEN_CONFIG = CLOTH_DEMO
SCEN_EVENTS = (20, 60, 140)
SCEN_SYSTEM = {}
SCEN_FRAMES = None
SCEN_HOLD_STEPS = 3
SCEN_OVERRIDES = {}
SCEN_POS_MODES = 30
CSV_RTOL = 1e-12
# phase [11]'s hand-off to phase [12]'s sweep, under the shared directory
SCEN_MANIFEST = "scenarios.json"
# phase [12], the sharded paths, the battery and the sweep, the native
# reader: ranks on the one card (time-sharing it, over
# gloo: NCCL refuses two ranks on one card), each a process; the limit on
# the ranks and on each collective; the sharded POD's matrix; the element-
# sharded FOM step's iterations (the recorder's); the battery and the
# sweep's limit (each a subprocess)
MC_RANKS = 2
MC_TIMEOUT = 600.0
MC_POD = (120_001, 16)
MC_FOM_ITERS = FOM_ITERS
MC_SUB_TIMEOUT = 600
# element-sharded FOM step against Solver.step, of the extent (float64, the
# same CG tolerance); the sweep's modes against phase [11]'s where not bit
# for bit (a worker's BLAS on its own threads)
MC_FOM_TOL = 1e-9
SWEEP_TOL = 1e-9
# the batched kernels phase [12]'s sharded serving counts, and the run
# whose readings each takes in the kernels line
MC_KERNELS = {"resident_affine_contact_batched": "resident",
              "affine_chunked_batched": "chunked",
              "resident_multistep_batched": "chunked_mixed"}
BATTERY = ("contact", "tets", "bend", "batched", "batched_poke", "damped",
           "chunked", "chunked_only", "batched_chunked")


def log(*a):
    print(*a, flush=True)


def require(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


def bench_scene(DeformableModel, cloth_model):
    """The bench scene without the reference mesh (bench.py:73-109): the
    120x120 procedural cloth, normalized, hung 20 units up, masses 10, the
    top cap above the 0.80 quantile pinned, tris_strain (0.95-1.05) and
    edge_spring at wi = 1e4, floor on."""
    V, F = cloth_model(120, 120)
    V = V / 120.0
    V[:, 2] += 0.05 * V[:, 0]
    V = V - V.mean(axis=0)
    V = V / np.abs(V).max()
    V[:, 1] += 20.0
    model = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                            floor_collision=True, init_height_shift=0.0)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.add_edge_spring_constraint(wi=1e4)
    top = np.where(model.positions[:, 1]
                   > np.quantile(model.positions[:, 1], 0.80))[0]
    for vi in top:
        model.fix(vi)
    return model


def rescale(V):
    """Into the unit box around the origin, as the reference's scenarios
    normalize a mesh (animsnapbases_tpu/demos/scenarios.py ``rescale``)."""
    V = V - V.min(axis=0)
    scale = (V.max(axis=0) - V.min(axis=0)).max()
    return V / scale - 0.5 if scale > 0 else V


def bar_scene(args, kinds):
    """The reference's bar (``bar_model`` at the demo's 40 x 5 x 5, 1,000
    vertices, 3,120 tets, 1,312 surface triangles), normalized into the
    unit box and lifted 1 unit as the demo lifts it, and BAR_LIFT more (with
    random bases its free vertices fall almost freely, 5.3 units in the
    main path's 65 steps, which tier 1 must certify), masses from the
    demo, both side surfaces pinned (the demo's setup frames, before its
    releases at frames 40 and 80), floor on; ``kinds`` maps each group to
    add to its weight: tets_deformation_gradient, tets_strain (the demo's
    sigma range) or verts_bending (on the surface triangles, flips
    prevented)."""
    from animsnapbases_tpu_torch.geometry.procedural import bar_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    V, T, F, _ = bar_model(*BAR_SIZE)
    model = DeformableModel(rescale(V), F, elements=T,
                            masses=np.full(len(V), args.mass_per_particle),
                            floor_collision=True,
                            init_height_shift=1.0 + BAR_LIFT)
    model.fix_surface_side_vertices(side="left")
    model.fix_surface_side_vertices(side="right")
    for name, wi in kinds.items():
        if name == "tets_deformation_gradient":
            model.add_tet_constrain_deformation_gradient(wi)
        elif name == "tets_strain":
            model.add_tet_constrain_strain(args.sigma_min, args.sigma_max, wi)
        else:
            model.add_vertex_bending_constraint(wi)
    return model


def bending_cloth(args):
    """The bench cloth (:func:`bench_scene`) with the bending group of the
    reference's bend-spring-strain cloth demo beside its tris_strain and
    edge_spring (flips prevented).  Flat at rest: its rest curvature is 0,
    so every bending row projects to 0."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    model = bench_scene(DeformableModel, cloth_model)
    model.add_vertex_bending_constraint(args.vert_bending_constraint_wi)
    return model


def tet_bending_scenes():
    """The scenes of the tet, bending and block-form kinds: (label, sim
    args, model builder, {group: components}, block form, damping).  The
    weights, sigma range, masses, dt and component counts are the
    reference's JSON files' own: the bar demo
    (``bar_automated_deformationgradient.json``: tets_deformation_gradient
    at wi = 1e8, 70 components; its strain_limit wi = 1e6 and sigma
    0.99-1.01 for tets_strain), the bar's geom example (block form, p = 3
    rows per selected tet) and the bend-spring-strain cloth demo
    (verts_bending at wi = 0.1, 25 components).  Cuts: random bases from
    fixed seeds (r = 64, zero at the pinned vertices), every group
    oversampled OVERSAMPLE x (square DEIM on tets is chaotic at such
    settings; the JAX package's own tet tests oversample), the bench's
    tris_strain and edge_spring at BENCH_MODES modes beside the bending."""
    from animsnapbases_tpu_torch.config.sim_config import SimConfig

    root = os.path.dirname(os.path.abspath(__file__))
    bar = SimConfig(os.path.join(root, BAR_DEMO)).build_args("Bar")
    cloth = SimConfig(os.path.join(root, CLOTH_DEMO)).build_args("Cloth")
    defgrad = {"tets_deformation_gradient":
               bar.deformation_gradient_constraint_wi}
    holding = {"tets_strain": bar.strain_limit_constraint_wi,
               "verts_bending": bar.vert_bending_constraint_wi}
    tet_modes = bar.tet_deformation_num_components
    bend_modes = cloth.vert_bending_num_components
    cloth_modes = {"tris_strain": BENCH_MODES, "edge_spring": BENCH_MODES,
                   "verts_bending": bend_modes}
    return [
        ("bar, row form", bar, lambda: bar_scene(bar, defgrad),
         {"tets_deformation_gradient": tet_modes}, False, bar.damping),
        ("bar, block form", bar, lambda: bar_scene(bar, defgrad),
         {"tets_deformation_gradient": tet_modes}, True, bar.damping),
        ("bar, strain and bending", bar, lambda: bar_scene(bar, holding),
         {"tets_strain": tet_modes, "verts_bending": bend_modes}, False,
         bar.damping),
        ("bending cloth", cloth, lambda: bending_cloth(cloth), cloth_modes,
         False, BENCH_DAMPING),
        ("bending cloth, block form", cloth, lambda: bending_cloth(cloth),
         cloth_modes, True, BENCH_DAMPING),
    ]


def megacloth_scene(rows):
    """The cloth of scripts/bench_megacloth.py (:60-70): ``cloth_model(rows,
    rows)`` with z += 0.1 x, masses 10, floor on, hung 10 up, tris_strain
    (0.95-1.05) and edge_spring at wi = 1e4, its left side pinned.  At 500
    rows: 250,000 vertices."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    V, F = cloth_model(rows, rows)
    V = V.copy()
    V[:, 2] += 0.1 * V[:, 0]
    model = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                            floor_collision=True, init_height_shift=10.0)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.add_edge_spring_constraint(wi=1e4)
    model.compute_cloth_corner_indices()
    model.fix_surface_side_vertices("left")
    return model


def megacloth_solver(torch, dev):
    """(model, solver) of the megacloth (:func:`megacloth_scene` at
    MEGA_ROWS rows) with scripts/bench_megacloth.py's synthetic bases (r =
    MEGA_R, K = MEGA_K, the position basis as drawn), damping
    BENCH_DAMPING, float32 state, bfloat16 matrices."""
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    model = megacloth_scene(MEGA_ROWS)
    return model, synthetic_reduced_solver(
        model, K=MEGA_K, r=MEGA_R, extra_args={"damping": BENCH_DAMPING},
        device=dev, dtype=torch.float32, matmul_dtype=torch.bfloat16)


def small_scene(DeformableModel, cloth_model):
    V, F = cloth_model(10, 10)
    V = V.copy()
    V[:, 2] += 0.15 * V[:, 0]
    model = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                            floor_collision=True, init_height_shift=0.0)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.add_edge_spring_constraint(wi=1e4)
    for vi in np.where(model.positions[:, 0] < 0.5)[0]:
        model.fix(vi)
    return model


def free_position_basis(model, r, path, seed=1):
    """A random per-dim orthonormal position basis (r modes) that is zero at
    the pinned vertices, written as ``components`` (r, N, 3).  A recorded
    POD basis is ~0 there; a basis that moves pinned vertices puts their
    1e10 masses into U^T A U, and the reduced solve then does next to
    nothing (|u| ~ 1e-8 at the bench scene), which would leave the
    iteration loop unexercised."""
    rng = np.random.default_rng(seed)
    comps = np.empty((r, model.n_verts, 3))
    for d in range(3):
        X = rng.normal(size=(model.n_verts, r))
        X[model.fixed_flags] = 0.0
        Q, _ = np.linalg.qr(X)
        comps[:, :, d] = Q.T
    np.savez(path, components=comps)
    return path


def scene_solver(synthetic_reduced_solver, model, K, r, damping, **kw):
    """The synthetic constraint bases of ``utils/synthetic.py`` with the
    position basis of :func:`free_position_basis`."""
    with tempfile.TemporaryDirectory() as tmp:
        pos = free_position_basis(model, r, os.path.join(tmp, "free.npz"))
        return synthetic_reduced_solver(
            model, K=K, r=r, work_dir=tmp,
            extra_args={"damping": damping, "position_basis_file": pos}, **kw)


def bench_solver(torch, dev):
    """(model, solver) of the bench scene at the bench's widths: r = 64,
    40 DEIM rows per group, float32 state, bfloat16 matrices."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    model = bench_scene(DeformableModel, cloth_model)
    return model, scene_solver(synthetic_reduced_solver, model, K=40, r=64,
                               damping=2e-3, device=dev, dtype=torch.float32,
                               matmul_dtype=torch.bfloat16)


def gravity(model):
    f = np.zeros_like(model.positions)
    f[:, 1] = -9.81 * 10.0
    return f


def cuda_ms(torch, fn, reps=REPS, warmup=3):
    """Median milliseconds of ``fn`` over ``reps`` calls, each between two
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, reps=REPS, warmup_s=DEVICE_WARMUP_S, rounds=3):
    """Device milliseconds per call of ``fn`` (a function that launches
    and does not wait for the card): ``reps`` calls enqueued behind a spin
    kernel that keeps the card busy while the host enqueues them, so that
    they run back to back between two CUDA events; the median of
    ``rounds`` such runs after ``warmup_s`` seconds of calls (the card at
    its working clock).  A run whose enqueue outlasted the spin (the calls
    did not run back to back) is made again with a spin twice as long.
    The kernel's own time, where a call between two events (``cuda_ms``)
    holds the wrapper's host time when that is the longer."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warmup_s:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    times, spin = [], int(5e5 * reps)   # ~0.25 ms a call at ~2 GHz
    while len(times) < rounds:
        s0 = torch.cuda.Event(enable_timing=True)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        s0.record()
        torch.cuda._sleep(spin)
        a.record()
        t_host = time.perf_counter()
        for _ in range(reps):
            fn()
        t_host = time.perf_counter() - t_host
        b.record()
        b.synchronize()
        if 1e3 * t_host < s0.elapsed_time(a):
            times.append(a.elapsed_time(b) / reps)
        elif spin < 2 ** 40:
            spin *= 2
        else:
            raise RuntimeError("the host enqueue outlasted every spin")
    return statistics.median(times)


def k1_cost(fo, n_sel, iters, nb=1):
    """(bytes, {dtype: ops}) of one kernel-1 call for ``nb`` sims: every
    input read once, the output written once; the loop's operands (the
    element table and the sparse gather columns among them) are shared by
    the sims, the gathered state, rb_const and u are each sim's.  The
    float64 ops are the star gather Vc = snT_sel G_allT (a multiply-add per
    entry and dim)."""
    it = fo.C_allT.element_size()
    r, g, m = fo.r, fo.g_total, fo.m_total
    nbytes = (it * (nb * (3 * n_sel + 3 * r + 3 * r) + fo.C_allT.numel()
                    + fo.inv3.numel() + fo.WT_all.numel()
                    + fo.elem_f.numel())
              + 4 * (fo.gptr.numel() + fo.gcol.numel()
                     + fo.elem_kind.numel() + fo.elem_g.numel())
              + 8 * fo.gw.numel())
    elem = sum(m_ * KIND_FLOPS[k] for k, _, m_, _, _ in fo.segments)
    ops = iters * (2 * 3 * r * g + 2 * 3 * m * r + elem) + 2 * 3 * r * r
    return nbytes, {"float32": nb * ops,
                    "float64": nb * 2 * 3 * fo.gw.numel()}


def k2_cost(ro, steps, iters, nb=1):
    """(bytes, {dtype: ops}) of one kernel-2 call of ``steps`` steps for
    ``nb`` sims.  Each step reads the two (3, r, N) matrices once for all
    sims, each sim's state P, V and force term, writes P and V, and reads
    the loop's operands; the projection U^T A_c sn accumulates in float64
    and the lift in float32 (csrc/resident.cu).  A contact step of kernel 3
    costs what one sim's step costs."""
    fo = ro.fused
    n, r = ro.n, fo.r
    it = fo.C_allT.element_size()
    k1_bytes, k1_ops = k1_cost(fo, 0, iters, nb)
    step_bytes = (ro.U_liftT.element_size() * (ro.U_liftT.numel()
                                               + ro.ut_acT.numel())
                  + nb * it * 3 * n * 5 + k1_bytes)
    ops = {"float64": steps * (nb * 2 * 3 * r * n + k1_ops["float64"]),
           "float32": steps * (nb * (2 * 3 * r * n + 3 * n * 8)
                               + k1_ops["float32"])}
    return steps * step_bytes, ops




def small_cost(ao, iters, cols, nb=1):
    """(bytes per call, float32 ops per sim-step) of the contact-free affine
    steps' small operands for ``nb`` sims.  Bytes, once per call (they stay
    on the chip between steps): the loop's operands, M_utac, the map to the
    gathered values (``cols`` wide: UG_allT over g_total for kernel 5,
    U_selT over n_sel for kernels 3 and 4), shared by the sims; each sim's
    force-term projection and gathered columns.  Operations, each step of
    each sim: the loop with its solve, rb_lin and the gathered values."""
    fo = ao.fused
    r = fo.r
    loop_bytes, loop_ops = k1_cost(fo, 0, iters, nb)
    nbytes = (loop_bytes + 4 * (3 * r * r + 3 * r * cols)
              + nb * 4 * (3 * r + 3 * cols))
    ops = (loop_ops["float32"] / nb + 2 * 3 * r * r + 2 * 3 * r * cols
           + 6 * 3 * cols)
    return nbytes, ops


def big_pass(ao, nb=1):
    """(bytes, ops) of one pass over a (3, r, N) matrix, read once, with
    the (3, N) states of ``nb`` sims read or written beside it: a
    projection or a lift."""
    ro = ao.res
    return (ro.U_liftT.element_size() * ro.U_liftT.numel()
            + nb * 4 * 3 * ro.n, nb * 2 * 3 * ao.fused.r * ro.n)


def k5_cost(ao, steps, iters, every, nb=1, options=None, exact_steps=0):
    """(bytes, {dtype: ops}) of one kernel-5 call of ``steps`` contact-free
    steps for ``nb`` sims whose floor bound never trips (the exact check
    then reads nothing): per call the small operands (:func:`small_cost`),
    the force terms, their projection and their y-row extremes; per step
    the small operands' operations; per chunk the outer loop's two
    projections (float64) and two lifts of the anchors, the combinations
    reading P, V, fa, the y-row minima and maxima, and the anchors' (3, r)
    projections and (3, g) columns.  ``options`` (ops/affine_chunked.py
    ChunkOptions; None: the default build): the exact-free build costs the
    same (its outer loop takes the minima and maxima; neither reads the y
    slice while the bound clears); without the bound every step reads the
    (r, N) y slice of the lift and each sim's y rows of P, V and fa (the
    exact check: 2 r N operations), and no minima are taken; without
    ``fold_vc`` the map to the gathered values is U_selT over the n_sel
    selected columns, each sim's prefixes of P, V and fa (3 x 3 n_sel) are
    read once per call, no gathered columns are formed, and every step
    sums the star gather in float64.  ``exact_steps``: the steps of the
    call on which the bound trips, each reading what the exact check
    reads."""
    ro, fo = ao.res, ao.fused
    n, r, g = ro.n, fo.r, fo.g_total
    bound = options is None or options.floor_bound_skip
    fold = options is None or options.fold_vc
    chunks = -(-steps // every)
    sb, so = small_cost(ao, iters, g if fold else ro.n_sel, nb)
    pb, po = big_pass(ao, nb)
    per_chunk = 9 * n + (2 * n if bound else 0) + 2 * 3 * r + (
        2 * 3 * g if fold else 0)
    nbytes = (sb + chunks * (4 * pb + nb * 4 * per_chunk)
              + nb * 4 * (3 * n * 2 + (n if bound else 0)) + pb)
    ops = {"float32": nb * steps * so + chunks * (2 * po + nb * 6 * 3 * n),
           "float64": (2 * chunks + 1) * po}
    checks = exact_steps if bound else steps
    if checks:
        nbytes += checks * (ro.U_liftT.element_size() * r * n
                            + nb * 4 * 3 * n)
        ops["float32"] += checks * nb * 2 * r * n
    if not fold:
        nbytes += nb * 4 * 9 * ro.n_sel
        ops["float64"] += steps * nb * 2 * 3 * fo.gw.numel()
    return nbytes, ops


def k3_cost(ao, steps, iters, every, contact, nb=1):
    """(bytes, {dtype: ops}) of one kernel-3 (or, with ``contact = 0``,
    kernel-4) call of ``steps`` steps for ``nb`` sims, ``contact`` of
    whose sim-steps clamp: per call, when a step is free, the small
    operands (:func:`small_cost`) and the floor test's (r, N) y slice of
    the lift and each sim's y rows of b0, b1, fa, and per free sim-step
    their operations; per contact sim-step what a step of kernel 2 costs;
    per rebase a materialization of P and V and the refresh of their
    projections (float64); per call the force terms, their projection and
    the output's materialization."""
    ro = ao.res
    n, r = ro.n, ao.fused.r
    free = nb * steps - contact
    rebases = (steps - 1) // every if steps else 0
    sb, so = small_cost(ao, iters, ro.n_sel, nb)
    yb = ro.U_liftT.element_size() * r * n + nb * 4 * 3 * n
    cb, co = k2_cost(ro, contact, iters)
    pb, po = big_pass(ao, nb)
    mat_bytes = pb + nb * 4 * 15 * n   # read b0, b1, fa; write b0, b1
    nbytes = ((sb + yb if free else 0) + cb
              + rebases * (mat_bytes + pb + nb * 4 * 3 * n)
              + nb * 4 * 3 * n * 2 + pb + mat_bytes)
    ops = {"float32": free * (so + 2 * r * n) + co["float32"]
           + (rebases + 1) * 2 * po,
           "float64": co["float64"] + (rebases + 1) * (po + 2 * po)}
    return nbytes, ops


def k3m_cost(ao, steps, iters, every, contact, any_contact, entries, nb=1):
    """(bytes, {dtype: ops}) of one call of kernel 3's contact-mode build of
    ``steps`` steps for ``nb`` sims, ``contact`` of whose sim-steps run in
    contact mode, on ``any_contact`` steps at least one sim's, with
    ``entries`` entries.  As :func:`k3_cost` for the free sim-steps, the
    small operands (every step runs the loop), the rebases and the call;
    per step in contact mode the (r, N) y slices of U^T A_c and of the lift
    read once for the sims in it; per contact sim-step its y state (Py,
    Vy, fa_y read; Py, Vy written), the loop's operations, the float64
    projection of the clamp's correction and the float32 lift of u_y; per
    entry the y rows of b0, b1 and fa read and two lifts of the y row."""
    ro = ao.res
    n, r = ro.n, ao.fused.r
    item = ro.U_liftT.element_size()
    free = nb * steps - contact
    rebases = (steps - 1) // every if steps else 0
    sb, so = small_cost(ao, iters, ro.n_sel, nb)
    yb = item * r * n + nb * 4 * 3 * n
    pb, po = big_pass(ao, nb)
    mat_bytes = pb + nb * 4 * 15 * n
    nbytes = (sb + (yb if free else 0) + any_contact * 2 * item * r * n
              + contact * 4 * 5 * n + entries * 4 * 3 * n
              + rebases * (mat_bytes + pb + nb * 4 * 3 * n)
              + nb * 4 * 3 * n * 2 + pb + mat_bytes)
    ops = {"float32": (nb * steps * so + free * 2 * r * n
                       + contact * (2 * r * n + 10 * n)
                       + entries * 2 * 2 * r * n + (rebases + 1) * 2 * po),
           "float64": contact * 2 * r * n + (rebases + 1) * (po + 2 * po)}
    return nbytes, ops


def loop_floor_ms(f32_ops):
    """Milliseconds of ``f32_ops`` float32 operations (a multiply-add
    counts 2) on the FP32 lanes of the cluster's SMs, one multiply-add a
    lane a cycle; the loop's exchanges (one an iteration) come on top."""
    return 1e3 * f32_ops / (CLUSTER_SMS * SM_F32_LANES * 2 * SM_CLOCK_HZ)


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(v / PEAK_OPS[k] for k, v in ops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def carried_steps(torch, *args, **kw):
    """``holds.carried_steps`` at this script's ITERATIONS."""
    return holds.carried_steps(torch, *args, iterations=ITERATIONS, **kw)


def same_as_steps(torch, label, call, P, V, Pi, Vi, steps):
    """One ``steps``-step call (``call``) must equal the ``steps`` one-step
    calls that led from (P, V) to (Pi, Vi) bit for bit."""
    P_all, V_all = call(P, V)[:2]
    torch.cuda.synchronize()
    same = bool(torch.equal(P_all, Pi) and torch.equal(V_all, Vi))
    log(f"[3] {label}: one {steps}-step call == {steps} one-step calls: "
        f"{same}")
    require(same, f"{label}: the step loop differs from repeated single "
            "steps")
    return P_all, V_all


def contact_state(model):
    """The contact scene: the bench cloth moved down so that its lowest
    vertex sits CONTACT_GAP above the floor, falling at CONTACT_SPEED."""
    P = model.init_positions.copy()
    P[:, 1] += model.floor_height + CONTACT_GAP - P[:, 1].min()
    V = np.zeros_like(P)
    V[:, 1] = -CONTACT_SPEED
    return P, V


def spy_tier1(solver):
    """Record the steps done of every tier-1 call of ``solver``."""
    calls = []
    real = solver._resident_fast

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[2])
        return out

    solver._resident_fast = spy
    return calls


def counted_path(torch, counted, label, own, run):
    """Drive one path (``run``) with every launch counter set to 0 just
    before it and read just after: each kernel named in ``own`` must have
    launched, every other kernel not at all.  Returns the path's counts."""
    for fn in counted:
        fn.launches = 0
    run()
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in counted}
    log(f"[2] launches on {label}: "
        f"{ {k: v for k, v in counts.items() if v} } (every other of the "
        f"{len(counts)} counters 0)")
    for name, count in counts.items():
        if name in own:
            require(count > 0, f"{name} was never launched on {label}")
        else:
            require(count == 0, f"{name} was launched {count} times on "
                    f"{label}, which is not its path")
    return counts


def tiered_runs(torch, counted, solver, model, f, rest, label, tier1,
                contact, recursions=False):
    """The bench scene's rest state (``rest``) through run_steps(64): tier 1
    (the kernel named ``tier1``) must serve and certify the whole window;
    then the contact scene: tier 1 must exit at 0 < k < 64 and the contact
    tier (``contact``) finish the window.  With ``recursions`` (kernel 5's
    exact-free build) tier 1 may be entered again after its exit, as
    run_steps' recursion rebases and re-enters; its first call must still
    commit a step.  With ``tier1`` None (contact mode without tier 1) no
    tier 1 may be built, and the contact tier must serve both windows
    alone, uncertified.  Each run is a path of its own for the launch
    counters.  Returns {run: counts}."""
    calls = spy_tier1(solver) if tier1 else None
    require(tier1 or solver._resident_fast is None,
            f"{label}: a tier 1 was built")
    model.positions, model.velocities = (x.copy() for x in rest)
    frame = solver.frame
    counts = {}
    counts["bench window"] = counted_path(
        torch, counted, f"{label}, bench window", {tier1 or contact},
        lambda: solver.run_steps(f, SCENE_STEPS, num_iterations=ITERATIONS))
    require(solver._last_fast_steps == (SCENE_STEPS if tier1 else None)
            and (not tier1 or calls == [SCENE_STEPS]),
            f"{label}: tier 1 did not serve the whole bench window, or a "
            f"window without it was certified (calls {calls}, certificate "
            f"{solver._last_fast_steps})")
    model.positions, model.velocities = contact_state(model)
    counts["contact scene"] = counted_path(
        torch, counted, f"{label}, contact scene", {tier1 or contact, contact},
        lambda: solver.run_steps(f, SCENE_STEPS, num_iterations=ITERATIONS))
    k = (sum(calls[1:]) if recursions and len(calls) > 1 and calls[1] > 0
         else calls[1] if tier1 and len(calls) == 2 else 0)
    require((k > 0 or not tier1) and k < SCENE_STEPS
            and solver._last_fast_steps is None
            and solver.frame == frame + 2 * SCENE_STEPS,
            f"{label}: the contact scene did not go tier 1 -> contact tier "
            f"(tier-1 calls {calls})")
    require(np.isfinite(model.positions).all()
            and model.positions[:, 1].min() > -0.5,
            f"{label}: the contact scene's state is not finite and held at "
            "the floor")
    log(f"[2] {label} ({solver._resident_fast_kind or 'no'} tier 1, "
        f"{solver._resident_kind} contact tier): bench window "
        f"{'certified' if tier1 else 'served by the contact tier'} "
        f"({SCENE_STEPS} steps); contact scene: tier 1 served {k} steps"
        f"{f' in calls {calls[1:]}' if recursions else ''}, "
        f"the contact tier {SCENE_STEPS - k}, end y in "
        f"[{model.positions[:, 1].min():.4f}, "
        f"{model.positions[:, 1].max():.4f}]")
    return counts


def retier(solver, **switches):
    """Set the solver's tier switches and rebuild its tiers alone
    (``_build_tiers``): the prepared operands are kept, which at 250,000
    vertices spares the host a repacking of the (3, r, N) matrices."""
    for k, v in switches.items():
        setattr(solver, k, v)
    solver._build_tiers(solver.model.n_verts)


def build_switches(opts):
    """The solver switches that select kernel 5's build of ``opts`` (keywords
    of ops/affine_chunked.py ChunkOptions), the exact check kept unless
    ``opts`` turns it off."""
    return {"resident_floor_bound_skip": opts.get("floor_bound_skip", True),
            "resident_floor_exact": opts.get("floor_exact", True),
            "resident_chunked_opts": {
                k: v for k, v in opts.items()
                if k not in ("floor_bound_skip", "floor_exact")}}


DEFAULT_SWITCHES = {"resident_floor_bound_skip": True,
                    "resident_floor_exact": None,
                    "resident_chunked_opts": None}


def reprepare(solver, **switches):
    """Set the solver's tier switches and prepare again (the host matrices
    are kept: only the tiers are rebuilt)."""
    for k, v in switches.items():
        setattr(solver, k, v)
    solver.prepare(solver.args)


def ensemble_state(main_state, B):
    """The ring-down ensemble (bench_ensemble.py's design): B copies of the
    main path's end positions, sim b moving at (1 - SPREAD b) x a tenth of
    its end velocity, no external force."""
    P0, V0 = main_state
    pos = np.repeat(P0[None], B, axis=0)
    vel = np.stack([(1.0 - SPREAD * b) * 0.1 * V0 for b in range(B)])
    return pos, vel, np.zeros_like(pos)


def contact_sims():
    """The mixed batch's sims in the contact scene: b % SIM_ROWS >=
    SIM_ROWS / 2 (the others ring down)."""
    return [b for b in range(MIXED) if b % SIM_ROWS >= SIM_ROWS // 2]


def mixed_state(model, main_state, f):
    """The mixed batch: MIXED / 2 sims of the ring-down ensemble, and as
    many in the contact scene under gravity (:func:`contact_sims`), sim j
    of them lifted CONTACT_RISE + CONTACT_STEP j more, so that each reaches
    the floor at its own step."""
    pos, vel, fs = ensemble_state(main_state, MIXED)
    for j, b in enumerate(contact_sims()):
        pos[b], vel[b] = contact_state(model)
        pos[b][:, 1] += CONTACT_RISE + CONTACT_STEP * j
        fs[b] = f
    return pos, vel, fs


def crumple_state(model, f):
    """The crumpling ensemble: CRUMPLE copies of the contact scene under
    gravity (``f``), sim b lifted CRUMPLE_STEP b more."""
    P, V = contact_state(model)
    pos = np.repeat(P[None], CRUMPLE, axis=0)
    pos[:, :, 1] += CRUMPLE_STEP * np.arange(CRUMPLE)[:, None]
    vel = np.repeat(V[None], CRUMPLE, axis=0)
    return pos, vel, np.repeat(f[None], CRUMPLE, axis=0)


def same_per_sim(torch, label, batched, solo, B):
    """Each sim of a batched call (``batched``: a tuple of tensors with a
    leading sim axis) equals the solo call from that sim's inputs
    (``solo(b)``: the same tuple without it) bit for bit."""
    diff = []
    for b in range(B):
        one = solo(b)
        diff.append(max(max_abs(x[b], y) for x, y in zip(batched, one)))
    torch.cuda.synchronize()
    log(f"[3] {label}: each of {B} sims against the solo kernel from its "
        f"state: largest difference {max(diff):.3e} (held bit for bit)")
    require(max(diff) == 0.0, f"{label}: a sim differs from the solo kernel "
            f"(differences {diff})")


def device_breakdown(torch, fn):
    """(seconds of host time, {kernel name: device seconds}) of one call of
    ``fn`` under torch.profiler, the names cut at their template
    arguments."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spent = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            name = ev.key.split("<")[0].replace("void ", "")
            spent[name] = spent.get(name, 0.0) + us * 1e-6
    return wall, spent


def plans_by_sims(name, plan_of, library):
    """{B: the staging plan a launch of B sims runs on (``plan_of(B)``),
    the clusters the card holds at once on it and the waves its B clusters
    take} for B in ENSEMBLE_SIZES, logged."""
    from animsnapbases_tpu_torch.ops.cluster import resident_clusters, waves

    out = {}
    for B in ENSEMBLE_SIZES:
        plan = plan_of(B)
        n = resident_clusters(library, plan)
        out[B] = {"staged": list(plan.staged), "smem_bytes": plan.smem_bytes,
                  "bits": plan.bits, "resident_clusters": n,
                  "waves": waves(B, n) if n > 0 else None}
    log(f"[4] {name}: staging plan by sims: " + "; ".join(
        f"B={B} {v['staged']} {v['smem_bytes']} B a block, "
        f"{v['resident_clusters']} clusters resident, {v['waves']} waves"
        for B, v in out.items()))
    return out


def ensemble(torch, counted, solver, model, f, main_state, paths):
    """The ensemble-serving section: the paths (2), holds (3) and times (4)
    of make_batched_run / make_batched_step and the batched builds of
    kernels 1, 2, 3 (both builds) and 5, then kernel 4's batched build
    (:func:`exit_batched`).  Returns the six batched entries of the kernels
    line."""
    from animsnapbases_tpu_torch.ops.affine import (
        FLAG_SLOTS,
        _launch_affine,
        affine_plan,
        resident_affine,
        resident_affine_batched,
        resident_affine_contact_batched,
        resident_affine_contact_plain,
        resident_affine_plain,
    )
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        _chunk_launch,
        affine_chunked,
        affine_chunked_batched,
        affine_chunked_plain,
        chunk_anchors,
    )
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
        fused_reduced_iterations_batched,
        fused_reduced_iterations_plain,
        gather_vc,
    )
    from animsnapbases_tpu_torch.ops.resident import (
        force_term,
        predict,
        project,
        resident_multistep,
        resident_multistep_batched,
        resident_multistep_plain,
        resident_plan,
    )

    ro, ao = solver._resident, solver._affine
    fo = ro.fused
    default_min = type(solver).CHUNKED_TIER1_MIN_VERTS
    # the solver's default route: the batched contact-mode build of kernel 3
    reprepare(solver, resident_contact_mode=None)

    # ---- 2. the ensemble paths through the entry points ----------------
    run = solver.make_batched_run()
    step = solver.make_batched_step()
    ens = ensemble_state(main_state, ENSEMBLE)
    mixed = mixed_state(model, main_state, f)
    crumple = crumple_state(model, f)
    contact = contact_sims()
    ring = [b for b in range(MIXED) if b not in contact]
    out = {}

    def drive(key, fn):
        def go():
            t0 = time.perf_counter()
            out[key] = fn()
            torch.cuda.synchronize()
            out[key + " s"] = time.perf_counter() - t0
        return go

    def batched_paths(build, own):
        """The ring-down ensemble and the mixed batch through
        make_batched_run on kernel 3's ``build``, each a counted path ->
        (their labels, the ring-down's aggregate steps/s)."""
        label_r = f"make_batched_run, B={ENSEMBLE} ring-down, {build}"
        paths[label_r] = counted_path(
            torch, counted, f"{label_r} ({WINDOW_STEPS} steps)", {own},
            drive(label_r, lambda: run(*ens, WINDOW_STEPS,
                                       num_iterations=ITERATIONS)))
        require(solver._last_batched_path == "batched-resident",
                f"{label_r} took {solver._last_batched_path}")
        p, v = out[label_r]
        require(p.shape == ens[0].shape and np.isfinite(p).all()
                and np.isfinite(v).all(), f"{label_r}: end state not finite")
        require(float(p[..., 1].min()) > model.floor_height,
                f"{label_r}: a sim reached the floor")
        rate = ENSEMBLE * WINDOW_STEPS / out[label_r + " s"]
        log(f"[2] {label_r}: {WINDOW_STEPS} steps in "
            f"{out[label_r + ' s']:.3f} s ({rate:.0f} aggregate steps/s, "
            f"{rate / ENSEMBLE:.0f} per sim, host transfers included); end "
            f"state finite and floor-clear, min y "
            f"{float(p[..., 1].min()):.4f}, first and last sim "
            f"{float(np.abs(p[-1] - p[0]).max()):.3e} apart")
        label_m = f"make_batched_run, mixed batch of {MIXED}, {build}"
        paths[label_m] = counted_path(
            torch, counted, label_m, {own},
            drive(label_m, lambda: run(*mixed, SCENE_STEPS,
                                       num_iterations=ITERATIONS)))
        require(solver._last_batched_path == "batched-resident",
                f"{label_m} took {solver._last_batched_path}")
        p, _ = out[label_m]
        require(np.isfinite(p).all() and float(p[ring, :, 1].min())
                > model.floor_height and float(p[contact, :, 1].min()) > -0.5,
                f"{label_m}: not finite, or a ring-down sim at the floor, or "
                "a contact sim through it")
        log(f"[2] {label_m}: {SCENE_STEPS} steps; ring-down sims {ring} min "
            f"y {float(p[ring, :, 1].min()):.4f}, contact sims {contact} min "
            f"y {float(p[contact, :, 1].min()):.4f}")
        return label_r, label_m, rate

    label_a, label_b, entry_a = batched_paths(
        "default (contact mode)", "resident_affine_contact_batched")
    # the crumpling ensemble, on the default route too
    label_e = f"make_batched_run, crumpling ensemble of {CRUMPLE}, default"
    paths[label_e] = counted_path(
        torch, counted, label_e, {"resident_affine_contact_batched"},
        drive("e", lambda: run(*crumple, SCENE_STEPS,
                               num_iterations=ITERATIONS)))
    p, _ = out["e"]
    require(solver._last_batched_path == "batched-resident"
            and np.isfinite(p).all() and float(p[..., 1].min()) > -0.5,
            f"{label_e}: took {solver._last_batched_path}, or its end state "
            "is not finite and held at the floor")
    log(f"[2] {label_e}: {SCENE_STEPS} steps in {out['e s']:.3f} s (host "
        f"transfers included); end y in [{float(p[..., 1].min()):.4f}, "
        f"{float(p[..., 1].max()):.4f}]")
    reprepare(solver, resident_contact_mode=False)
    label_a_lean, _, entry_a_lean = batched_paths(
        "resident_contact_mode=False (lean)", "resident_affine_batched")
    reprepare(solver, CHUNKED_TIER1_MIN_VERTS=0,
              resident_rebase_every=MIXED_EVERY)
    label_c = (f"make_batched_run, mixed batch of {MIXED}, "
               "CHUNKED_TIER1_MIN_VERTS=0")
    paths[label_c] = counted_path(
        torch, counted, label_c,
        {"affine_chunked_batched", "resident_multistep_batched"},
        drive("c", lambda: run(*mixed, SCENE_STEPS,
                               num_iterations=ITERATIONS)))
    route_c = solver._last_batched_path
    require(route_c.startswith("batched-chunked+perstep[")
            and int(route_c.split("[")[1].rstrip("w]")) >= 2,
            f"{label_c}: took {route_c}, not kernel 5 -> kernel 2 windows "
            "-> kernel 5")
    p, _ = out["c"]
    require(np.isfinite(p).all() and float(p[contact, :, 1].min()) > -0.5,
            f"{label_c}: end state not finite or through the floor")
    d_bc = float(np.abs(out[label_b][0] - p).max())
    log(f"[2] {label_c}: {route_c}; against the default route (not held: "
        f"other kernels in float32) max |dP| {d_bc:.3e}")

    label_d = f"make_batched_step, B={ENSEMBLE}"
    paths[label_d] = counted_path(
        torch, counted, label_d, {"fused_reduced_iterations_batched"},
        drive("d", lambda: step(*ens, num_iterations=ITERATIONS)))
    require(np.isfinite(out["d"][0]).all(), f"{label_d}: not finite")
    log(f"[2] {label_d}: one step in {1e3 * out['d s']:.1f} ms (host "
        "transfers included)")
    launch_path = {"fused_reduced_iterations_batched": label_d,
                   "resident_affine_batched": label_a_lean,
                   "resident_multistep_batched": label_c,
                   "affine_chunked_batched": label_c,
                   "resident_affine_contact_batched": label_a}

    # ---- 3. holds --------------------------------------------------------
    rb = solver._rb_extra()
    P64, V64, F64 = (solver._pack(x) for x in ens)
    Pm, Vm, Fm = (solver._pack(x) for x in mixed)
    fo64 = as_f64(fo)

    # kernel 1 at B = 64 from the ring-down ensemble's predictor
    sn, rbc = predict(ro, P64, V64, force_term(ro, F64), rb)
    snT = sn[..., :ro.n_sel]
    u_k = fused_reduced_iterations_batched(fo, snT, rbc, ITERATIONS)
    same_per_sim(torch, f"batched kernel 1 (B={ENSEMBLE})", (u_k,),
                 lambda b: (fused_reduced_iterations(
                     fo, snT[b], rbc[b].contiguous(), ITERATIONS),),
                 ENSEMBLE)
    u_p = fused_reduced_iterations_plain(fo, snT, rbc, ITERATIONS)
    u_ps = torch.stack([fused_reduced_iterations_plain(
        fo, snT[b], rbc[b], ITERATIONS) for b in range(ENSEMBLE)])
    u_64 = fused_reduced_iterations_plain(fo64, snT.double(), rbc.double(),
                                          ITERATIONS)
    k1_err = max_abs(u_k, u_p)
    ok_k, e_k, e_p = as_accurate(u_k, u_p, u_64)
    ok_p, e_pb, e_ps = as_accurate(u_p, u_ps, u_64)
    log(f"[3] batched kernel 1: vs its plain version max abs {k1_err:.3e}; "
        f"vs float64: kernel {e_k:.3e}, batched plain {e_p:.3e}, solo plain "
        f"{e_ps:.3e} (limit {ACC_RATIO}x)")
    require(ok_k, "batched kernel 1 is less accurate than its plain version")
    require(ok_p, "the batched plain kernel 1 is less accurate than the "
            "solo plain version")

    # kernels 2 and 3: a SCENE_STEPS call on the mixed batch and on the
    # ring-down ensemble, against the solo kernel per sim
    batches = (("mixed batch", Pm, Vm, Fm, MIXED),
               (f"ring-down B={ENSEMBLE}", P64, V64, F64, ENSEMBLE))
    for label, P_, V_, F_, B in batches:
        same_per_sim(
            torch, f"batched kernel 2, {label}, {SCENE_STEPS} steps",
            resident_multistep_batched(ro, P_, V_, F_, rb, SCENE_STEPS,
                                       ITERATIONS),
            lambda b: resident_multistep(ro, P_[b], V_[b], F_[b], rb,
                                         SCENE_STEPS, ITERATIONS), B)
        # kernel 3, lean and in contact mode (with its y state)
        for variant, bit, name in (("lean", 1, "clamped steps"),
                                   ("contact", 2, "contact-mode steps")):
            for every in (REBASE_EVERY, 3):
                def call(P1, V1, F1):
                    out = _launch_affine(ao, P1, V1, F1, rb, SCENE_STEPS,
                                         ITERATIONS, every, variant)
                    return out[:3] + (out[4] or ())
                outs = call(P_, V_, F_)
                same_per_sim(
                    torch, f"batched kernel 3 ({variant}), {label}, "
                    f"{SCENE_STEPS} steps, rebase_every={every}", outs,
                    lambda b: call(P_[b], V_[b], F_[b]), B)
            # the last call's steps per sim (rebase_every=3)
            steps_in = (outs[2][:, FLAG_SLOTS:FLAG_SLOTS + SCENE_STEPS]
                        & bit) > 0
            counts = steps_in.sum(1).tolist()
            log(f"[3]   {label}, kernel 3 ({variant}): {name} per sim "
                f"{counts}")
            if P_ is not Pm:
                continue
            require(max(counts[b] for b in ring) == 0
                    and min(counts[b] for b in contact) > 0,
                    f"the mixed batch's contact sims had no {name}, or its "
                    "ring-down sims had some")
            # steps at which two sims in the contact branch share a block
            # of kernel 3's O(N) contact launches
            shared = sum(int((steps_in[b] & steps_in[b + SIM_ROWS]).sum())
                         for b in contact if b + SIM_ROWS < MIXED)
            log(f"[3]   {label}, kernel 3 ({variant}): {shared} (sim, step) "
                f"pairs with two sims of the contact branch on one block "
                f"(sims b and b + {SIM_ROWS})")
            require(shared > 0, f"no two sims of the mixed batch shared a "
                    f"block of batched kernel 3 ({variant})")
    # one step of each batched kernel against its batched plain version,
    # and of the batched plain version against the solo plain version,
    # per sim (STEP_TOL of the step's size, as the solo holds), on both
    # batches
    err = {}
    for name, kernel, plain in (
            ("kernel 2", lambda *a: resident_multistep_batched(ro, *a),
             lambda *a: resident_multistep_plain(ro, *a)),
            ("kernel 3", lambda *a: resident_affine_batched(ao, *a),
             lambda *a: resident_affine_plain(ao, *a)),
            ("kernel 3 (contact mode)",
             lambda *a: resident_affine_contact_batched(ao, *a),
             lambda *a: resident_affine_contact_plain(ao, *a)),
            ("kernel 5", lambda *a: affine_chunked_batched(ao, *a)[:2],
             lambda *a: affine_chunked_plain(ao, *a)[:2])):
        err[name] = 0.0
        for label, P_, V_, F_, B in batches:
            fam = force_term(ro, F_)
            Pk, Vk = kernel(P_, V_, F_, rb, 1, ITERATIONS)
            Pp, Vp = plain(P_, V_, F_, rb, 1, ITERATIONS)
            for b in range(B):
                Ps, Vs = plain(P_[b], V_[b], F_[b], rb, 1, ITERATIONS)
                shares = step_share(ro, fam[b], rb, P_[b], V_[b], Pk[b],
                                    Vk[b], Pp[b], Vp[b])
                hold_step(f"batched {name}, {label}, sim {b}", shares)
                hold_step(f"batched plain {name}, {label}, sim {b}",
                          step_share(ro, fam[b], rb, P_[b], V_[b], Pp[b],
                                     Vp[b], Ps, Vs))
                err[name] = max(err[name], *(d for d, _ in shares.values()))
        log(f"[3] batched {name}, one step of the mixed batch and of the "
            f"ring-down ensemble: kernel vs batched plain and batched plain "
            f"vs solo plain within {STEP_TOL} of each sim's step size; "
            f"kernel vs plain max abs {err[name]:.3e}")

    # kernel 5: the chunk launch against the solo chunk per sim, the
    # whole-batch k against the sims' solo tier-1 k, each sim committed to
    # exactly k steps
    fa = force_term(ro, Fm)
    bu0, bu1, b0s, b1s = chunk_anchors(ao, Pm, Vm)
    fas, bufa = gather_vc(fo, fa), project(ro, fa)
    ymm = torch.empty(MIXED, 6, device=Pm.device)
    ymm1 = torch.empty(MIXED, 6, device=Pm.device)
    chunk_in = (Pm, Vm, fa, ymm, b0s, b1s, fas, bu0, bu1, bufa)

    def launch(P_, V_, fa_, ymm_, *anchors):
        return _chunk_launch(ao, P_, V_, fa_, ymm_, True, *anchors, rb,
                             SCENE_STEPS, ITERATIONS, ao.floor_level)

    def solo_chunk(b):
        one = [x[b] for x in chunk_in]
        one[3] = ymm1[b]
        return (*launch(*one), ymm1[b])

    coef, kb = launch(*chunk_in)
    same_per_sim(torch, f"batched kernel 5 chunk, mixed batch, "
                 f"{SCENE_STEPS} steps", (coef, kb, ymm), solo_chunk, MIXED)
    ks = [affine_chunked(ao, Pm[b], Vm[b], Fm[b], rb, SCENE_STEPS,
                         ITERATIONS)[2] for b in range(MIXED)]
    Pk, Vk, k = affine_chunked_batched(ao, Pm, Vm, Fm, rb, SCENE_STEPS,
                                       ITERATIONS)
    Pp, Vp, kp = affine_chunked_plain(ao, Pm, Vm, Fm, rb, SCENE_STEPS,
                                      ITERATIONS)
    kps = [affine_chunked_plain(ao, Pm[b], Vm[b], Fm[b], rb, SCENE_STEPS,
                                ITERATIONS)[2] for b in range(MIXED)]
    log(f"[3] batched kernel 5, mixed batch: whole-batch k {k} (plain "
        f"{kp}); the sims' solo tier-1 k {ks} (plain {kps}); chunk k_b "
        f"{kb.tolist()}")
    require(k == min(ks) and 0 < k < max(ks),
            f"batched kernel 5's k {k} is not the least of the solo k {ks}")
    require(kp == min(kps), f"the batched plain kernel 5's k {kp} is not "
            f"the least of the solo plain k {kps}")
    k5_err = 0.0
    for b in range(MIXED):
        Ps, Vs, kk = affine_chunked(ao, Pm[b], Vm[b], Fm[b], rb, k,
                                    ITERATIONS)
        require(kk == k, f"sim {b} does not do {k} solo steps")
        for key, got, want, start in (("P", Pk[b], Ps, Pm[b]),
                                      ("V", Vk[b], Vs, Vm[b])):
            d, size = max_abs(got, want), max_abs(want, start)
            k5_err = max(k5_err, d)
            require(d <= STEP_TOL * size,
                    f"batched kernel 5, sim {b} {key}: {d:.3e} from its "
                    f"solo {k}-step run (change {size:.3e})")
    # (one step against the batched plain version is held above; the
    # k-step calls part as any two float32 orders do: printed, not held)
    log(f"[3] batched kernel 5: every sim committed to exactly {k} steps "
        f"(each within {STEP_TOL} of its change from its solo {k}-step run; "
        f"max abs {k5_err:.3e}); the {k}-step calls against the batched "
        f"plain version (not held) P {max_abs(Pk, Pp):.3e}, V "
        f"{max_abs(Vk, Vp):.3e}")

    # ---- 4. times --------------------------------------------------------
    F0 = torch.zeros_like(P64)
    per_step, bounds = {}, {}
    for B in ENSEMBLE_SIZES:
        Pe, Ve = (solver._pack(x) for x in ensemble_state(main_state, B)[:2])
        Fe = torch.zeros_like(Pe)
        flags = _launch_affine(ao, Pe, Ve, Fe, rb, WINDOW_STEPS, ITERATIONS,
                               REBASE_EVERY, "lean")[2]
        require(int(flags[:, FLAG_SLOTS:].sum()) == 0,
                f"the timed ring-down window of {B} sims is not "
                "contact-free")
        if B == 1:      # one sim serves on the solo kernel
            Pe, Ve, Fe = Pe[0], Ve[0], Fe[0]
            call = resident_affine
        else:
            call = resident_affine_batched
        per_step[B] = 1e3 * cuda_ms(torch, lambda: call(
            ao, Pe, Ve, Fe, rb, WINDOW_STEPS, ITERATIONS), reps=3,
            warmup=0) / WINDOW_STEPS
        bounds[B] = 1e3 * bound_ms(*k3_cost(
            ao, WINDOW_STEPS, ITERATIONS, REBASE_EVERY, 0, nb=B))[0] \
            / WINDOW_STEPS
        log(f"[4] batched kernel 3, B={B}, ring-down over {WINDOW_STEPS} "
            f"steps: {per_step[B]:.2f} us/step, {B / per_step[B] * 1e6:.0f} "
            f"aggregate steps/s, {1e6 / per_step[B]:.0f} per sim; bound "
            f"{bounds[B]:.4f} us/step")
    k3_plans = plans_by_sims("batched kernel 3", lambda B: affine_plan(
        ao, B), "affine")
    k2_plans = plans_by_sims("batched kernel 2", lambda B: resident_plan(
        ro, B), "resident")
    k3_ms = cuda_ms(torch, lambda: resident_affine_batched(
        ao, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS))
    # where a batched step's time goes: device time per kernel of one
    # SCENE_STEPS call, and the share of the call the device is busy
    wall, spent = device_breakdown(torch, lambda: resident_affine_batched(
        ao, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS))
    busy = sum(spent.values())
    log(f"[4] batched kernel 3, B={ENSEMBLE}, one {SCENE_STEPS}-step call "
        f"under torch.profiler: {1e6 * wall / SCENE_STEPS:.2f} us/step host "
        f"time, device busy {100 * busy / wall:.1f} %; device us/step: "
        + ", ".join(f"{k} {1e6 * v / SCENE_STEPS:.2f}" for k, v in sorted(
            spent.items(), key=lambda kv: -kv[1])[:8]))
    k3_plain_ms = cuda_ms(torch, lambda: resident_affine_plain(
        ao, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS), reps=PLAIN_REPS,
        warmup=0)
    k3_bound, k3_by = bound_ms(*k3_cost(ao, SCENE_STEPS, ITERATIONS,
                                        REBASE_EVERY, 0, nb=ENSEMBLE))

    k2_ms = cuda_ms(torch, lambda: resident_multistep_batched(
        ro, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS))
    k2_plain_ms = cuda_ms(torch, lambda: resident_multistep_plain(
        ro, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS), reps=PLAIN_REPS,
        warmup=0)
    k2_bound, k2_by = bound_ms(*k2_cost(ro, SCENE_STEPS, ITERATIONS,
                                        nb=ENSEMBLE))
    k2_by_B = {B: 1e3 * cuda_ms(torch, lambda B=B: resident_multistep_batched(
        ro, P64[:B], V64[:B], F0[:B], rb, SCENE_STEPS, ITERATIONS), reps=10)
        / SCENE_STEPS for B in (8, ENSEMBLE)}
    # the one part a library call computes: the batch's projection and
    # lift, two torch.matmul on the stored bfloat16 matrices (the port never
    # calls them on the kernel path)
    snm = sn.to(ro.ut_acT.dtype).permute(1, 2, 0)              # (3, N, B)
    um = u_k.to(ro.U_liftT.dtype).permute(1, 0, 2)             # (3, B, r)
    part_ms = cuda_ms(torch, lambda: (torch.matmul(ro.ut_acT, snm),
                                      torch.matmul(um, ro.U_liftT)))

    k5_win = affine_chunked_batched(ao, P64, V64, F0, rb, WINDOW_STEPS,
                                    ITERATIONS)[2]
    require(k5_win == WINDOW_STEPS, f"batched kernel 5 stopped after "
            f"{k5_win} of the ring-down window's {WINDOW_STEPS} steps")
    k5_ms = cuda_ms(torch, lambda: affine_chunked_batched(
        ao, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS))
    k5_window_ms = cuda_ms(torch, lambda: affine_chunked_batched(
        ao, P64, V64, F0, rb, WINDOW_STEPS, ITERATIONS), reps=3, warmup=1)
    k5_plain_ms = cuda_ms(torch, lambda: affine_chunked_plain(
        ao, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS), reps=PLAIN_REPS,
        warmup=0)
    k5_bound, k5_by = bound_ms(*k5_cost(ao, SCENE_STEPS, ITERATIONS,
                                        CHUNK_EVERY, nb=ENSEMBLE))

    # a call between two events (the wrapper's host time included), and the
    # device time per launch
    k1_ms = cuda_ms(torch, lambda: fused_reduced_iterations_batched(
        fo, snT, rbc, ITERATIONS), reps=100)
    k1_device_ms = device_ms(torch, lambda: fused_reduced_iterations_batched(
        fo, snT, rbc, ITERATIONS), reps=100)
    k1_plain_ms = cuda_ms(torch, lambda: fused_reduced_iterations_plain(
        fo, snT, rbc, ITERATIONS), reps=PLAIN_REPS, warmup=0)
    k1_bound, k1_by = bound_ms(*k1_cost(fo, ro.n_sel, ITERATIONS,
                                        nb=ENSEMBLE))
    # the large-model route through the entry point (the solver is still
    # prepared with CHUNKED_TIER1_MIN_VERTS = 0): the ring-down window is
    # contact-free, so kernel 5 serves all of it
    t0 = time.perf_counter()
    run(*ens, WINDOW_STEPS, num_iterations=ITERATIONS)
    entry_c = ENSEMBLE * WINDOW_STEPS / (time.perf_counter() - t0)
    require(solver._last_batched_path == "batched-chunked",
            f"the large-model route took {solver._last_batched_path} on the "
            "ring-down window")
    step_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(*ens, num_iterations=ITERATIONS)
        step_s.append(time.perf_counter() - t0)
    log(f"[4] batched kernel 3, B={ENSEMBLE}: {1e3 * k3_ms / SCENE_STEPS:.2f}"
        f" us/step ({SCENE_STEPS}-step calls); plain "
        f"{1e3 * k3_plain_ms / SCENE_STEPS:.1f} us/step; bound "
        f"{1e3 * k3_bound / SCENE_STEPS:.4f} us/step ({k3_by})")
    log(f"[4] batched kernel 2: " + ", ".join(
        f"B={B} {us:.2f} us/step" for B, us in k2_by_B.items())
        + f"; plain at B={ENSEMBLE} {1e3 * k2_plain_ms / SCENE_STEPS:.1f} "
        f"us/step; bound {1e3 * k2_bound / SCENE_STEPS:.4f} us/step "
        f"({k2_by}); library part (torch.matmul projection + lift of the "
        f"batch, one step) {1e3 * part_ms:.2f} us")
    log(f"[4] batched kernel 5, B={ENSEMBLE}: {1e3 * k5_ms / SCENE_STEPS:.2f}"
        f" us/step ({SCENE_STEPS}-step calls), over {WINDOW_STEPS} steps "
        f"{1e3 * k5_window_ms / WINDOW_STEPS:.2f} us/step = "
        f"{ENSEMBLE * WINDOW_STEPS / (k5_window_ms / 1e3):.0f} aggregate "
        f"steps/s; plain {1e3 * k5_plain_ms / SCENE_STEPS:.1f} us/step; "
        f"bound {1e3 * k5_bound / SCENE_STEPS:.4f} us/step ({k5_by}); "
        f"make_batched_run on the large-model route over {WINDOW_STEPS} "
        f"steps {entry_c:.0f} aggregate steps/s, host transfers included")
    log(f"[4] batched kernel 1, B={ENSEMBLE}: {1e3 * k1_ms:.2f} us/call "
        f"between two events ({1e3 * k1_device_ms:.2f} us/launch on the "
        f"device); "
        f"plain {1e3 * k1_plain_ms:.1f} us; bound {1e3 * k1_bound:.4f} us "
        f"({k1_by}); make_batched_step entry point "
        f"{1e3 * statistics.median(step_s):.1f} ms/step, host transfers "
        "included")

    # the batched contact-mode build on the crumpling ensemble, which clamps
    # on most steps, with the profiler's breakdown, and on the ring-down
    # ensemble's free steps over WINDOW_STEPS (its comparison with the lean
    # build is tools/ab_contact_mode.py)
    Pcr, Vcr, Fcr = (solver._pack(x) for x in crumple)
    fl_mode = _launch_affine(ao, Pcr, Vcr, Fcr, rb, SCENE_STEPS, ITERATIONS,
                             REBASE_EVERY, "contact")[2][:, FLAG_SLOTS:]
    in_mode = (fl_mode & 2) > 0

    def crumple_call():
        return resident_affine_contact_batched(ao, Pcr, Vcr, Fcr, rb,
                                               SCENE_STEPS, ITERATIONS)

    k3m_ms = cuda_ms(torch, crumple_call, reps=10)
    wall_m, spent_m = device_breakdown(torch, crumple_call)
    k3m_ring_ms = cuda_ms(torch, lambda: resident_affine_contact_batched(
        ao, P64, V64, F0, rb, WINDOW_STEPS, ITERATIONS), reps=3, warmup=1)
    k3m_plain_ms = cuda_ms(torch, lambda: resident_affine_contact_plain(
        ao, Pcr, Vcr, Fcr, rb, SCENE_STEPS, ITERATIONS), reps=1, warmup=0)
    k3m_bound, k3m_by = bound_ms(*k3m_cost(
        ao, SCENE_STEPS, ITERATIONS, REBASE_EVERY, int(in_mode.sum()),
        int(in_mode.any(0).sum()), int((fl_mode & 1).sum()), nb=CRUMPLE))
    log(f"[4] batched kernel 3 (contact mode), crumpling ensemble of "
        f"{CRUMPLE} sims ({int(in_mode.sum())} of {CRUMPLE * SCENE_STEPS} "
        f"sim-steps in contact mode, on {int(in_mode.any(0).sum())} of "
        f"{SCENE_STEPS} steps): {1e3 * k3m_ms / SCENE_STEPS:.2f} us/step; "
        f"plain {1e3 * k3m_plain_ms / SCENE_STEPS:.1f} us/step; bound "
        f"{1e3 * k3m_bound / SCENE_STEPS:.4f} us/step ({k3m_by}); under "
        f"torch.profiler {1e6 * wall_m / SCENE_STEPS:.2f} us/step host "
        f"time, device busy {100 * sum(spent_m.values()) / wall_m:.1f} %; "
        "device us/step: " + ", ".join(
            f"{k} {1e6 * v / SCENE_STEPS:.2f}" for k, v in sorted(
                spent_m.items(), key=lambda kv: -kv[1])[:9]))
    log(f"[4] batched kernel 3 (contact mode), ring-down ensemble of "
        f"{ENSEMBLE} sims over {WINDOW_STEPS} steps: "
        f"{1e3 * k3m_ring_ms / WINDOW_STEPS:.2f} us/step, "
        f"{ENSEMBLE * WINDOW_STEPS / (k3m_ring_ms / 1e3):.0f} aggregate "
        "steps/s")
    reprepare(solver, CHUNKED_TIER1_MIN_VERTS=default_min,
              resident_rebase_every=None, resident_contact_mode=None)
    k4b = exit_batched(torch, counted, paths, solver, model, f, main_state)

    # equals_solo_bitwise: each sim's output of a call was held bit for bit
    # against the solo kernel's (kernel 5: its chunk launch; the state it
    # commits is held at STEP_TOL against each sim's solo k-step run)
    def entry(name, source, replaces, err, ms, plain_ms, bound, by,
              bitwise=True, **extra):
        return {"name": name, "route": "cuda",
                "source": f"animsnapbases_tpu_torch/csrc/{source}",
                "replaces": f"animsnapbases_tpu/ops/{replaces}",
                "launches": paths[launch_path[name]][name],
                "launches_path": launch_path[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "sims": ENSEMBLE, "equals_solo_bitwise": bitwise, **extra}

    return [
        entry("fused_reduced_iterations_batched", "fused_reduced.cu",
              "pallas_reduced.py:393", k1_err, k1_ms, k1_plain_ms, k1_bound,
              k1_by, entry_step_ms=1e3 * statistics.median(step_s),
              device_ms=k1_device_ms),
        entry("resident_multistep_batched", "resident.cu",
              "pallas_resident.py:415", err["kernel 2"], k2_ms, k2_plain_ms,
              k2_bound, k2_by, steps_per_call=SCENE_STEPS,
              us_per_step_by_sims=k2_by_B,
              library_part_ms_per_step=part_ms,
              staging_plan_by_sims=k2_plans),
        entry("resident_affine_batched", "affine.cu",
              "pallas_resident.py:558", err["kernel 3"], k3_ms, k3_plain_ms,
              k3_bound, k3_by, steps_per_call=SCENE_STEPS,
              window_us_per_step_by_sims=per_step,
              window_bound_us_per_step_by_sims=bounds,
              entry_aggregate_steps_per_s=entry_a_lean,
              staging_plan_by_sims=k3_plans,
              device_busy_share=busy / wall,
              device_us_per_step_by_launch={
                  k: 1e6 * v / SCENE_STEPS for k, v in spent.items()}),
        entry("affine_chunked_batched", "affine_chunked.cu",
              "pallas_resident.py:1145", err["kernel 5"], k5_ms, k5_plain_ms,
              k5_bound, k5_by, bitwise=False, chunk_equals_solo_bitwise=True,
              steps_per_call=SCENE_STEPS,
              window_aggregate_steps_per_s=(
                  ENSEMBLE * WINDOW_STEPS / (k5_window_ms / 1e3)),
              entry_aggregate_steps_per_s=entry_c,
              whole_batch_k=k, solo_k=ks,
              committed_vs_solo_max_abs=k5_err),
        entry("resident_affine_contact_batched", "affine.cu",
              "pallas_resident.py:558", err["kernel 3 (contact mode)"],
              k3m_ms, k3m_plain_ms, k3m_bound, k3m_by, sims=CRUMPLE,
              steps_per_call=SCENE_STEPS, scene="crumpling ensemble",
              contact_mode_sim_steps=int(in_mode.sum()),
              ringdown_window_us_per_step=1e3 * k3m_ring_ms / WINDOW_STEPS,
              entry_aggregate_steps_per_s=entry_a,
              staging_plan_by_sims=k3_plans,
              crumple_entry_s=out["e s"],
              device_busy_share=sum(spent_m.values()) / wall_m,
              device_us_per_step_by_launch={
                  k: 1e6 * v / SCENE_STEPS for k, v in spent_m.items()}),
        k4b,
    ]


def exit_batched(torch, counted, paths, solver, model, f, main_state):
    """Kernel 4's batched build (row 4b: ``build_resident_affine_exit`` at
    nb > 1, ``pallas_resident.py:1122``), which no entry point takes (the
    JAX package builds kernel 4 solo only): launched directly, one counted
    path, on the ring-down ensemble at 8 and ENSEMBLE sims over
    WINDOW_STEPS (contact-free: k must be the window's steps) and on the
    mixed batch over SCENE_STEPS (the whole-batch exit: k must be the first
    contact sim's first clamp, the plain version's k and the least of the
    sims' solo k, in two launches).  Held step by step against the plain
    version (:func:`carried_steps` on a ring-down sim and the first contact
    sim of the mixed batch, every call launched on the whole batch), one
    step of each batch against the batched plain version, and each sim of
    the mixed batch (and of the ring-down at 8) bit for bit against solo
    kernel 4 run for as many steps.  Timed over WINDOW_STEPS at 1, 8 and
    ENSEMBLE sims in turns with batched kernel 3's lean build (one sim: the
    solo kernels).  Returns its entry of the kernels line."""
    from animsnapbases_tpu_torch.ops.affine import (
        resident_affine,
        resident_affine_batched,
        resident_affine_exit,
        resident_affine_exit_batched,
        resident_affine_exit_plain,
    )
    from animsnapbases_tpu_torch.ops.resident import force_term

    ao = solver._affine
    ro = ao.res
    rb = solver._rb_extra()
    sizes = [B for B in ENSEMBLE_SIZES if B <= ENSEMBLE]
    rings = {B: tuple(solver._pack(x) for x in ensemble_state(main_state, B))
             for B in sizes}
    Pm, Vm, Fm = (solver._pack(x) for x in mixed_state(model, main_state, f))
    first = contact_sims()[0]
    out = {}

    def direct():
        for B in sizes[1:]:
            out[B] = resident_affine_exit_batched(
                ao, *rings[B], rb, WINDOW_STEPS, ITERATIONS)
        before = resident_affine_exit_batched.launches
        out["mixed"] = resident_affine_exit_batched(ao, Pm, Vm, Fm, rb,
                                                    SCENE_STEPS, ITERATIONS)
        out["mixed launches"] = resident_affine_exit_batched.launches - before

    label = (f"batched kernel 4, launched directly (ring-down at "
             f"{sizes[1:]} sims, mixed batch of {MIXED})")
    paths[label] = counted_path(torch, counted, label,
                                {"resident_affine_exit_batched"}, direct)
    for B in sizes[1:]:
        P_, V_, k = out[B]
        require(k == WINDOW_STEPS and bool(torch.isfinite(P_).all())
                and bool(torch.isfinite(V_).all()),
                f"batched kernel 4 stopped after {k} of the ring-down "
                f"window's {WINDOW_STEPS} steps at {B} sims, or its state is "
                "not finite")
    B8 = sizes[1]
    same_per_sim(torch, f"batched kernel 4, ring-down B={B8}, "
                 f"{WINDOW_STEPS} steps", out[B8][:2],
                 lambda b: resident_affine_exit(
                     ao, *(x[b] for x in rings[B8]), rb, WINDOW_STEPS,
                     ITERATIONS)[:2], B8)
    Pk, Vk, k = out["mixed"]
    ks = [resident_affine_exit(ao, Pm[b], Vm[b], Fm[b], rb, SCENE_STEPS,
                               ITERATIONS)[2] for b in range(MIXED)]
    kp = resident_affine_exit_plain(ao, Pm, Vm, Fm, rb, SCENE_STEPS,
                                    ITERATIONS)[2]
    log(f"[3] batched kernel 4, mixed batch: whole-batch k {k} in "
        f"{out['mixed launches']} launches (plain {kp}); the sims' solo "
        f"k {ks}; the first contact sim {first}")
    require(k == kp == min(ks) == ks[first] and 0 < k < max(ks),
            f"batched kernel 4's k {k} is not the first contact sim's first "
            f"clamp (solo k {ks}) or the plain version's {kp}")
    require(out["mixed launches"] == 2,
            f"batched kernel 4 on the mixed batch was never launched twice "
            f"({out['mixed launches']} launches)")
    same_per_sim(torch, f"batched kernel 4, mixed batch, k = {k} steps",
                 (Pk, Vk), lambda b: resident_affine_exit(
                     ao, Pm[b], Vm[b], Fm[b], rb, k, ITERATIONS)[:2], MIXED)
    err = 0.0
    for b in (0, first):
        e, _ = carried_steps(
            torch, f"batched kernel 4, mixed batch, sim {b}, carried steps",
            "4b", ao, resident_affine_exit_plain, Pm[b], Vm[b], Fm[b], rb,
            k, batch=(Pm, Vm, Fm, b))
        err = max(err, e)
    for name, (P_, V_, F_) in (("mixed batch", (Pm, Vm, Fm)),
                               (f"ring-down B={ENSEMBLE}", rings[ENSEMBLE])):
        Pk1, Vk1, _ = resident_affine_exit_batched(ao, P_, V_, F_, rb, 1,
                                                   ITERATIONS)
        Pp1, Vp1, _ = resident_affine_exit_plain(ao, P_, V_, F_, rb, 1,
                                                 ITERATIONS)
        fa = force_term(ro, F_)
        for b in range(P_.shape[0]):
            shares = step_share(ro, fa[b], rb, P_[b], V_[b], Pk1[b], Vk1[b],
                                Pp1[b], Vp1[b])
            hold_step(f"batched kernel 4, {name}, sim {b}", shares)
            err = max(err, *(d for d, _ in shares.values()))
    log(f"[3] batched kernel 4: carried steps of sims 0 and {first} and one "
        f"step of both batches against the plain version within {STEP_TOL} "
        f"of each step's size; max abs {err:.3e}")

    # ---- 4. times --------------------------------------------------------
    per_step, k3_step = {}, {}
    for B in sizes:
        P_, V_, F_ = rings[B]
        if B == 1:      # one sim serves on the solo kernels
            P_, V_, F_ = P_[0], V_[0], F_[0]
            k4, k3 = resident_affine_exit, resident_affine
        else:
            k4, k3 = resident_affine_exit_batched, resident_affine_batched
        t = in_turns(torch, {
            "4": lambda: k4(ao, P_, V_, F_, rb, WINDOW_STEPS, ITERATIONS),
            "3": lambda: k3(ao, P_, V_, F_, rb, WINDOW_STEPS, ITERATIONS)},
            EXIT_ROUNDS)
        per_step[B] = 1e3 * t["4"] / WINDOW_STEPS
        k3_step[B] = 1e3 * t["3"] / WINDOW_STEPS
    P64, V64, F64 = rings[ENSEMBLE]
    ms = cuda_ms(torch, lambda: resident_affine_exit_batched(
        ao, P64, V64, F64, rb, SCENE_STEPS, ITERATIONS))
    plain_ms = cuda_ms(torch, lambda: resident_affine_exit_plain(
        ao, P64, V64, F64, rb, SCENE_STEPS, ITERATIONS), reps=PLAIN_REPS,
        warmup=0)
    bound, by = bound_ms(*k3_cost(ao, SCENE_STEPS, ITERATIONS, REBASE_EVERY,
                                  0, nb=ENSEMBLE))
    bounds = {B: 1e3 * bound_ms(*k3_cost(ao, WINDOW_STEPS, ITERATIONS,
                                         REBASE_EVERY, 0, nb=B))[0]
              / WINDOW_STEPS for B in sizes}
    log(f"[4] batched kernel 4, ring-down over {WINDOW_STEPS} steps, in "
        f"turns with batched kernel 3 (lean): " + "; ".join(
            f"B={B} {per_step[B]:.2f} us/step (kernel 3 {k3_step[B]:.2f}; "
            f"bound {bounds[B]:.4f})" for B in sizes)
        + f"; B={ENSEMBLE} {SCENE_STEPS}-step calls "
        f"{1e3 * ms / SCENE_STEPS:.2f} us/step, plain "
        f"{1e3 * plain_ms / SCENE_STEPS:.1f} us/step, bound "
        f"{1e3 * bound / SCENE_STEPS:.4f} us/step ({by})")
    return {"name": "resident_affine_exit_batched", "route": "cuda",
            "source": "animsnapbases_tpu_torch/csrc/affine.cu",
            "replaces": "animsnapbases_tpu/ops/pallas_resident.py:1122 "
                        "(nb > 1)",
            "launches": paths[label]["resident_affine_exit_batched"],
            "launches_path": label, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "sims": ENSEMBLE,
            "steps_per_call": SCENE_STEPS, "equals_solo_bitwise": True,
            "whole_batch_k": k, "solo_k": ks, "mixed_launches":
                out["mixed launches"],
            "window_us_per_step_by_sims": per_step,
            "kernel3_lean_window_us_per_step_by_sims": k3_step,
            "window_bound_us_per_step_by_sims": bounds}


# the tier switches every run of the bench scene takes, and the switch scene
# of the new kinds: (label, switches, tier-1 kernel, contact-tier kernel)
TIER_SWITCHES = (
    ("lean contact tier", {"resident_contact_mode": False},
     "affine_chunked", "resident_affine"),
    ("resident_chunked_tier1=False",
     {"resident_chunked_tier1": False}, "resident_affine_exit",
     "resident_affine"),
    ("resident_contact_mode=True",
     {"resident_chunked_tier1": True, "resident_contact_mode": True},
     "affine_chunked", "resident_affine_contact"),
    ("resident_contact_mode=True, resident_chunked_tier1=False",
     {"resident_chunked_tier1": False}, None, "resident_affine_contact"),
    ("CHUNKED_TIER1_MIN_VERTS=0",
     {"resident_chunked_tier1": True, "resident_contact_mode": False,
      "CHUNKED_TIER1_MIN_VERTS": 0},
     "affine_chunked", "resident_multistep"))


def scene_batch(main_end, contact_in, f):
    """A batch of NEW_BATCH sims of one scene: the first half ring down from
    the main path's end state (sim b at (1 - SPREAD b) x a tenth of its
    velocity, no force), the second half in the contact window under
    gravity (``f``), sim j of them lifted CONTACT_STEP j more."""
    half = NEW_BATCH // 2
    P0, V0 = main_end
    Pc, Vc = contact_in
    pos = np.stack([P0] * half + [Pc] * (NEW_BATCH - half))
    vel = np.stack([(1.0 - SPREAD * b) * 0.1 * V0 for b in range(half)]
                   + [Vc] * (NEW_BATCH - half))
    fs = np.zeros_like(pos)
    for j, b in enumerate(range(half, NEW_BATCH)):
        pos[b][:, 1] += CONTACT_STEP * j
        fs[b] = f
    return pos, vel, fs


def kind_columns(fo):
    """{kind: table columns} of the fused operands, block form included."""
    out = {}
    for name, _, cols, _, _ in fo.segments:
        out[name] = out.get(name, 0) + cols
    return out


def star_sum_f32(fo, x):
    """``x_sel G_allT`` with every column's sum taken in float32, in the
    kernel's order (the JAX kernel's precision), beside :func:`gather_vc`'s
    float64 sum."""
    acc = fo.gpad_w[0].float() * x[..., fo.gpad_col[0]]
    for k in range(1, fo.gpad_col.shape[0]):
        acc = acc + fo.gpad_w[k].float() * x[..., fo.gpad_col[k]]
    return acc


def tet_bending(torch, counted, paths, scenes=None):
    """The scenes of the tet, bending and block-form kinds
    (:func:`tet_bending_scenes`; ``scenes``, a set of labels, picks some
    of them) on the card.  Each scene goes through
    ``prepare -> step -> run_steps(SCENE_STEPS)`` on the default tiers
    (kernel 1, then kernel 5, which must certify the window), then a
    contact window (kernel 5 exits, kernel 3's contact-mode build finishes
    it), then ``make_batched_step`` and ``make_batched_run`` at NEW_BATCH
    sims (batched kernels 1 and 3'), each a counted path; the switch scene
    also takes every tier switch (kernels 4, 3 lean and 2) and their
    batched routes (batched kernels 3 lean, 5 and 2).  Holds: kernel 1
    against a float64 step (ACC_RATIO); kernels 5 and 3' (and on the switch
    scene 3 lean and 4) in the steps one call carries, and kernel 2 step by
    step, against their plain versions at STEP_TOL of each step's size with
    the branch-step rule (:func:`carried_steps`, :func:`step_by_step`),
    NEW_DEPTH steps; every batched sim bit for bit against its solo call.
    Times and bounds of each kernel on each scene.  Returns {kernel name:
    {scene: entry}} for the kernels line."""
    from animsnapbases_tpu_torch.device import resolve_device
    from animsnapbases_tpu_torch.ops.affine import (
        FLAG_SLOTS,
        _launch_affine,
        affine_plan,
        resident_affine,
        resident_affine_batched,
        resident_affine_contact,
        resident_affine_contact_batched,
        resident_affine_contact_plain,
        resident_affine_exit,
        resident_affine_exit_plain,
        resident_affine_plain,
    )
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        _chunk_launch,
        affine_chunked,
        affine_chunked_batched,
        affine_chunked_plain,
        chunk_anchors,
        chunk_plan,
    )
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_plan,
        fused_reduced_iterations,
        fused_reduced_iterations_batched,
        fused_reduced_iterations_plain,
        gather_vc,
    )
    from animsnapbases_tpu_torch.ops.resident import (
        force_term,
        predict,
        project,
        resident_multistep,
        resident_multistep_batched,
        resident_multistep_plain,
    )
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    per = {}

    def note(name, scene, err, ms, plain_ms, bound, by, **extra):
        per.setdefault(name, {})[scene] = {
            "launches": paths[launch_of[name]][name],
            "launches_path": launch_of[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, **extra}

    dev = resolve_device("cuda")
    for label, args, build, comps, block, damping in tet_bending_scenes():
        if scenes is not None and label not in scenes:
            continue
        t0 = time.perf_counter()
        model = build()
        solver = scene_solver(
            synthetic_reduced_solver, model, K=BENCH_MODES, r=64,
            damping=damping, device=dev, dtype=torch.float32,
            matmul_dtype=torch.bfloat16, block=block, oversample=OVERSAMPLE,
            components=comps)
        ro, ao = solver._resident, solver._affine
        fo = ro.fused
        cols = kind_columns(fo)
        log(f"[2] {label}: prepare {time.perf_counter() - t0:.1f} s: "
            f"N={ro.n} r={fo.r} n_sel={ro.n_sel} g_total={fo.g_total} "
            f"m_total={fo.m_total} gather entries {fo.gw.numel()} "
            f"(longest column {fo.gpad_col.shape[0]}); table columns {cols}"
            f"{' (block form)' if block else ''}; tiers: "
            f"{solver._resident_fast_kind} tier 1, {solver._resident_kind} "
            f"contact tier")
        launch_of = {}
        rest = (model.positions.copy(), model.velocities.copy())
        f = gravity(model)
        start = []

        def main_path():
            solver.step(f, num_iterations=ITERATIONS)
            start.extend((model.positions.copy(), model.velocities.copy()))
            solver.run_steps(f, SCENE_STEPS, num_iterations=ITERATIONS)

        key = f"{label}: main path"
        paths[key] = counted_path(
            torch, counted, f"{label}, step + run_steps({SCENE_STEPS})",
            {"fused_reduced_iterations", "affine_chunked"}, main_path)
        launch_of.update(fused_reduced_iterations=key, affine_chunked=key)
        require(solver._last_fast_steps == SCENE_STEPS
                and np.isfinite(model.positions).all(),
                f"{label}: tier 1 did not certify the {SCENE_STEPS}-step "
                f"window ({solver._last_fast_steps})")
        main_end = (model.positions.copy(), model.velocities.copy())
        model.positions, model.velocities = contact_state(model)
        contact_in = (model.positions.copy(), model.velocities.copy())
        real = solver._resident_fast
        calls = spy_tier1(solver)
        key = f"{label}: contact window"
        paths[key] = counted_path(
            torch, counted, f"{label}, contact window",
            {"affine_chunked", "resident_affine_contact"},
            lambda: solver.run_steps(f, SCENE_STEPS,
                                     num_iterations=ITERATIONS))
        launch_of["resident_affine_contact"] = key
        require(len(calls) == 1 and 0 < calls[0] < SCENE_STEPS
                and np.isfinite(model.positions).all()
                and model.positions[:, 1].min() > -0.5,
                f"{label}: the contact window did not go tier 1 -> contact "
                f"tier, or ended off the floor (tier-1 calls {calls})")
        solver._resident_fast = real
        log(f"[2] {label}: main path certified; contact window: tier 1 "
            f"{calls[0]} steps, kernel 3 (contact mode) "
            f"{SCENE_STEPS - calls[0]}, end y in "
            f"[{model.positions[:, 1].min():.4f}, "
            f"{model.positions[:, 1].max():.4f}]")
        batch = scene_batch(main_end, contact_in, f)
        served = []
        key = f"{label}: make_batched_step, B={NEW_BATCH}"
        step = solver.make_batched_step()
        paths[key] = counted_path(
            torch, counted, f"{label}, make_batched_step at {NEW_BATCH} "
            "sims", {"fused_reduced_iterations_batched"},
            lambda: served.append(step(*batch, num_iterations=ITERATIONS)))
        launch_of["fused_reduced_iterations_batched"] = key
        key = f"{label}: make_batched_run, B={NEW_BATCH}"
        run = solver.make_batched_run()
        paths[key] = counted_path(
            torch, counted, f"{label}, make_batched_run at {NEW_BATCH} sims",
            {"resident_affine_contact_batched"},
            lambda: served.append(run(*batch, SCENE_STEPS, ITERATIONS)))
        launch_of["resident_affine_contact_batched"] = key
        require(all(np.isfinite(x).all() for o in served for x in o)
                and served[1][0][:, :, 1].min() > -0.5,
                f"{label}: batched serving ended non-finite or off the floor")

        # ---- 3. holds ----------------------------------------------------
        P, V = (solver._to_device(x) for x in rest)
        Fx = solver._to_device(f)
        rb = solver._rb_extra()
        sn, rb_const = predict(ro, P, V, force_term(ro, Fx), rb)
        snT_sel = sn[:, :ro.n_sel]
        u_k = fused_reduced_iterations(fo, snT_sel, rb_const, ITERATIONS)
        u_p = fused_reduced_iterations_plain(fo, snT_sel, rb_const,
                                             ITERATIONS)
        u_64 = fused_reduced_iterations_plain(
            as_f64(fo), snT_sel.double(), rb_const.double(), ITERATIONS)
        ok, e_k, e_p = as_accurate(u_k, u_p, u_64)
        k1_err = max_abs(u_k, u_p)
        log(f"[3] {label}, kernel 1: vs plain max abs {k1_err:.3e} (max|u| "
            f"{float(u_p.abs().max()):.3e}); vs float64: kernel {e_k:.3e}, "
            f"plain {e_p:.3e} (limit {ACC_RATIO}x)")
        require(bool(torch.isfinite(u_k).all()) and ok,
                f"{label}: kernel 1 is less accurate than its plain version")
        # the star sums of the predictor's gathered values: the float64 sum
        # that the kernels and plain versions take, against a float32 sum
        # (printed, not held)
        if "verts_bending" in cols:
            bend = fo.elem_g[0, fo.elem_kind == 4].long()
            v64, v32 = gather_vc(fo, snT_sel), star_sum_f32(fo, snT_sel)
            log(f"[3] {label}: bending star sums of the predictor, float32 "
                f"against float64: max abs "
                f"{max_abs(v32[:, bend], v64[:, bend]):.3e} of max "
                f"{float(v64[:, bend].abs().max()):.3e}")
        Pb, Vb, Fb = (solver._pack(x) for x in batch)
        snb, rbcb = predict(ro, Pb, Vb, force_term(ro, Fb), rb)
        ub = fused_reduced_iterations_batched(
            fo, snb[..., :ro.n_sel], rbcb.contiguous(), ITERATIONS)
        same_per_sim(torch, f"{label}, batched kernel 1", (ub,),
                     lambda b: (fused_reduced_iterations(
                         fo, snb[b, :, :ro.n_sel], rbcb[b].contiguous(),
                         ITERATIONS),), NEW_BATCH)
        Pm, Vm = (solver._to_device(x) for x in start)
        Pc, Vc = (solver._to_device(x) for x in contact_in)
        err = {}
        for kernel, P0, V0, plain, every in (
                (5, Pm, Vm, affine_chunked_plain, CHUNK_EVERY),
                ("3c", Pc, Vc, resident_affine_contact_plain,
                 NEW_DEPTH // 2)):
            name = "kernel 3 (contact mode)" if kernel == "3c" else "kernel 5"
            err[kernel], flags = carried_steps(
                torch, f"{label}, {name}, carried steps", kernel, ao,
                lambda *a, plain=plain, every=every: plain(
                    *a, rebase_every=every), P0, V0, Fx, rb, NEW_DEPTH, every)
            if kernel == "3c":
                require(int((flags[FLAG_SLOTS:] & 1).sum()) >= 2,
                        f"{label}: contact mode was not entered again after "
                        "a rebase")
        out = resident_affine_contact_batched(ao, Pb, Vb, Fb, rb, NEW_DEPTH,
                                              ITERATIONS)
        same_per_sim(torch, f"{label}, batched kernel 3 (contact mode), "
                     f"{NEW_DEPTH} steps", out,
                     lambda b: resident_affine_contact(
                         ao, Pb[b], Vb[b], Fb[b], rb, NEW_DEPTH, ITERATIONS),
                     NEW_BATCH)

        # ---- 4. times and bounds -----------------------------------------
        # kernel 1: a call between two events, and the device time per
        # launch
        k1_ms = cuda_ms(torch, lambda: fused_reduced_iterations(
            fo, snT_sel, rb_const, ITERATIONS), reps=100)
        k1_dev = device_ms(torch, lambda: fused_reduced_iterations(
            fo, snT_sel, rb_const, ITERATIONS), reps=100)
        k1_plain = cuda_ms(torch, lambda: fused_reduced_iterations_plain(
            fo, snT_sel, rb_const, ITERATIONS), reps=1, warmup=0)
        plans = {"fused_reduced_iterations": fused_plan(fo),
                 "affine_chunked": chunk_plan(ao)}
        note("fused_reduced_iterations", label, k1_err, k1_ms, k1_plain,
             *bound_ms(*k1_cost(fo, ro.n_sel, ITERATIONS)),
             table_columns=cols, device_ms=k1_dev,
             staging_plan=plans["fused_reduced_iterations"].as_dict())
        kb_ms = cuda_ms(torch, lambda: fused_reduced_iterations_batched(
            fo, snb[..., :ro.n_sel], rbcb, ITERATIONS))
        kb_plain = cuda_ms(torch, lambda: fused_reduced_iterations_plain(
            fo, snb[..., :ro.n_sel], rbcb, ITERATIONS), reps=1, warmup=0)
        note("fused_reduced_iterations_batched", label, 0.0, kb_ms, kb_plain,
             *bound_ms(*k1_cost(fo, ro.n_sel, ITERATIONS, NEW_BATCH)),
             sims=NEW_BATCH)
        require(affine_chunked(ao, Pm, Vm, Fx, rb, SCENE_STEPS,
                               ITERATIONS)[2] == SCENE_STEPS,
                f"{label}: kernel 5 stopped in the main window")
        k5_ms = cuda_ms(torch, lambda: affine_chunked(
            ao, Pm, Vm, Fx, rb, SCENE_STEPS, ITERATIONS))
        k5_plain = cuda_ms(torch, lambda: affine_chunked_plain(
            ao, Pm, Vm, Fx, rb, NEW_DEPTH, ITERATIONS), reps=1, warmup=0)
        note("affine_chunked", label, err[5], k5_ms, k5_plain,
             *bound_ms(*k5_cost(ao, SCENE_STEPS, ITERATIONS, CHUNK_EVERY)),
             steps_per_call=SCENE_STEPS, plain_steps_per_call=NEW_DEPTH,
             staging_plan=plans["affine_chunked"].as_dict())
        fl = _launch_affine(ao, Pc, Vc, Fx, rb, SCENE_STEPS, ITERATIONS,
                            REBASE_EVERY, "contact")[2][FLAG_SLOTS:]
        in_mode = int(((fl & 2) > 0).sum())
        k3m_ms = cuda_ms(torch, lambda: resident_affine_contact(
            ao, Pc, Vc, Fx, rb, SCENE_STEPS, ITERATIONS))
        k3m_plain = cuda_ms(torch, lambda: resident_affine_contact_plain(
            ao, Pc, Vc, Fx, rb, NEW_DEPTH, ITERATIONS), reps=1, warmup=0)
        note("resident_affine_contact", label, err["3c"], k3m_ms, k3m_plain,
             *bound_ms(*k3m_cost(ao, SCENE_STEPS, ITERATIONS, REBASE_EVERY,
                                 in_mode, in_mode, int((fl & 1).sum()))),
             steps_per_call=SCENE_STEPS, contact_mode_steps=in_mode,
             plain_steps_per_call=NEW_DEPTH)
        flb = _launch_affine(ao, Pb, Vb, Fb, rb, SCENE_STEPS, ITERATIONS,
                             REBASE_EVERY, "contact")[2][:, FLAG_SLOTS:]
        kbm_ms = cuda_ms(torch, lambda: resident_affine_contact_batched(
            ao, Pb, Vb, Fb, rb, SCENE_STEPS, ITERATIONS))
        kbm_plain = cuda_ms(torch, lambda: resident_affine_contact_plain(
            ao, Pb, Vb, Fb, rb, NEW_DEPTH, ITERATIONS), reps=1, warmup=0)
        note("resident_affine_contact_batched", label, 0.0, kbm_ms,
             kbm_plain, *bound_ms(*k3m_cost(
                 ao, SCENE_STEPS, ITERATIONS, REBASE_EVERY,
                 int(((flb & 2) > 0).sum()),
                 int(((flb & 2) > 0).any(0).sum()), int((flb & 1).sum()),
                 NEW_BATCH)), sims=NEW_BATCH, steps_per_call=SCENE_STEPS,
             plain_steps_per_call=NEW_DEPTH)
        log(f"[2-4] {label}: paths, holds and times "
            f"{time.perf_counter() - t0:.1f} s")
        log(f"[4] {label}: staging plans (r={fo.r}, g={fo.g_total}, "
            f"m={fo.m_total}): " + "; ".join(
                f"{name} {list(p_.staged)} in shared memory, "
                f"{list(p_.from_l2) or 'nothing'} from L2, {p_.smem_bytes} B"
                for name, p_ in plans.items()))
        log(f"[4] {label}: kernel 1 {1e3 * k1_ms:.2f} us/call "
            f"({1e3 * k1_dev:.2f} us/launch on the device; batched, "
            f"{NEW_BATCH} sims, {1e3 * kb_ms:.2f} us/call); kernel 5 "
            f"{1e3 * k5_ms / SCENE_STEPS:.2f} us/step; kernel 3 (contact "
            f"mode), contact window ({in_mode} of {SCENE_STEPS} steps in "
            f"the mode) {1e3 * k3m_ms / SCENE_STEPS:.2f} us/step (batched, "
            f"{NEW_BATCH} sims, {1e3 * kbm_ms / SCENE_STEPS:.2f})")
        if label != SWITCH_SCENE:
            continue

        # ---- the switch scene: every tier switch and batched route -------
        for sw_label, switches, tier1, contact in TIER_SWITCHES:
            reprepare(solver, **switches)
            for run_name, counts in tiered_runs(
                    torch, counted, solver, model, f, rest,
                    f"{label}, {sw_label}", tier1, contact).items():
                paths[f"{label}, {sw_label}, {run_name}"] = counts
        launch_of.update(
            resident_affine=f"{label}, lean contact tier, contact scene",
            resident_affine_exit=f"{label}, resident_chunked_tier1=False, "
            "bench window",
            resident_multistep=f"{label}, CHUNKED_TIER1_MIN_VERTS=0, "
            "contact scene")
        for sw_label, switches, own in (
                ("lean", {"resident_contact_mode": False,
                          "CHUNKED_TIER1_MIN_VERTS": type(
                              solver).CHUNKED_TIER1_MIN_VERTS},
                 {"resident_affine_batched"}),
                ("CHUNKED_TIER1_MIN_VERTS=0",
                 {"CHUNKED_TIER1_MIN_VERTS": 0},
                 {"affine_chunked_batched", "resident_multistep_batched"})):
            reprepare(solver, **switches)
            run = solver.make_batched_run()
            key = f"{label}: make_batched_run, B={NEW_BATCH}, {sw_label}"
            paths[key] = counted_path(
                torch, counted, f"{label}, make_batched_run at {NEW_BATCH} "
                f"sims, {sw_label}", own,
                lambda: served.append(run(*batch, SCENE_STEPS, ITERATIONS)))
            launch_of.update({name: key for name in own})
            require(np.isfinite(served[-1][0]).all(),
                    f"{label}, {sw_label}: batched serving not finite")
        reprepare(solver, CHUNKED_TIER1_MIN_VERTS=type(
            solver).CHUNKED_TIER1_MIN_VERTS)
        ro, ao = solver._resident, solver._affine
        # kernel 2 step by step; kernels 3 (lean) and 4 in the steps one
        # call carries, on the main path's window
        k2_err, _ = step_by_step(
            torch, f"{label}, kernel 2", ro,
            lambda P_, V_: resident_multistep(ro, P_, V_, Fx, rb, 1,
                                              ITERATIONS),
            lambda P_, V_: resident_multistep_plain(ro, P_, V_, Fx, rb, 1,
                                                    ITERATIONS),
            Pm, Vm, Fx, rb, NEW_DEPTH)
        for kernel, plain in ((3, resident_affine_plain),
                              (4, resident_affine_exit_plain)):
            err[kernel], _ = carried_steps(
                torch, f"{label}, kernel {kernel}, carried steps", kernel,
                ao, lambda *a, plain=plain: plain(
                    *a, rebase_every=REBASE_EVERY), Pm, Vm, Fx, rb,
                NEW_DEPTH)
        # the batched builds against their solo calls, bit for bit
        for name, batched, solo in (
                ("kernel 2", resident_multistep_batched,
                 lambda b: resident_multistep(ro, Pb[b], Vb[b], Fb[b], rb,
                                              NEW_DEPTH, ITERATIONS)),
                ("kernel 3 (lean)", resident_affine_batched,
                 lambda b: resident_affine(ao, Pb[b], Vb[b], Fb[b], rb,
                                           NEW_DEPTH, ITERATIONS))):
            same_per_sim(torch, f"{label}, batched {name}, {NEW_DEPTH} "
                         "steps", batched(ao.res if name == "kernel 2" else
                                          ao, Pb, Vb, Fb, rb, NEW_DEPTH,
                                          ITERATIONS), solo, NEW_BATCH)
        fa = force_term(ro, Fb)
        bu0, bu1, b0s, b1s = chunk_anchors(ao, Pb, Vb)
        ymm = torch.empty(NEW_BATCH, 6, device=dev)
        ymm1 = torch.empty(NEW_BATCH, 6, device=dev)
        chunk_in = (Pb, Vb, fa, ymm, b0s, b1s, gather_vc(fo, fa), bu0, bu1,
                    project(ro, fa))

        def launch(P_, V_, fa_, ymm_, *anchors):
            return _chunk_launch(ao, P_, V_, fa_, ymm_, True, *anchors, rb,
                                 SCENE_STEPS, ITERATIONS, ao.floor_level)

        def solo_chunk(b):
            one = [x[b] for x in chunk_in]
            one[3] = ymm1[b]
            return (*launch(*one), ymm1[b])

        same_per_sim(torch, f"{label}, batched kernel 5 chunk, "
                     f"{SCENE_STEPS} steps", (*launch(*chunk_in), ymm),
                     solo_chunk, NEW_BATCH)
        ks = [affine_chunked(ao, Pb[b], Vb[b], Fb[b], rb, SCENE_STEPS,
                             ITERATIONS)[2] for b in range(NEW_BATCH)]
        k = affine_chunked_batched(ao, Pb, Vb, Fb, rb, SCENE_STEPS,
                                   ITERATIONS)[2]
        log(f"[3] {label}, batched kernel 5: whole-batch k {k}, the sims' "
            f"solo k {ks}")
        require(k == min(ks), f"{label}: batched kernel 5's k {k} is not "
                f"the least of the solo k {ks}")

        def timed(fn, plain_fn, P_, V_, F_):
            """(ms of the kernel's call, ms of the plain version's call);
            the plain calls run NEW_DEPTH steps (``plain_steps_per_call``
            in the kernels line)."""
            return (cuda_ms(torch, lambda: fn(P_, V_, F_)),
                    cuda_ms(torch, lambda: plain_fn(P_, V_, F_),
                            reps=1, warmup=0))

        k2 = timed(lambda *x: resident_multistep(ro, *x, rb, SCENE_STEPS,
                                                 ITERATIONS),
                   lambda *x: resident_multistep_plain(
                       ro, *x, rb, NEW_DEPTH, ITERATIONS), Pc, Vc, Fx)
        note("resident_multistep", label, k2_err, *k2,
             *bound_ms(*k2_cost(ro, SCENE_STEPS, ITERATIONS)),
             steps_per_call=SCENE_STEPS, window="contact window",
             plain_steps_per_call=NEW_DEPTH)
        fl = _launch_affine(ao, Pc, Vc, Fx, rb, SCENE_STEPS, ITERATIONS,
                            REBASE_EVERY, "lean")[2][FLAG_SLOTS:]
        k3 = timed(lambda *x: resident_affine(ao, *x, rb, SCENE_STEPS,
                                              ITERATIONS),
                   lambda *x: resident_affine_plain(ao, *x, rb, NEW_DEPTH,
                                                    ITERATIONS), Pc, Vc, Fx)
        note("resident_affine", label, err[3], *k3, *bound_ms(*k3_cost(
            ao, SCENE_STEPS, ITERATIONS, REBASE_EVERY, int(fl.sum()))),
            steps_per_call=SCENE_STEPS, window="contact window",
            clamped_steps=int(fl.sum()), plain_steps_per_call=NEW_DEPTH)
        k4 = timed(lambda *x: resident_affine_exit(ao, *x, rb, SCENE_STEPS,
                                                   ITERATIONS),
                   lambda *x: resident_affine_exit_plain(
                       ao, *x, rb, NEW_DEPTH, ITERATIONS), Pm, Vm, Fx)
        note("resident_affine_exit", label, err[4], *k4, *bound_ms(*k3_cost(
            ao, SCENE_STEPS, ITERATIONS, REBASE_EVERY, 0)),
            steps_per_call=SCENE_STEPS, plain_steps_per_call=NEW_DEPTH)
        flb = _launch_affine(ao, Pb, Vb, Fb, rb, SCENE_STEPS, ITERATIONS,
                             REBASE_EVERY, "lean")[2][:, FLAG_SLOTS:]
        k3b = timed(lambda *x: resident_affine_batched(
            ao, *x, rb, SCENE_STEPS, ITERATIONS), lambda *x:
            resident_affine_plain(ao, *x, rb, NEW_DEPTH, ITERATIONS),
            Pb, Vb, Fb)
        note("resident_affine_batched", label, 0.0, *k3b, *bound_ms(*k3_cost(
            ao, SCENE_STEPS, ITERATIONS, REBASE_EVERY, int(flb.sum()),
            NEW_BATCH)), sims=NEW_BATCH, steps_per_call=SCENE_STEPS,
            plain_steps_per_call=NEW_DEPTH)
        k2b = timed(lambda *x: resident_multistep_batched(
            ro, *x, rb, NEW_DEPTH, ITERATIONS), lambda *x:
            resident_multistep_plain(ro, *x, rb, NEW_DEPTH, ITERATIONS),
            Pb, Vb, Fb)
        note("resident_multistep_batched", label, 0.0, *k2b, *bound_ms(
            *k2_cost(ro, NEW_DEPTH, ITERATIONS, NEW_BATCH)), sims=NEW_BATCH,
            steps_per_call=NEW_DEPTH)
        # batched kernel 5 timed on NEW_BATCH ring-down sims (the batch's
        # first half twice) over NEW_DEPTH steps, which they must certify
        # (the bar's ring-down reaches the floor within SCENE_STEPS)
        half = NEW_BATCH // 2
        ring = [torch.cat([x[:half]] * (NEW_BATCH // half)) for x in
                (Pb, Vb, Fb)]
        require(affine_chunked_batched(ao, *ring, rb, NEW_DEPTH,
                                       ITERATIONS)[2] == NEW_DEPTH,
                f"{label}: batched kernel 5 stopped on ring-down sims")
        k5b = timed(lambda *x: affine_chunked_batched(
            ao, *x, rb, NEW_DEPTH, ITERATIONS), lambda *x:
            affine_chunked_plain(ao, *x, rb, NEW_DEPTH, ITERATIONS),
            *ring)
        note("affine_chunked_batched", label, 0.0, *k5b, *bound_ms(*k5_cost(
            ao, NEW_DEPTH, ITERATIONS, CHUNK_EVERY, NEW_BATCH)),
            sims=NEW_BATCH, steps_per_call=NEW_DEPTH, batch="ring-down")
        log(f"[4] {label}: kernel 2 {1e3 * k2[0] / SCENE_STEPS:.2f} us/step, "
            f"kernel 3 (lean) {1e3 * k3[0] / SCENE_STEPS:.2f} on the contact "
            f"window; kernel 4 {1e3 * k4[0] / SCENE_STEPS:.2f} on the main "
            f"window; batched ({NEW_BATCH} sims): kernel 3 (lean) "
            f"{1e3 * k3b[0] / SCENE_STEPS:.2f}, kernel 2 "
            f"{1e3 * k2b[0] / NEW_DEPTH:.2f}, kernel 5 "
            f"{1e3 * k5b[0] / NEW_DEPTH:.2f} us/step (ring-down sims)")
        log(f"[2-4] {label}: the switches {time.perf_counter() - t0:.1f} s "
            "from the scene's start")
    return per


def poke_scene(torch, dev):
    """The animated-target scene: the bench cloth (:func:`bench_scene`) with
    the poke of scripts/bench_poke.py on its vertex nearest the centroid
    (POKE_CYCLES z-motion cycles of POKE_CYCLE frames, POKE_Z deep, wi =
    POKE_WI), the bench damping doubled, at the bench's widths -> (model,
    solver, the poke's shift)."""
    from animsnapbases_tpu_torch.demos.poke import (
        create_poke_z_motion_with_jumps,
    )
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    model = bench_scene(DeformableModel, cloth_model)
    shift = create_poke_z_motion_with_jumps(*POKE_CYCLE, POKE_CYCLES,
                                            z_range=POKE_Z)
    vi = int(np.argmin(np.linalg.norm(
        model.positions - model.positions.mean(axis=0), axis=1)))
    require(not model.fixed_flags[vi], "the poked vertex is pinned")
    model.add_positional_constraint(vi, wi=POKE_WI,
                                    motion_type="user_defined",
                                    frame_shift=shift)
    solver = scene_solver(synthetic_reduced_solver, model, K=40, r=64,
                          damping=2 * BENCH_DAMPING, device=dev,
                          dtype=torch.float32, matmul_dtype=torch.bfloat16)
    return model, solver, shift


def aim_poke(solver, model, positions):
    """Move the poke's rest target to the poked vertex of ``positions``
    (the model's state becomes ``positions``, at rest) and prepare again,
    so that the prepared schedule pokes around where the vertex is, as a
    scene that moves its cloth moves its targets.  The vertex and its
    weight stay, so the matrices do too: prepare() rebuilds the schedule
    only."""
    model.positions = positions.copy()
    model.velocities = np.zeros_like(positions)
    model._rebuild_positional()
    solver.prepare(solver.args)


def per_sim_timelines(base, shift, rows, amp_step, phase_step):
    """(B, rows, e, 3) targets of B sims from their rest targets ``base``
    (B, e, 3), sim b's poke shift scaled by (1 - amp_step b) and delayed by
    phase_step b frames, from frame 0."""
    frames = np.arange(rows)
    out = np.repeat(np.asarray(base, dtype=float)[:, None], rows, axis=1)
    for b in range(len(out)):
        sh = np.roll(shift, phase_step * b, axis=0) * (1.0 - amp_step * b)
        out[b, :, 0] += sh[np.minimum(frames, len(sh) - 1)]
    return out


def in_turns(torch, calls, rounds):
    """{name: median ms} of each call of ``calls`` ({name: fn}), timed in
    turns (every call once per round, between two CUDA events), so that
    the card's state is shared by all of them."""
    for fn in calls.values():
        fn()
    times = {name: [] for name in calls}
    for _ in range(rounds):
        for name, fn in calls.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            fn()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b))
    return {name: statistics.median(t) for name, t in times.items()}


def animated(torch, counted, paths, main_state, dev):
    """Animated positional targets (the target-term schedule, T > 1) on the
    poke scene (:func:`poke_scene`): the paths (2) of run_steps on the
    default tiers (a poke window across a kernel-5 chunk and past the
    schedule's end; the cloth from rest under gravity, tier 1 certifying
    the window; the contact scene, the poke aimed at it, where kernel 5
    hands over to kernel 3' across the schedule's end), the same with
    resident_chunked_tier1=False and resident_contact_mode=False (kernels
    4 and 3) and with CHUNKED_TIER1_MIN_VERTS=0 (kernels 5 and 2);
    make_batched_run at MIXED sims with per-sim timelines (each sim poked
    around its own start) on batched 3', batched 3 lean and batched 5 and
    2; a shared timeline at POKE_SHARED sims; and run_steps(record=True).  Holds (3): each kernel against its plain
    version step by step with a schedule that ends inside the window
    (one-step calls, the steps one call carries, and one call equal to the
    one-step calls bit for bit, which holds the row each step reads); each
    batched sim against the solo kernel from its own schedule bit for bit;
    the recorded trajectory against a step() loop bit for bit.  Times (4):
    each kernel per step with the schedule and with a static term, in
    turns, beside its bound counting the schedule's bytes.  Returns
    {kernel name: its animated entry}."""
    from animsnapbases_tpu_torch.ops.affine import (
        FLAG_SLOTS,
        _launch_affine,
        affine_plan,
        resident_affine,
        resident_affine_batched,
        resident_affine_contact,
        resident_affine_contact_batched,
        resident_affine_contact_plain,
        resident_affine_exit,
        resident_affine_exit_plain,
        resident_affine_plain,
    )
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        _chunk_launch,
        affine_chunked,
        affine_chunked_batched,
        affine_chunked_plain,
        chunk_anchors,
    )
    from animsnapbases_tpu_torch.ops.fused_reduced import gather_vc
    from animsnapbases_tpu_torch.ops.resident import (
        force_term,
        project,
        rb_from,
        resident_multistep,
        resident_multistep_batched,
        resident_multistep_plain,
    )

    t_start = time.perf_counter()
    model, solver, shift = poke_scene(torch, dev)
    T = len(shift)
    vi = model._positional[0]["vi"]
    ro, ao = solver._resident, solver._affine
    r = ro.fused.r
    sched = solver._rb_sched
    require(sched is not None and tuple(sched.shape) == (T, 3, r),
            "the poke scene's schedule was not prepared")
    log(f"[2] animated targets: the bench cloth with a poke of {T} frames "
        f"(wi {POKE_WI:g}, z {POKE_Z}), schedule {tuple(sched.shape)} "
        f"{sched.dtype} on the card, prepared in "
        f"{time.perf_counter() - t_start:.1f} s")
    rest = (model.positions.copy(), np.zeros_like(model.positions))
    f = gravity(model)
    f0 = np.zeros_like(f)

    # ---- 2. the paths --------------------------------------------------
    model.positions, model.velocities = (x.copy() for x in rest)
    solver.frame = 0
    label = (f"animated targets, run_steps({POKE_WINDOW}) poke window, "
             "default tiers")
    paths[label] = counted_path(
        torch, counted, label, {"affine_chunked"},
        lambda: solver.run_steps(f0, POKE_WINDOW, num_iterations=ITERATIONS))
    dz = float(np.abs(model.positions - rest[0]).max())
    require(solver._last_fast_steps == POKE_WINDOW
            and solver.frame == POKE_WINDOW and np.isfinite(
                model.positions).all() and dz > 0,
            f"{label}: tier 1 did not certify the window, or the poke moved "
            f"nothing (max |dP| {dz:.3e})")
    log(f"[2] {label}: certified across {POKE_WINDOW // CHUNK_EVERY} "
        f"chunks, {POKE_WINDOW - T} steps past the schedule's end; max |dP| "
        f"from rest {dz:.4e}")
    # the tiers on the poke scene, from POKE_TAIL + SCENE_STEPS frames
    # before the schedule's end: from rest under gravity (tier 1 serves and
    # certifies the window), then the contact scene with the poke aimed at
    # it (tier 1 exits and the contact tier finishes, across the end)
    default_min = type(solver).CHUNKED_TIER1_MIN_VERTS
    tiers = (("default tiers", {"resident_chunked_tier1": None,
                                "resident_contact_mode": None,
                                "CHUNKED_TIER1_MIN_VERTS": default_min},
              "affine_chunked", "resident_affine_contact"),
             ("resident_chunked_tier1=False, resident_contact_mode=False",
              {"resident_chunked_tier1": False,
               "resident_contact_mode": False,
               "CHUNKED_TIER1_MIN_VERTS": default_min},
              "resident_affine_exit", "resident_affine"),
             ("CHUNKED_TIER1_MIN_VERTS=0",
              {"resident_chunked_tier1": True, "resident_contact_mode": False,
               "CHUNKED_TIER1_MIN_VERTS": 0},
              "affine_chunked", "resident_multistep"))
    contact_in = contact_state(model)
    for aim, state, scene in ((rest[0], rest, "window"),
                              (contact_in[0], contact_in, "contact scene")):
        aim_poke(solver, model, aim)
        for tier_label, switches, tier1, tier2 in tiers:
            reprepare(solver, **switches)
            calls = spy_tier1(solver)
            model.positions, model.velocities = (x.copy() for x in state)
            solver.frame = T - POKE_TAIL - (SCENE_STEPS if scene == "window"
                                            else 0)
            frame = solver.frame
            lbl = f"animated targets, {tier_label}, {scene}"
            paths[lbl] = counted_path(
                torch, counted, lbl,
                {tier1} if scene == "window" else {tier1, tier2},
                lambda: solver.run_steps(f, SCENE_STEPS,
                                         num_iterations=ITERATIONS))
            k = calls[0] if calls else 0
            ok = (calls == [SCENE_STEPS] and solver._last_fast_steps
                  == SCENE_STEPS) if scene == "window" else (
                0 < k < SCENE_STEPS and solver._last_fast_steps is None)
            require(ok and solver.frame == frame + SCENE_STEPS
                    and np.isfinite(model.positions).all()
                    and model.positions[:, 1].min() > -0.5,
                    f"{lbl}: tier-1 calls {calls}, certificate "
                    f"{solver._last_fast_steps}, or the state is not finite "
                    "and held at the floor")
            log(f"[2] {lbl}: frames {frame}..{solver.frame - 1} (the "
                f"schedule ends at {T}): tier 1 served {sum(calls)} steps "
                f"(calls {calls}), the contact tier "
                f"{SCENE_STEPS - sum(calls)}; end y in "
                f"[{model.positions[:, 1].min():.4f}, "
                f"{model.positions[:, 1].max():.4f}]")
    sched_contact = solver._rb_sched.clone()
    aim_poke(solver, model, rest[0])
    reprepare(solver, CHUNKED_TIER1_MIN_VERTS=default_min,
              resident_contact_mode=None, resident_chunked_tier1=None)
    sched = solver._rb_sched

    # make_batched_run with per-sim timelines on the mixed batch
    mixed = mixed_state(model, main_state, f)
    contact = contact_sims()
    ring = [b for b in range(MIXED) if b not in contact]
    # each sim poked around its own start (per-sim targets), the shared
    # timeline around the main path's end
    tl_sims = per_sim_timelines(mixed[0][:, [vi]], shift, POKE_ROWS, 0.04,
                                5)
    shared = ensemble_state(main_state, POKE_SHARED)
    tl_shared = per_sim_timelines(shared[0][:1, [vi]], shift, POKE_ROWS,
                                  0.0, 0)[0]
    out = {}

    def batched_path(route, own, batch, tl, expect):
        lbl = (f"animated targets, make_batched_run, B={len(batch[0])}, "
               f"{'per-sim' if tl.ndim == 4 else 'shared'} timeline, "
               f"{route}")
        run = solver.make_batched_run()
        paths[lbl] = counted_path(torch, counted, lbl, own, lambda: out.update(
            {lbl: run(*batch, SCENE_STEPS, num_iterations=ITERATIONS,
                      targets_seq=tl)}))
        p, v = out[lbl]
        route_taken = solver._last_batched_path
        require(route_taken.startswith(expect) and np.isfinite(p).all()
                and np.isfinite(v).all() and float(p[..., 1].min()) > -0.5,
                f"{lbl}: took {route_taken}, or its end state is not finite "
                "and held at the floor")
        log(f"[2] {lbl}: {route_taken}, {SCENE_STEPS} steps over a "
            f"{tl.shape[-3]}-row timeline; end y in "
            f"[{float(p[..., 1].min()):.4f}, {float(p[..., 1].max()):.4f}]")
        return lbl, p

    lbl_3c, p_3c = batched_path("default (contact mode)",
                                {"resident_affine_contact_batched"}, mixed,
                                tl_sims, "batched-resident")
    require(float(p_3c[ring, :, 1].min()) > model.floor_height,
            "a ring-down sim of the poked mixed batch reached the floor")
    batched_path("default (contact mode)",
                 {"resident_affine_contact_batched"}, shared, tl_shared,
                 "batched-resident")
    reprepare(solver, resident_contact_mode=False)
    lbl_3, _ = batched_path("resident_contact_mode=False (lean)",
                            {"resident_affine_batched"}, mixed, tl_sims,
                            "batched-resident")
    reprepare(solver, CHUNKED_TIER1_MIN_VERTS=0,
              resident_rebase_every=MIXED_EVERY)
    lbl_52, _ = batched_path(
        "CHUNKED_TIER1_MIN_VERTS=0",
        {"affine_chunked_batched", "resident_multistep_batched"}, mixed,
        tl_sims, "batched-chunked+perstep[")
    windows = int(solver._last_batched_path.split("[")[1].rstrip("w]"))
    require(windows >= 2, f"{lbl_52}: {windows} kernel-2 window(s), not "
            "kernel 5 -> kernel 2 -> kernel 5 -> kernel 2")
    reprepare(solver, CHUNKED_TIER1_MIN_VERTS=default_min,
              resident_rebase_every=None, resident_contact_mode=None)

    # run_steps(record=True) from the rest state under gravity, across the
    # schedule's end, then the same steps as a step() loop
    model.positions, model.velocities = (x.copy() for x in rest)
    start = T - POKE_TAIL
    solver.frame = start
    lbl_rec = f"animated targets, run_steps({SCENE_STEPS}, record=True)"

    def record():
        t0 = time.perf_counter()
        out[lbl_rec] = solver.run_steps(f, SCENE_STEPS,
                                        num_iterations=ITERATIONS,
                                        record=True)
        out[lbl_rec + " s"] = time.perf_counter() - t0

    paths[lbl_rec] = counted_path(torch, counted, lbl_rec,
                                  {"fused_reduced_iterations"}, record)
    traj = out[lbl_rec]
    end = (model.positions.copy(), model.velocities.copy())
    require(traj.shape == (SCENE_STEPS, ro.n, 3) and np.isfinite(traj).all()
            and np.array_equal(traj[-1], end[0])
            and solver.frame == start + SCENE_STEPS,
            f"{lbl_rec}: trajectory {traj.shape} not finite or not ending at "
            "the state")
    model.positions, model.velocities = (x.copy() for x in rest)
    solver.frame = start
    loop_diff = 0.0
    for i in range(SCENE_STEPS):
        solver.step(f, num_iterations=ITERATIONS)
        loop_diff = max(loop_diff, float(np.abs(model.positions
                                                - traj[i]).max()))
    require(loop_diff == 0.0 and np.array_equal(model.velocities, end[1]),
            f"{lbl_rec}: the trajectory differs from a step() loop by "
            f"{loop_diff:.3e}")
    log(f"[3] {lbl_rec}: frames {start}..{start + SCENE_STEPS - 1} "
        f"(the schedule ends at {T}) in {out[lbl_rec + ' s']:.3f} s (host "
        "transfers included), the trajectory equals a step() loop bit for "
        "bit")

    # ---- 3. holds ------------------------------------------------------
    # a schedule that ends inside the windows: POKE_DEPTH / 2 rows of the
    # poke's first ramp (every row differs), the window POKE_DEPTH steps;
    # on the contact scene the rows of the poke aimed at it.  As on the
    # static scenes, kernels 4, 5 and both builds of 3 are held step by
    # step on contact-free steps (the poke window) and kernel 2 on the
    # cloth falling under gravity; on the contact scene, where two float32
    # orders of the loop's clamps part, by the rows they read (a call
    # equal to its one-step calls) and contact mode's carried steps
    rows = POKE_DEPTH // 2
    rb_h = sched[POKE_RAMP:POKE_RAMP + rows].clone()
    rb_hc = sched_contact[POKE_RAMP:POKE_RAMP + rows].clone()
    Pw, Vw = (solver._to_device(x) for x in rest)
    F0 = torch.zeros_like(Pw)
    Fx = solver._to_device(f)
    Pc, Vc = (solver._to_device(x) for x in contact_state(model))
    anim_err = {}

    def onestep(fn, F_, rb):
        """One-step calls of ``fn``, the n-th with the schedule ``rb`` from
        its step n on; a tier-1 call must do its step."""
        n = [0]

        def run(P_, V_):
            out_ = fn(ao, P_, V_, F_, rb_from(rb, n[0]), 1, ITERATIONS)
            require(len(out_) == 2 or out_[2] == 1,
                    f"{fn.__name__} stopped on a contact-free step")
            n[0] += 1
            return out_[:2]
        return run

    def on_res(fn):
        def call(a, *x, **kw):
            return fn(a.res, *x, **kw)
        call.__name__ = fn.__name__
        return call

    for name, fn, plain, P0, V0, F_, rb in (
            ("kernel 2", on_res(resident_multistep),
             on_res(resident_multistep_plain), Pw, Vw, Fx, rb_h),
            ("kernel 5", affine_chunked, affine_chunked_plain, Pw, Vw, F0,
             rb_h),
            ("kernel 4", resident_affine_exit, resident_affine_exit_plain,
             Pw, Vw, F0, rb_h),
            ("kernel 3", resident_affine, resident_affine_plain, Pw, Vw, F0,
             rb_h),
            ("kernel 3 (contact mode)", resident_affine_contact,
             resident_affine_contact_plain, Pw, Vw, F0, rb_h)):
        err, (Pi, Vi) = step_by_step(
            torch, f"animated {name}, schedule of {rows} rows", ro,
            onestep(fn, F_, rb), onestep(plain, F_, rb), P0, V0, F_, rb[0],
            POKE_DEPTH)
        kw = {} if name == "kernel 2" else {"rebase_every": 1}
        same_as_steps(torch, f"animated {name} ({POKE_DEPTH}-step call"
                      f"{'' if name == 'kernel 2' else ', rebase_every=1'})",
                      lambda P_, V_: fn(ao, P_, V_, F_, rb, POKE_DEPTH,
                                        ITERATIONS, **kw),
                      P0, V0, Pi, Vi, POKE_DEPTH)
        anim_err[name] = err
    # kernels 2 and 3 (both builds) on the contact scene: the lean contact
    # tail and a contact-mode step (entered at every step here) read their
    # rows too
    for name, fn in (("kernel 2", on_res(resident_multistep)),
                     ("kernel 3", resident_affine),
                     ("kernel 3 (contact mode)", resident_affine_contact)):
        Pi, Vi = Pc, Vc
        for i in range(POKE_DEPTH):
            Pi, Vi = fn(ao, Pi, Vi, Fx, rb_from(rb_hc, i), 1, ITERATIONS)
        kw = {} if name == "kernel 2" else {"rebase_every": 1}
        same_as_steps(torch, f"animated {name} (contact scene, "
                      f"{POKE_DEPTH}-step call"
                      f"{'' if name == 'kernel 2' else ', rebase_every=1'})",
                      lambda P_, V_, fn=fn, kw=kw: fn(ao, P_, V_, Fx, rb_hc,
                                                      POKE_DEPTH, ITERATIONS,
                                                      **kw),
                      Pc, Vc, Pi, Vi, POKE_DEPTH)
    # the steps one call carries, each step with its own row: on the poke
    # window, and in contact mode on the contact scene over SCENE_STEPS
    # steps with the rows of the poke's first SCENE_STEPS / 2 frames (its
    # branch steps are held by their median, as on the static contact
    # scene)
    rb_c = sched_contact[:SCENE_STEPS // 2].clone()
    for kernel, every, P0, V0, F_, rb, depth, scene in (
            (5, CHUNK_EVERY, Pw, Vw, F0, rb_h, POKE_DEPTH, "poke window"),
            (4, REBASE_EVERY, Pw, Vw, F0, rb_h, POKE_DEPTH, "poke window"),
            (3, REBASE_EVERY, Pw, Vw, F0, rb_h, POKE_DEPTH, "poke window"),
            ("3c", REBASE_EVERY, Pw, Vw, F0, rb_h, POKE_DEPTH,
             "poke window"),
            ("3c", 3, Pc, Vc, Fx, rb_c, SCENE_STEPS,
             "contact scene, rebase_every=3")):
        name = ("kernel 3 (contact mode)" if kernel == "3c"
                else f"kernel {kernel}")
        plain = {5: affine_chunked_plain, 4: resident_affine_exit_plain,
                 3: resident_affine_plain,
                 "3c": resident_affine_contact_plain}[kernel]
        err, _ = carried_steps(
            torch, f"animated {name} ({scene}, schedule of "
            f"{rb.shape[0]} rows), carried steps", kernel, ao,
            lambda *a, plain=plain, every=every: plain(
                *a, rebase_every=every), P0, V0, F_, rb, depth, every)
        anim_err[name] = max(anim_err[name], err)

    # batched kernels on the mixed batch, a schedule per sim (its rows of
    # the per-sim timelines' first ramp): each sim against the solo kernel
    # from its own schedule, bit for bit; one step against the plain
    # version
    Pm, Vm, Fm = (solver._pack(x) for x in mixed)
    rb_b = solver._rb_timeline(
        tl_sims[:, POKE_RAMP:POKE_RAMP + rows], MIXED)
    require(tuple(rb_b.shape) == (MIXED, rows, 3, r),
            f"per-sim schedule {tuple(rb_b.shape)}")
    same_per_sim(torch, f"animated batched kernel 2, {POKE_DEPTH} steps",
                 resident_multistep_batched(ro, Pm, Vm, Fm, rb_b, POKE_DEPTH,
                                            ITERATIONS),
                 lambda b: resident_multistep(ro, Pm[b], Vm[b], Fm[b],
                                              rb_b[b], POKE_DEPTH,
                                              ITERATIONS), MIXED)
    for variant in ("lean", "contact"):
        def call(P1, V1, F1, rb1, variant=variant):
            o = _launch_affine(ao, P1, V1, F1, rb1, POKE_DEPTH, ITERATIONS,
                               3, variant)
            return o[:3] + (o[4] or ())
        same_per_sim(torch, f"animated batched kernel 3 ({variant}), "
                     f"{POKE_DEPTH} steps, rebase_every=3",
                     call(Pm, Vm, Fm, rb_b),
                     lambda b: call(Pm[b], Vm[b], Fm[b], rb_b[b]), MIXED)
    fa = force_term(ro, Fm)
    bu0, bu1, b0s, b1s = chunk_anchors(ao, Pm, Vm)
    fas, bufa = gather_vc(ro.fused, fa), project(ro, fa)
    ymm, ymm1 = (torch.empty(MIXED, 6, device=dev) for _ in range(2))
    chunk_in = (Pm, Vm, fa, ymm, b0s, b1s, fas, bu0, bu1, bufa)

    def launch(P_, V_, fa_, ymm_, *anchors, rb):
        return _chunk_launch(ao, P_, V_, fa_, ymm_, True, *anchors, rb,
                             POKE_DEPTH, ITERATIONS, ao.floor_level)

    def solo_chunk(b):
        one = [x[b] for x in chunk_in]
        one[3] = ymm1[b]
        return (*launch(*one, rb=rb_b[b]), ymm1[b])

    coef, kb = launch(*chunk_in, rb=rb_b)
    same_per_sim(torch, f"animated batched kernel 5 chunk, {POKE_DEPTH} "
                 "steps", (coef, kb, ymm), solo_chunk, MIXED)
    ks = [affine_chunked(ao, Pm[b], Vm[b], Fm[b], rb_b[b], POKE_DEPTH,
                         ITERATIONS)[2] for b in range(MIXED)]
    k = affine_chunked_batched(ao, Pm, Vm, Fm, rb_b, POKE_DEPTH,
                               ITERATIONS)[2]
    require(k == min(ks), f"animated batched kernel 5's k {k} is not the "
            f"least of the solo k {ks}")
    for name, kernel, plain in (
            ("kernel 2", lambda *a: resident_multistep_batched(ro, *a),
             lambda *a: resident_multistep_plain(ro, *a)),
            ("kernel 3", lambda *a: resident_affine_batched(ao, *a),
             lambda *a: resident_affine_plain(ao, *a)),
            ("kernel 3 (contact mode)",
             lambda *a: resident_affine_contact_batched(ao, *a),
             lambda *a: resident_affine_contact_plain(ao, *a)),
            ("kernel 5", lambda *a: affine_chunked_batched(ao, *a)[:2],
             lambda *a: affine_chunked_plain(ao, *a)[:2])):
        rb1 = rb_from(rb_b, rows // 2)
        Pk, Vk = kernel(Pm, Vm, Fm, rb1, 1, ITERATIONS)
        Pp, Vp = plain(Pm, Vm, Fm, rb1, 1, ITERATIONS)
        for b in range(MIXED):
            hold_step(f"animated batched {name}, sim {b}", step_share(
                ro, fa[b], rb1[b, 0], Pm[b], Vm[b], Pk[b], Vk[b], Pp[b],
                Vp[b]))
        anim_err[f"batched {name}"] = max_abs(Pk, Pp)
    log(f"[3] animated batched kernels 2, 3, 3' and 5: one step from row "
        f"{rows // 2} of each sim's schedule against the batched plain "
        f"version within {STEP_TOL} of each sim's step size; batched "
        f"kernel 5's whole-batch k {k} = min of the solo k {ks}")

    # ---- 4. times: with the schedule and with a static term, in turns --
    # static: the schedule's first row (per sim: a one-row schedule each)
    rb_w = sched[:SCENE_STEPS].contiguous()        # a row per step
    rb_s = rb_w[0]
    rb_wc = sched_contact[:SCENE_STEPS].contiguous()
    Pe, Ve, Fe = (solver._pack(x) for x in ensemble_state(main_state,
                                                           MIXED))
    rb_e = solver._rb_timeline(tl_sims[:, :SCENE_STEPS], MIXED)
    rb_es = rb_e[:, :1]
    sched_bytes = 4 * 3 * r * SCENE_STEPS

    def count_flags(variant):
        fl = _launch_affine(ao, Pm, Vm, Fm, rb_e, SCENE_STEPS, ITERATIONS,
                            REBASE_EVERY, variant)[2][:, FLAG_SLOTS:]
        return fl

    fl_lean, fl_mode = count_flags("lean"), count_flags("contact")
    in_mode = (fl_mode & 2) > 0
    jobs = {
        "affine_chunked": (lambda rb: affine_chunked(
            ao, Pw, Vw, F0, rb, SCENE_STEPS, ITERATIONS), rb_w, rb_s, 1,
            k5_cost(ao, SCENE_STEPS, ITERATIONS, CHUNK_EVERY),
            "poke window"),
        "resident_affine_exit": (lambda rb: resident_affine_exit(
            ao, Pw, Vw, F0, rb, SCENE_STEPS, ITERATIONS), rb_w, rb_s, 1,
            k3_cost(ao, SCENE_STEPS, ITERATIONS, REBASE_EVERY, 0),
            "poke window"),
        "resident_affine": (lambda rb: resident_affine(
            ao, Pw, Vw, F0, rb, SCENE_STEPS, ITERATIONS), rb_w, rb_s, 1,
            k3_cost(ao, SCENE_STEPS, ITERATIONS, REBASE_EVERY, 0),
            "poke window"),
        "resident_affine_contact": (lambda rb: resident_affine_contact(
            ao, Pw, Vw, F0, rb, SCENE_STEPS, ITERATIONS), rb_w, rb_s, 1,
            k3m_cost(ao, SCENE_STEPS, ITERATIONS, REBASE_EVERY, 0, 0, 0),
            "poke window"),
        "resident_multistep": (lambda rb: resident_multistep(
            ro, Pc, Vc, Fx, rb, SCENE_STEPS, ITERATIONS), rb_wc, rb_wc[0], 1,
            k2_cost(ro, SCENE_STEPS, ITERATIONS), "contact scene"),
        "resident_affine_batched": (lambda rb: resident_affine_batched(
            ao, Pm, Vm, Fm, rb, SCENE_STEPS, ITERATIONS), rb_e, rb_es, MIXED,
            k3_cost(ao, SCENE_STEPS, ITERATIONS, REBASE_EVERY,
                    int((fl_lean & 1).sum()), nb=MIXED), "mixed batch"),
        "resident_affine_contact_batched": (
            lambda rb: resident_affine_contact_batched(
                ao, Pm, Vm, Fm, rb, SCENE_STEPS, ITERATIONS), rb_e, rb_es,
            MIXED, k3m_cost(ao, SCENE_STEPS, ITERATIONS, REBASE_EVERY,
                            int(in_mode.sum()), int(in_mode.any(0).sum()),
                            int((fl_mode & 1).sum()), nb=MIXED),
            "mixed batch"),
        "resident_multistep_batched": (
            lambda rb: resident_multistep_batched(
                ro, Pm, Vm, Fm, rb, SCENE_STEPS, ITERATIONS), rb_e, rb_es,
            MIXED, k2_cost(ro, SCENE_STEPS, ITERATIONS, MIXED),
            "mixed batch"),
        "affine_chunked_batched": (lambda rb: affine_chunked_batched(
            ao, Pe, Ve, torch.zeros_like(Pe), rb, SCENE_STEPS, ITERATIONS),
            rb_e, rb_es, MIXED, k5_cost(ao, SCENE_STEPS, ITERATIONS,
                                       CHUNK_EVERY, MIXED),
            f"ring-down ensemble of {MIXED}"),
    }
    require(affine_chunked(ao, Pw, Vw, F0, rb_w, SCENE_STEPS,
                           ITERATIONS)[2] == SCENE_STEPS
            and affine_chunked_batched(ao, Pe, Ve, torch.zeros_like(Pe),
                                       rb_e, SCENE_STEPS,
                                       ITERATIONS)[2] == SCENE_STEPS,
            "the timed tier-1 windows of the poke scene are not "
            "contact-free")
    result = {}
    launch_of = {
        "affine_chunked": paths[label],
        "resident_affine_contact": paths[
            "animated targets, default tiers, contact scene"],
        "resident_affine_exit": paths[
            "animated targets, resident_chunked_tier1=False, "
            "resident_contact_mode=False, contact scene"],
        "resident_affine": paths[
            "animated targets, resident_chunked_tier1=False, "
            "resident_contact_mode=False, contact scene"],
        "resident_multistep": paths[
            "animated targets, CHUNKED_TIER1_MIN_VERTS=0, contact scene"],
        "resident_affine_contact_batched": paths[lbl_3c],
        "resident_affine_batched": paths[lbl_3],
        "resident_multistep_batched": paths[lbl_52],
        "affine_chunked_batched": paths[lbl_52],
        "fused_reduced_iterations": paths[lbl_rec],
    }
    errs = {"affine_chunked": "kernel 5", "resident_affine_exit": "kernel 4",
            "resident_affine": "kernel 3",
            "resident_affine_contact": "kernel 3 (contact mode)",
            "resident_multistep": "kernel 2",
            "resident_affine_batched": "batched kernel 3",
            "resident_affine_contact_batched":
                "batched kernel 3 (contact mode)",
            "resident_multistep_batched": "batched kernel 2",
            "affine_chunked_batched": "batched kernel 5"}
    for name, (fn, rb_a, rb_0, nb, cost, scene) in jobs.items():
        ms = in_turns(torch, {"animated": lambda fn=fn, rb=rb_a: fn(rb),
                              "static": lambda fn=fn, rb=rb_0: fn(rb)},
                      POKE_ROUNDS)
        nbytes, ops = cost
        b_anim, by_anim = bound_ms(nbytes + nb * sched_bytes, ops)
        b_stat, by_stat = bound_ms(nbytes + nb * 4 * 3 * r, ops)
        result[name] = {
            "scene": scene, "sims": nb, "steps_per_call": SCENE_STEPS,
            "schedule_rows": int(rb_a.shape[-3]),
            "launches": launch_of[name][name],
            "max_abs_err": anim_err[errs[name]],
            "ms": ms["animated"], "static_ms": ms["static"],
            "bound_ms": b_anim, "bound_by": by_anim,
            "static_bound_ms": b_stat, "static_bound_by": by_stat}
        log(f"[4] animated {name} ({scene}, {nb} sim(s), {SCENE_STEPS} "
            f"steps, a schedule row per step): "
            f"{1e3 * ms['animated'] / SCENE_STEPS:.2f} us/step, static "
            f"{1e3 * ms['static'] / SCENE_STEPS:.2f} us/step (in turns, "
            f"median of {POKE_ROUNDS}); bound "
            f"{1e3 * b_anim / SCENE_STEPS:.4f} us/step ({by_anim}), static "
            f"{1e3 * b_stat / SCENE_STEPS:.4f}")
    result["fused_reduced_iterations"] = {
        "scene": "run_steps(record=True)", "steps_per_call": SCENE_STEPS,
        "launches": launch_of["fused_reduced_iterations"][
            "fused_reduced_iterations"],
        "entry_steps_per_s": SCENE_STEPS / out[lbl_rec + " s"]}
    log(f"[2-4] animated targets {time.perf_counter() - t_start:.1f} s")
    return result


def near_in_turns(torch, solver, model, state, f, steps):
    """{build: median ms} of ``run_steps(f, steps)`` from ``state`` on kernel
    5's exact and exact-free builds as tier 1, in turns (MEGA_ROUNDS rounds;
    the builds' tiers made once, swapped between the calls).  Leaves the
    solver's tiers as it found them."""
    before = getattr(solver, "resident_floor_exact", None)
    fast = {}
    for key, fe in (("exact", True), ("exact-free", False)):
        retier(solver, resident_floor_exact=fe)
        fast[key] = solver._resident_fast

    def run(key):
        def go():
            solver._resident_fast = fast[key]
            model.positions, model.velocities = (x.copy() for x in state)
            solver.run_steps(f, steps, num_iterations=ITERATIONS)
        return go

    t = in_turns(torch, {k: run(k) for k in fast}, MEGA_ROUNDS)
    retier(solver, resident_floor_exact=before)
    return t


def chunk_entry(paths, launch_path, name, options, lines, err, ms,
                plain_ms, bound, by, **extra):
    """A kernels-line entry of one build of kernel 5 (``name`` its launch
    counter's name)."""
    from animsnapbases_tpu_torch.ops.affine_chunked import library

    return {"name": name, "route": "cuda",
            "source": f"animsnapbases_tpu_torch/csrc/{library(options)}.cu",
            "replaces": "animsnapbases_tpu/ops/pallas_resident.py:1145",
            "replaces_lines": lines,
            "launches": paths[launch_path[name]][name],
            "launches_path": launch_path[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, **extra}


def chunk_options(torch, counted, paths, solver, model, f, rest, main_state):
    """Kernel 5's other builds on the bench scene.  First every build a
    caller can reach (20 option sets): on the floor-clear tier-1 window a
    64-step call equal bit for bit to the build of its fold_vc with the
    other options on; on the contact scene the plain version's k and its
    committed state within STEP_TOL of its change.  Then each build of
    OPTION_BUILDS (the exact-free build; the bound, fold_vc, sqrt_free_bound
    or static_rb off), solo and batched at NEW_BATCH sims.  Paths (2):
    run_steps on the tiers with the build's switches (the bench window,
    which tier 1 certifies, and the contact scene, where it exits to kernel
    3's contact-mode build; the exact-free build may re-enter after a
    rebase), and make_batched_run on NEW_BATCH ring-down sims with
    CHUNKED_TIER1_MIN_VERTS = 0, each a counted path.  Holds (3): the
    carried steps over the tier-1 window against the plain version
    (:func:`carried_steps`), the contact scene as above, the batched chunk
    launch equal bit for bit per sim to the solo launch, one batched step
    within STEP_TOL of the batched plain version's per sim.  Times (4):
    64-step calls of the build and of the default build in turns, solo and
    batched (the bound off gives the exact check's cost per step), and for
    the exact-free build run_steps on the contact scene in turns with the
    exact build.  Returns the kernels line's entries, solo and batched per
    build, and the exact check's us per step."""
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        BUILDS,
        ChunkOptions,
        _chunk_launch,
        affine_chunked,
        affine_chunked_batched,
        affine_chunked_plain,
        chunk_anchors,
        counter,
        fill_ymm,
    )
    from animsnapbases_tpu_torch.ops.fused_reduced import gather_vc
    from animsnapbases_tpu_torch.ops.resident import force_term, project

    ro, ao = solver._resident, solver._affine
    rb = solver._rb_extra()
    default_min = type(solver).CHUNKED_TIER1_MIN_VERTS
    P0, V0 = main_state
    Pw, Vw = solver._to_device(P0), 0.1 * solver._to_device(V0)
    F0 = torch.zeros_like(Pw)
    Pc, Vc = (solver._to_device(x) for x in contact_state(model))
    Fx = solver._to_device(f)
    ens = ensemble_state(main_state, NEW_BATCH)
    Pe, Ve, Fe = (solver._pack(x) for x in ens)
    fa_e = force_term(ro, Fe)
    base = affine_chunked(ao, Pw, Vw, F0, rb, SCENE_STEPS, ITERATIONS)
    require(base[2] == SCENE_STEPS, "the default build stopped in the "
            "tier-1 window")
    # every build a caller can reach (ops/affine_chunked.py BUILDS): on the
    # floor-clear tier-1 window equal bit for bit to the build of its
    # fold_vc with the other options on; on the contact scene the plain
    # version's k and its committed state within STEP_TOL
    nofold = affine_chunked(ao, Pw, Vw, F0, rb, SCENE_STEPS, ITERATIONS,
                            options=ChunkOptions(fold_vc=False))
    for o in BUILDS:
        Pk, Vk, kk = affine_chunked(ao, Pw, Vw, F0, rb, SCENE_STEPS,
                                    ITERATIONS, options=o)
        ref = base if o.fold_vc else nofold
        require(kk == SCENE_STEPS and torch.equal(Pk, ref[0])
                and torch.equal(Vk, ref[1]),
                f"kernel 5 ({o.label or 'default'}) differs on the tier-1 "
                f"window from the build of its fold_vc ({kk} steps)")
        Pk, Vk, kk = affine_chunked(ao, Pc, Vc, Fx, rb, SCENE_STEPS,
                                    ITERATIONS, rebase_every=16, options=o)
        Pp, Vp, kp = affine_chunked_plain(ao, Pc, Vc, Fx, rb, SCENE_STEPS,
                                          ITERATIONS, rebase_every=16,
                                          options=o)
        require(kk == kp and max_abs(Pk, Pp) <= STEP_TOL * max_abs(Pp, Pc)
                and max_abs(Vk, Vp) <= STEP_TOL * max_abs(Vp, Vc),
                f"kernel 5 ({o.label or 'default'}) on the contact scene: "
                f"k {kk} against the plain {kp}, or its state differs")
    log(f"[3] kernel 5, all {len(BUILDS)} builds (bfloat16 storage): each "
        f"equal bit for bit on the tier-1 window's {SCENE_STEPS}-step call "
        f"to the build of its fold_vc with the other options on; on the "
        f"contact scene the plain version's k and its committed state within "
        f"{STEP_TOL} of its change")
    entries, launch_path, exact_us = [], {}, None
    for name, opts, lines in OPTION_BUILDS:
        o = ChunkOptions(**opts)
        solo, batched = counter(o, False).__name__, counter(o, True).__name__
        label = f"kernel 5, {name} ({o.label})"
        # ---- 2. paths ----------------------------------------------------
        reprepare(solver, CHUNKED_TIER1_MIN_VERTS=default_min,
                  resident_contact_mode=None, **build_switches(opts))
        require(solver._chunk_opts == o, f"{label}: the solver built "
                f"{solver._chunk_opts}")
        for run, counts in tiered_runs(
                torch, counted, solver, model, f, rest, o.label, solo,
                "resident_affine_contact",
                recursions=not o.floor_exact).items():
            paths[f"{o.label}, {run}"] = counts
        launch_path[solo] = f"{o.label}, bench window"
        if not o.floor_exact:
            # the contact scene through run_steps on the two builds in
            # turns: tier 1, its exit, the contact tier
            t_near = near_in_turns(torch, solver, model, contact_state(model),
                                   f, SCENE_STEPS)
            log(f"[4] {label}: run_steps({SCENE_STEPS}) on the contact scene "
                f"in turns ({MEGA_ROUNDS} rounds, median): " + ", ".join(
                    f"{k} {v:.2f} ms" for k, v in t_near.items()))
        reprepare(solver, CHUNKED_TIER1_MIN_VERTS=0)
        runner = solver.make_batched_run()
        lbl_b = (f"make_batched_run, B={NEW_BATCH} ring-down, {o.label}, "
                 "CHUNKED_TIER1_MIN_VERTS=0")
        paths[lbl_b] = counted_path(
            torch, counted, lbl_b, {batched},
            lambda: runner(*ens, SCENE_STEPS, num_iterations=ITERATIONS))
        require(solver._last_batched_path == "batched-chunked",
                f"{lbl_b}: took {solver._last_batched_path}")
        launch_path[batched] = lbl_b

        # ---- 3. holds ----------------------------------------------------
        err, _ = carried_steps(
            torch, f"{label} (window scene), carried steps", 5, ao,
            lambda *a: affine_chunked_plain(*a, rebase_every=CHUNK_EVERY,
                                            options=o),
            Pw, Vw, F0, rb, SCENE_STEPS, CHUNK_EVERY, options=o)
        Pk, Vk, kk = affine_chunked(ao, Pw, Vw, F0, rb, SCENE_STEPS,
                                    ITERATIONS, options=o)
        require(kk == SCENE_STEPS, f"{label}: stopped in the tier-1 window "
                f"after {kk} steps")
        same = bool(torch.equal(Pk, base[0]) and torch.equal(Vk, base[1]))
        if o.fold_vc:
            require(same, f"{label}: differs from the default build on the "
                    "floor-clear tier-1 window")
        Pk, Vk, kk = affine_chunked(ao, Pc, Vc, Fx, rb, SCENE_STEPS,
                                    ITERATIONS, rebase_every=16, options=o)
        Pp, Vp, kp = affine_chunked_plain(ao, Pc, Vc, Fx, rb, SCENE_STEPS,
                                          ITERATIONS, rebase_every=16,
                                          options=o)
        dP, dV = max_abs(Pk, Pp), max_abs(Vk, Vp)
        sP, sV = max_abs(Pp, Pc), max_abs(Vp, Vc)
        require(kk == kp and 0 < kk < SCENE_STEPS,
                f"{label}: steps done on the contact scene, kernel {kk}, "
                f"plain {kp}")
        require(dP <= STEP_TOL * sP and dV <= STEP_TOL * sV,
                f"{label}: committed contact-scene state differs (P {dP:.3e} "
                f"of {sP:.3e}, V {dV:.3e} of {sV:.3e})")
        err = max(err, dP, dV)
        # the batched chunk launch against the solo launch per sim
        bu0, bu1, b0s, b1s = chunk_anchors(ao, Pe, Ve, o.fold_vc)
        fas = gather_vc(ro.fused, fa_e) if o.fold_vc else None
        ymm = torch.empty(NEW_BATCH, 6, device=Pe.device)
        if not o.floor_exact:
            fill_ymm(ymm, Pe, Ve, fa_e, True)
        ymm1 = ymm.clone()
        chunk_in = (Pe, Ve, fa_e, ymm, b0s, b1s, fas, bu0, bu1,
                    project(ro, fa_e))

        def launch(P_, V_, fa_, ymm_, *anchors):
            return _chunk_launch(ao, P_, V_, fa_, ymm_, True, *anchors, rb,
                                 SCENE_STEPS, ITERATIONS, ao.floor_level, o)

        def solo_chunk(b):
            one = [None if x is None else x[b] for x in chunk_in]
            one[3] = ymm1[b]
            return (*launch(*one), ymm1[b])

        coef, kb = launch(*chunk_in)
        same_per_sim(torch, f"batched {label} chunk, ring-down B={NEW_BATCH}"
                     f", {SCENE_STEPS} steps", (coef, kb, ymm), solo_chunk,
                     NEW_BATCH)
        require(min(kb.tolist()) == SCENE_STEPS, f"batched {label} stopped "
                f"in the ring-down window (k_b {kb.tolist()})")
        Pk, Vk, _ = affine_chunked_batched(ao, Pe, Ve, Fe, rb, 1, ITERATIONS,
                                           options=o)
        Pp, Vp, _ = affine_chunked_plain(ao, Pe, Ve, Fe, rb, 1, ITERATIONS,
                                         options=o)
        err_b = 0.0
        for b in range(NEW_BATCH):
            shares = step_share(ro, fa_e[b], rb, Pe[b], Ve[b], Pk[b], Vk[b],
                                Pp[b], Vp[b])
            hold_step(f"batched {label}, sim {b}", shares)
            err_b = max(err_b, *(d for d, _ in shares.values()))
        log(f"[3] {label}: the tier-1 window's {SCENE_STEPS}-step call "
            f"{'equals' if same else 'differs from'} the default build's "
            f"(bit for bit); contact scene: steps done {kk}, as the plain "
            f"version; committed state vs plain P {dP:.3e} of a change "
            f"{sP:.3e}, V {dV:.3e} of {sV:.3e}; batched, one step vs the "
            f"batched plain version max abs {err_b:.3e}")

        # ---- 4. times ----------------------------------------------------
        t = in_turns(torch, {
            "default": lambda: affine_chunked(ao, Pw, Vw, F0, rb, SCENE_STEPS,
                                              ITERATIONS),
            "build": lambda: affine_chunked(ao, Pw, Vw, F0, rb, SCENE_STEPS,
                                            ITERATIONS, options=o),
            "default batched": lambda: affine_chunked_batched(
                ao, Pe, Ve, Fe, rb, SCENE_STEPS, ITERATIONS),
            "build batched": lambda: affine_chunked_batched(
                ao, Pe, Ve, Fe, rb, SCENE_STEPS, ITERATIONS, options=o)},
            OPTION_ROUNDS)
        plain_ms = cuda_ms(torch, lambda: affine_chunked_plain(
            ao, Pw, Vw, F0, rb, SCENE_STEPS, ITERATIONS, options=o),
            reps=PLAIN_REPS, warmup=0)
        plain_b_ms = cuda_ms(torch, lambda: affine_chunked_plain(
            ao, Pe, Ve, Fe, rb, SCENE_STEPS, ITERATIONS, options=o),
            reps=PLAIN_REPS, warmup=0)
        bound, by = bound_ms(*k5_cost(ao, SCENE_STEPS, ITERATIONS,
                                      CHUNK_EVERY, options=o))
        bound_b, by_b = bound_ms(*k5_cost(ao, SCENE_STEPS, ITERATIONS,
                                          CHUNK_EVERY, nb=NEW_BATCH,
                                          options=o))
        if not o.floor_bound_skip:
            exact_us = 1e3 * (t["build"] - t["default"]) / SCENE_STEPS
        log(f"[4] {label}, {SCENE_STEPS}-step calls in turns with the default "
            f"build ({OPTION_ROUNDS} rounds, median): solo "
            f"{1e3 * t['build'] / SCENE_STEPS:.2f} us/step against "
            f"{1e3 * t['default'] / SCENE_STEPS:.2f}; batched at {NEW_BATCH} "
            f"sims {1e3 * t['build batched'] / SCENE_STEPS:.2f} against "
            f"{1e3 * t['default batched'] / SCENE_STEPS:.2f}; plain "
            f"{1e3 * plain_ms / SCENE_STEPS:.1f} / "
            f"{1e3 * plain_b_ms / SCENE_STEPS:.1f} us/step; bound "
            f"{1e3 * bound / SCENE_STEPS:.4f} ({by}) / "
            f"{1e3 * bound_b / SCENE_STEPS:.4f} us/step ({by_b})"
            + (f"; the exact check costs {exact_us:.2f} us per step"
               if not o.floor_bound_skip else ""))
        near = ({"contact_scene_run_steps_ms": t_near}
                if not o.floor_exact else {})
        entries += [
            chunk_entry(paths, launch_path, solo, o, lines, err, t["build"],
                        plain_ms, bound, by, steps_per_call=SCENE_STEPS,
                        default_ms=t["default"],
                        equals_default_bitwise=same, **near),
            chunk_entry(paths, launch_path, batched, o, lines, err_b,
                        t["build batched"], plain_b_ms, bound_b, by_b,
                        steps_per_call=SCENE_STEPS, sims=NEW_BATCH,
                        default_ms=t["default batched"],
                        chunk_equals_solo_bitwise=True)]
    reprepare(solver, CHUNKED_TIER1_MIN_VERTS=default_min,
              **DEFAULT_SWITCHES)
    return entries, exact_us


def scale_phase(torch, counted, paths, dev):
    """The megacloth (:func:`megacloth_scene`, MEGA_ROWS x MEGA_ROWS
    vertices, r = MEGA_R, K = MEGA_K; random bases from fixed seeds,
    float32 state, bfloat16 matrices) through the large-model route: tier 1
    kernel 5, contact tier kernel 2.  Paths (2): run_steps over the rest
    window (no force, MEGA_REST steps) on the default build and with
    resident_floor_exact True and False, each certified, the exact and the
    exact-free end states equal bit for bit; the near-floor window (the
    lowest vertex MEGA_GAP above the floor, MEGA_GRAVITY x gravity,
    MEGA_NEAR steps) on both builds, tier 1 then kernel 2, the exact-free
    build's exit at or before the exact build's; make_batched_run on
    MEGA_BATCH drifting sims over MEGA_BATCH_STEPS steps on the exact-free
    build.  Holds (3): the carried steps of both builds from rest under
    MEGA_GRAVITY x gravity, the near-floor window's committed state against
    the plain version, kernel 2's steps one by one near the floor, the
    batched chunk launch per sim bit for bit against the solo launch, the
    batched window per sim against the solo one.  Times (4): the builds in
    turns (kernel 5's 2,000-step calls at rest, with the bound off too;
    run_steps over the near-floor window; batched).  Returns {kernel name:
    the numbers the kernels line carries under "megacloth"}."""
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        DEFAULT_OPTIONS,
        ChunkOptions,
        _chunk_launch,
        affine_chunked,
        affine_chunked_batched,
        affine_chunked_plain,
        chunk_anchors,
        chunk_plan,
        counter,
        fill_ymm,
    )
    from animsnapbases_tpu_torch.ops.fused_reduced import gather_vc
    from animsnapbases_tpu_torch.ops.resident import (
        force_term,
        project,
        resident_multistep,
        resident_multistep_plain,
    )

    t0 = time.perf_counter()
    model, solver = megacloth_solver(torch, dev)
    prep_s = time.perf_counter() - t0
    ro, ao = solver._resident, solver._affine
    log(f"[2] megacloth: N={ro.n} r={ao.fused.r} n_sel={ro.n_sel} g_total="
        f"{ao.fused.g_total} m_total={ao.fused.m_total}, built and prepared "
        f"in {prep_s:.1f} s (host); tiers: {solver._resident_fast_kind} tier "
        f"1, {solver._resident_kind} contact tier; default build "
        f"{solver._chunk_opts.label or 'exact'}")
    require(solver._resident_fast_kind == "chunked"
            and solver._resident_kind == "standard",
            "the megacloth is not on the large-model route")
    exact, free = DEFAULT_OPTIONS, ChunkOptions(floor_exact=False)
    bound_off = ChunkOptions(floor_bound_skip=False)
    plan = chunk_plan(ao)
    log(f"[4] megacloth: kernel 5's staging plan {list(plan.staged)} in "
        f"shared memory, {list(plan.from_l2) or 'nothing'} from L2, "
        f"{plan.smem_bytes} B a block")
    rb = solver._rb_extra()
    rest = (model.positions.copy(), model.velocities.copy())
    f0 = np.zeros_like(rest[0])
    out = {}

    # ---- 2. the rest window ----------------------------------------------
    ends, rest_s = {}, {}
    for key, fe in (("default", None), ("exact", True), ("exact-free", False)):
        retier(solver, resident_floor_exact=fe)
        o = solver._chunk_opts
        name = counter(o, False).__name__
        model.positions, model.velocities = (x.copy() for x in rest)
        label = (f"megacloth rest window, {key} ({o.label or 'exact'}), "
                 f"run_steps({MEGA_REST})")

        def go(key=key):
            t1 = time.perf_counter()
            solver.run_steps(f0, MEGA_REST, num_iterations=ITERATIONS)
            torch.cuda.synchronize()
            rest_s[key] = time.perf_counter() - t1

        paths[label] = counted_path(torch, counted, label, {name}, go)
        require(solver._last_fast_steps == MEGA_REST,
                f"{label}: not certified ({solver._last_fast_steps})")
        require(np.isfinite(model.positions).all()
                and model.positions[:, 1].min() > model.floor_height,
                f"{label}: the end state is not finite and floor-clear")
        ends[key] = (model.positions.copy(), model.velocities.copy())
        out.setdefault(name, {})["rest_path"] = label
        out[name]["rest_launches"] = paths[label][name]
        out[name]["rest_entry_steps_per_s"] = MEGA_REST / rest_s[key]
    same = all(np.array_equal(a, b) for a, b in zip(ends["exact"],
                                                    ends["exact-free"]))
    log(f"[2] megacloth rest window, {MEGA_REST} steps at the entry point: "
        + ", ".join(f"{k} {MEGA_REST / v:.0f} steps/s"
                    for k, v in rest_s.items())
        + f"; the exact and the exact-free end states equal bit for bit: "
        f"{same}; moved at most "
        f"{np.abs(ends['exact'][0] - rest[0]).max():.3e}")
    require(same, "the exact-free build's rest window differs from the "
            "exact build's")

    # ---- 2. the near-floor window -----------------------------------------
    near_P = rest[0].copy()
    near_P[:, 1] += model.floor_height + MEGA_GAP - near_P[:, 1].min()
    near = (near_P, np.zeros_like(near_P))
    fg = MEGA_GRAVITY * gravity(model)
    exits = {}
    for key, o in (("exact", exact), ("exact-free", free)):
        retier(solver, resident_floor_exact=o.floor_exact)
        calls = spy_tier1(solver)
        model.positions, model.velocities = (x.copy() for x in near)
        label = (f"megacloth near-floor window, {key}, "
                 f"run_steps({MEGA_NEAR})")
        name = counter(o, False).__name__
        paths[label] = counted_path(
            torch, counted, label, {name, "resident_multistep"},
            lambda: solver.run_steps(fg, MEGA_NEAR,
                                     num_iterations=ITERATIONS))
        require(calls and calls[0] > 0 and sum(calls) < MEGA_NEAR
                and solver._last_fast_steps is None,
                f"{label}: did not go tier 1 -> kernel 2 (tier-1 calls "
                f"{calls})")
        require(np.isfinite(model.positions).all()
                and model.positions[:, 1].min() > -0.5,
                f"{label}: the end state is not finite and held at the floor")
        exits[key] = calls
        out.setdefault(name, {})["near_floor_tier1_calls"] = calls
        out[name]["near_floor_path"] = label
        log(f"[2] {label}: tier-1 calls {calls} (a call after the first: a "
            f"rebase and re-entry; 0: the fall-through), kernel 2 served "
            f"{MEGA_NEAR - sum(calls)} steps; end y in "
            f"[{model.positions[:, 1].min():.4f}, "
            f"{model.positions[:, 1].max():.4f}]")
    require(exits["exact-free"][0] <= exits["exact"][0],
            f"the exact-free build exited after the exact build "
            f"({exits['exact-free'][0]} > {exits['exact'][0]})")

    # ---- 3. holds -----------------------------------------------------------
    Pr, Vr = (solver._to_device(x) for x in rest)
    Pn, Vn = (solver._to_device(x) for x in near)
    Fg, F0 = solver._to_device(fg), torch.zeros_like(Pr)
    for key, o in (("exact", exact), ("exact-free", free)):
        name = counter(o, False).__name__
        err, _ = carried_steps(
            torch, f"kernel 5 {key}, megacloth from rest under "
            f"{MEGA_GRAVITY:g}x gravity, carried steps", 5, ao,
            lambda *a, o=o: affine_chunked_plain(
                *a, rebase_every=CHUNK_EVERY, options=o),
            Pr, Vr, Fg, rb, MEGA_DEPTH, CHUNK_EVERY, options=o)
        Pk, Vk, kk = affine_chunked(ao, Pn, Vn, Fg, rb, MEGA_NEAR,
                                    ITERATIONS, rebase_every=16, options=o)
        Pp, Vp, kp = affine_chunked_plain(ao, Pn, Vn, Fg, rb, MEGA_NEAR,
                                          ITERATIONS, rebase_every=16,
                                          options=o)
        dP, dV = max_abs(Pk, Pp), max_abs(Vk, Vp)
        sP, sV = max_abs(Pp, Pn), max_abs(Vp, Vn)
        log(f"[3] kernel 5 {key}, megacloth near-floor window "
            f"(rebase_every=16): steps done kernel {kk}, plain {kp}; "
            f"committed state vs plain P {dP:.3e} of a change {sP:.3e}, V "
            f"{dV:.3e} of {sV:.3e}")
        require(kk == kp and 0 < kk < MEGA_NEAR,
                f"kernel 5 {key}: steps done differ near the floor")
        require(dP <= STEP_TOL * sP and dV <= STEP_TOL * sV,
                f"kernel 5 {key}: committed near-floor state differs")
        out[name]["max_abs_err"] = max(err, dP, dV)
        out[name]["near_floor_k"] = kk
    k2_err, _ = step_by_step(
        torch, "kernel 2 (megacloth near-floor window)", ro,
        lambda P_, V_: resident_multistep(ro, P_, V_, Fg, rb, 1, ITERATIONS),
        lambda P_, V_: resident_multistep_plain(ro, P_, V_, Fg, rb, 1,
                                                ITERATIONS),
        Pn, Vn, Fg, rb, MEGA_DEPTH)
    out["resident_multistep"] = {"max_abs_err": k2_err}

    # ---- 4. times in turns --------------------------------------------------
    # the two builds over WINDOW_STEPS; the exact check (the build without
    # the bound against the default) over SCENE_STEPS, ~1.4 ms a step here
    t = in_turns(torch, {
        key: lambda o=o: affine_chunked(ao, Pr, Vr, F0, rb, WINDOW_STEPS,
                                        ITERATIONS, options=o)
        for key, o in (("exact", exact), ("exact-free", free))}, MEGA_ROUNDS)
    t_check = in_turns(torch, {
        key: lambda o=o: affine_chunked(ao, Pr, Vr, F0, rb, SCENE_STEPS,
                                        ITERATIONS, options=o)
        for key, o in (("exact", exact), ("bound off", bound_off))},
        MEGA_ROUNDS)
    require(affine_chunked(ao, Pr, Vr, F0, rb, SCENE_STEPS, ITERATIONS,
                           options=bound_off)[2] == SCENE_STEPS,
            "the bound-off build stopped in the rest window")
    exact_us = 1e3 * (t_check["bound off"] - t_check["exact"]) / SCENE_STEPS
    # a chunk launch of 0 steps: what each build does once per chunk (the
    # exact build's one-block minima and maxima of the anchors' y rows;
    # the exact-free build has them from the outer loop)
    fa0 = force_term(ro, F0)
    bu0, bu1, b0s, b1s = chunk_anchors(ao, Pr, Vr)
    chunk0 = (fa0, torch.empty(6, device=Pr.device), False, b0s, b1s,
              gather_vc(ro.fused, fa0), bu0, bu1, project(ro, fa0))
    fill_ymm(chunk0[1], Pr, Vr, fa0, True)
    t_chunk = in_turns(torch, {
        key: lambda o=o: _chunk_launch(ao, Pr, Vr, *chunk0, rb, 0,
                                       ITERATIONS, ao.floor_level, o)
        for key, o in (("exact", exact), ("exact-free", free))}, MEGA_ROUNDS)
    t_near = near_in_turns(torch, solver, model, near, fg, MEGA_NEAR)
    plain_ms = cuda_ms(torch, lambda: affine_chunked_plain(
        ao, Pr, Vr, F0, rb, SCENE_STEPS, ITERATIONS, options=free), reps=1,
        warmup=0)
    for key, o in (("exact", exact), ("exact-free", free)):
        name = counter(o, False).__name__
        bound, by = bound_ms(*k5_cost(ao, WINDOW_STEPS, ITERATIONS,
                                      CHUNK_EVERY, options=o))
        out[name].update(us_per_step=1e3 * t[key] / WINDOW_STEPS,
                         bound_us_per_step=1e3 * bound / WINDOW_STEPS,
                         bound_by=by,
                         near_floor_run_steps_ms=t_near[key])
    out[counter(free, False).__name__]["plain_us_per_step"] = (
        1e3 * plain_ms / SCENE_STEPS)
    log(f"[4] megacloth, kernel 5's {WINDOW_STEPS}-step calls at rest in "
        f"turns ({MEGA_ROUNDS} rounds, median): " + ", ".join(
            f"{k} {1e3 * v / WINDOW_STEPS:.2f} us/step" for k, v in t.items())
        + f"; {SCENE_STEPS}-step calls: " + ", ".join(
            f"{k} {1e3 * v / SCENE_STEPS:.2f} us/step"
            for k, v in t_check.items())
        + f", so the exact check costs {exact_us:.2f} us per step; a chunk "
        f"launch of 0 steps: " + ", ".join(
            f"{k} {1e3 * v:.1f} us" for k, v in t_chunk.items())
        + f"; run_steps "
        f"over the near-floor window in turns: " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in t_near.items())
        + f"; the exact-free build's plain version "
        f"{1e3 * plain_ms / SCENE_STEPS:.1f} us/step")

    # ---- batched: make_batched_run on the exact-free build ------------------
    retier(solver, resident_floor_exact=False)
    pos = np.repeat(rest[0][None], MEGA_BATCH, axis=0)
    vel = np.zeros_like(pos)
    for b in range(MEGA_BATCH):
        vel[b, :, 2] = (1.0 - SPREAD * b) * MEGA_DRIFT
    fs = np.zeros_like(pos)
    run = solver.make_batched_run()
    label = (f"megacloth make_batched_run, B={MEGA_BATCH} drifting sims, "
             f"exact-free, {MEGA_BATCH_STEPS} steps")
    got = {}

    def go():
        t1 = time.perf_counter()
        got["out"] = run(pos, vel, fs, MEGA_BATCH_STEPS,
                         num_iterations=ITERATIONS)
        torch.cuda.synchronize()
        got["s"] = time.perf_counter() - t1

    name_b = counter(free, True).__name__
    paths[label] = counted_path(torch, counted, label, {name_b}, go)
    require(solver._last_batched_path == "batched-chunked",
            f"{label}: took {solver._last_batched_path}")
    p_b = got["out"][0]
    require(np.isfinite(p_b).all() and p_b[:, :, 1].min() > 0,
            f"{label}: the end state is not finite and floor-clear")
    Pb, Vb, Fb = (solver._pack(x) for x in (pos, vel, fs))
    fa_b = force_term(ro, Fb)
    bu0, bu1, b0s, b1s = chunk_anchors(ao, Pb, Vb)
    ymm = torch.empty(MEGA_BATCH, 6, device=Pb.device)
    fill_ymm(ymm, Pb, Vb, fa_b, True)
    chunk_in = (Pb, Vb, fa_b, ymm, b0s, b1s, gather_vc(ro.fused, fa_b), bu0,
                bu1, project(ro, fa_b))

    chunk = min(CHUNK_EVERY, MEGA_BATCH_STEPS)

    def launch(P_, V_, fa_, ymm_, *anchors):
        return _chunk_launch(ao, P_, V_, fa_, ymm_, True, *anchors, rb,
                             chunk, ITERATIONS, ao.floor_level, free)

    coef, kb = launch(*chunk_in)
    same_per_sim(torch, f"megacloth batched kernel 5 exact-free chunk, "
                 f"{MEGA_BATCH} sims, {chunk} steps", (coef, kb),
                 lambda b: launch(*(x[b] for x in chunk_in)), MEGA_BATCH)
    Pk, Vk, k = affine_chunked_batched(ao, Pb, Vb, Fb, rb, MEGA_BATCH_STEPS,
                                       ITERATIONS, options=free)
    err_b = 0.0
    for b in range(MEGA_BATCH):
        Ps, Vs, ks = affine_chunked(ao, Pb[b], Vb[b], Fb[b], rb,
                                    MEGA_BATCH_STEPS, ITERATIONS,
                                    options=free)
        require(k == ks == MEGA_BATCH_STEPS, f"megacloth sim {b}: steps "
                f"done batched {k}, solo {ks}")
        for key, x, y, start in (("P", Pk[b], Ps, Pb[b]),
                                 ("V", Vk[b], Vs, Vb[b])):
            d, size = max_abs(x, y), max_abs(y, start)
            err_b = max(err_b, d)
            require(d <= STEP_TOL * size, f"megacloth batched sim {b} {key}: "
                    f"{d:.3e} from its solo run (change {size:.3e})")
    t_b = in_turns(torch, {
        key: lambda o=o: affine_chunked_batched(ao, Pb, Vb, Fb, rb,
                                                WINDOW_STEPS, ITERATIONS,
                                                options=o)
        for key, o in (("exact", exact), ("exact-free", free))}, MEGA_ROUNDS)
    bound_b, by_b = bound_ms(*k5_cost(ao, WINDOW_STEPS, ITERATIONS,
                                      CHUNK_EVERY, nb=MEGA_BATCH,
                                      options=free))
    out[name_b] = {
        "path": label, "launches": paths[label][name_b],
        "entry_aggregate_steps_per_s": MEGA_BATCH * MEGA_BATCH_STEPS
        / got["s"], "max_abs_err": err_b,
        "us_per_step": 1e3 * t_b["exact-free"] / WINDOW_STEPS,
        "exact_build_us_per_step": 1e3 * t_b["exact"] / WINDOW_STEPS,
        "bound_us_per_step": 1e3 * bound_b / WINDOW_STEPS, "bound_by": by_b}
    log(f"[4] {label}: {out[name_b]['entry_aggregate_steps_per_s']:.0f} "
        f"aggregate steps/s at the entry point; {WINDOW_STEPS}-step batched "
        f"calls in turns: " + ", ".join(
            f"{k} {1e3 * v / WINDOW_STEPS:.2f} us/step, "
            f"{MEGA_BATCH * WINDOW_STEPS / (v / 1e3):.0f} aggregate steps/s"
            for k, v in t_b.items())
        + f"; each sim within {STEP_TOL} of its change from its solo run, "
        f"max abs {err_b:.3e}")
    out["exact_check_us"] = exact_us
    out["staging_plan"] = plan.as_dict()
    out["empty_chunk_us"] = {k: 1e3 * v for k, v in t_chunk.items()}
    out["prepare_s"] = prep_s
    retier(solver, **DEFAULT_SWITCHES)
    return out


def pod_bounds(S, K):
    """(bound on |s_k - s'_k|, bound on max |U_k - U'_k|) for k < K: two
    float64 snapshot PODs (the Gram method, ops/podlinalg.py) of one matrix
    X whose Gram products differ by E, |E| at most e = POD_GAMMA lam_0 (the
    largest eigenvalue), to first order.  Weyl: each eigenvalue moves at
    most e, so s_k at most e / (2 s_k).  The eigenvector w_k takes at most
    e / |lam_k - lam_j| of each other w_j, and U_k = X w_k / s_k turns that
    into s_j / s_k of U_j; with the change of 1 / s_k,
    |dU_k| <= sum_j e s_j / (|lam_k - lam_j| s_k) + |ds_k| / s_k.  Floors:
    1e-10 of s_k and 1e-9.  Tight for the leading modes, the bounds grow
    without limit in a tail whose eigenvalues crowd within e of each other:
    there the Gram method's modes are set by rounding."""
    S = np.asarray(S, dtype=float)
    lam = S * S
    e = POD_GAMMA * lam[0]
    ds = 1e-10 * S[:K] + e / (2.0 * S[:K])
    du = np.empty(K)
    for k in range(K):
        j = np.arange(len(S)) != k
        du[k] = (1e-9 + e * np.sum(S[j] / np.abs(lam[k] - lam[j])) / S[k]
                 + ds[k] / S[k])
    return ds, du


def sign_aligned_diff(a, b):
    """max |a_k - s_k b_k| per mode k (axis 0), s_k = +-1 aligning b_k with
    a_k."""
    a = np.asarray(a, dtype=float).reshape(len(a), -1)
    b = np.asarray(b, dtype=float).reshape(len(b), -1)
    s = np.where((a * b).sum(axis=1) < 0, -1.0, 1.0)
    return np.abs(a - s[:, None] * b).max(axis=1)


def deim_picks_agree(comps, picks_ref, picks, mode_diff):
    """Whether ``picks`` is the greedy DEIM sequence of ``comps`` (K, ep, d)
    wherever it differs from ``picks_ref``: following ``picks``, step k's
    residual of mode k against the rows picked before it (the host loop's
    lstsq per dimension) must be largest at picks[k], within PICK_RTOL plus
    what the components' difference between the two sides (``mode_diff``,
    per mode) can move it.  -> (ok, [(k, ref pick, pick, shortfall)])."""
    picks_ref, picks = np.asarray(picks_ref), np.asarray(picks)
    if picks.shape != picks_ref.shape:
        return False, []
    bases = np.asarray(comps).swapaxes(0, 1)         # (ep, K, d)
    ties = []
    for k in np.nonzero(picks != picks_ref)[0]:
        vk = bases[:, k, :]
        sol_l1 = 0.0
        if k == 0:
            r = vk
        else:
            c = np.empty(vk.shape)
            for i in range(vk.shape[1]):
                sol = np.linalg.lstsq(bases[picks[:k], :k, i],
                                      vk[picks[:k], i], rcond=None)[0]
                c[:, i] = bases[:, :k, i] @ sol
                sol_l1 = max(sol_l1, float(np.abs(sol).sum()))
            r = c - vk
        energy = (r ** 2).sum(axis=1)
        top = float(energy.max())
        rtol = PICK_RTOL + 8.0 * float(np.max(mode_diff[:k + 1])) * (
            1.0 + sol_l1) / np.sqrt(top)
        shortfall = 1.0 - float(energy[picks[k]]) / top
        ties.append((int(k), int(picks_ref[k]), int(picks[k]), shortfall))
        if shortfall > rtol:
            return False, ties
    return True, ties


def on_host(x):
    """``x`` (a tensor, or a dataclass or tuple holding tensors) with every
    tensor copied to the host."""
    if hasattr(x, "cpu") and callable(x.cpu):
        return x.cpu()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: on_host(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (tuple, list)):
        return type(x)(on_host(v) for v in x)
    return x


def bound_trips(ao, P, V, F, rb, steps):
    """The steps of kernel 5's window from (P, V) on which its O(r) floor
    bound trips (the exact check runs), counted on the plain version on
    the host (``ops/affine_chunked.py`` ``floor_bound``)."""
    import animsnapbases_tpu_torch.ops.affine_chunked as ac

    trips, real = [], ac.floor_bound

    def spy(*a, **kw):
        out = real(*a, **kw)
        trips.append(bool(out.any()))
        return out

    ac.floor_bound = spy
    try:
        done = ac.affine_chunked_plain(on_host(ao), P.cpu(), V.cpu(),
                                       F.cpu(), rb.cpu(), steps,
                                       ITERATIONS)[2]
    finally:
        ac.floor_bound = real
    require(done == steps, "the plain kernel 5 stopped in the window")
    return sum(trips)


def pipeline_phase(torch, counted, paths, dev, work=None):
    """bench.py's flagship path on the card with real bases, on the bench
    scene (:func:`bench_scene`): the full-order recording
    (``Solver(global_solve="host")``, FOM_FRAMES frames at FOM_ITERS
    iterations under gravity, p-snapshots stored), the two constraint
    bases (bench.py:118-181's config: CONSTR_MODES modes,
    ``pod_vectorized``, row DEIM) and the position basis (r = min(POS_MODES,
    FOM_FRAMES)), the reduced solver prepared from those files as
    ``bench.build_reduced_solver`` prepares it (REDUCED_MODES modes a group,
    DEIM oversampled 4/3, float32 state, bfloat16 matrices, the lean
    contact tier), then ``run_steps(FOM_FRAMES)`` from the hang state under
    gravity (bench.py's reduced-vs-FOM statistic) and one ``step()``: one
    counted path (kernels 1 and 5).  The recording again on the card (bit
    for bit: trajectory and p-snapshots) and its first CPU_FRAMES frames on
    the CPU (within CPU_DEVIATION of the scene's extent); the bases again
    on the CPU from the card's files (the DEIM picks equal or ties,
    :func:`deim_picks_agree`; components and singular values within
    :func:`pod_bounds`); no warning of the bases pipeline.  The ring-down
    window (bench.py's timed phase: EXCITE x the recording's tail
    velocity, no force, PIPE_WARMUP steps, then WINDOW_STEPS) as a counted
    path, certified by tier 1 and floor-clear.  Kernels 1 and 5 held
    against their plain versions on these bases (kernel 1 against float64,
    :func:`as_accurate`; kernel 5 step by step and its carried steps) and
    timed.  The recording and the
    bases lie under ``work`` (``card/bases``, ``card/pos_basis.npz``,
    ``card/traj.npy``; a temporary directory when None), where phases [9]
    and [10] read them.  Returns
    {kernel name: the numbers the kernels line carries under
    "real_bases"}."""
    import warnings

    from animsnapbases_tpu_torch.bases.pipeline import (
        build_bases,
        fom_deviation,
        record_fom,
        reduced_args,
    )
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        ChunkOptions,
        affine_chunked,
        affine_chunked_plain,
        chunk_plan,
    )
    from animsnapbases_tpu_torch.ops.cluster import resident_clusters
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_plan,
        fused_reduced_iterations,
        fused_reduced_iterations_plain,
    )
    from animsnapbases_tpu_torch.ops.resident import force_term, predict
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    dt = 0.016

    def scene():
        return bench_scene(DeformableModel, cloth_model)

    out, secs = {}, {}
    with (contextlib.nullcontext(work) if work
          else tempfile.TemporaryDirectory()) as work:
        # ---- 2. the pipeline's main path, counted ------------------------
        model = scene()
        f = gravity(model)
        state = {}

        def record(label, device, frames=FOM_FRAMES):
            m = scene()
            t0 = time.perf_counter()
            traj, fom = record_fom(m, f, os.path.join(work, label, "FOM"),
                                   frames, FOM_ITERS, dt, BENCH_DAMPING,
                                   device=device)
            secs[f"record, {label}"] = time.perf_counter() - t0
            log(f"[6] pipeline: recorded {frames} frames at {FOM_ITERS} "
                f"iterations on the {label} ({fom._mode} global solve) in "
                f"{secs[f'record, {label}']:.2f} s: local stage "
                f"{fom.seconds['local']:.2f} s, transfers "
                f"{fom.seconds['transfer']:.2f} s, LU solves "
                f"{fom.seconds['solve']:.2f} s")
            return traj, fom

        def main_pipeline():
            traj, fom = record("card", dev)
            timings = {}
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                basis_dir, pos_path, groups = build_bases(
                    model, os.path.join(work, "card", "FOM"), traj,
                    os.path.join(work, "card"), CONSTR_MODES, POS_MODES,
                    device=dev, timings=timings)
            own = [str(w.message) for w in caught
                   if "animsnapbases_tpu_torch" in w.filename]
            require(not own, f"the bases pipeline warned: {own}")
            secs["bases, card"] = sum(timings.values())
            log(f"[6] pipeline: bases on the card in "
                f"{secs['bases, card']:.2f} s ("
                + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
                + "); " + "; ".join(
                    f"{g}: {cc.numComp} modes, {len(cc.geom_Pt)} DEIM rows, "
                    f"s_K/s_0 {cc.singVals[cc.numComp - 1] / cc.singVals[0]:.3e}"
                    for g, cc in groups.items()) + "; no warning")
            args = reduced_args(basis_dir, pos_path, min(REDUCED_MODES,
                                                          CONSTR_MODES),
                                POS_MODES, dt, BENCH_DAMPING)
            solver = AnimSnapBasesSolver(args, device=dev,
                                         dtype=torch.float32,
                                         matmul_dtype=torch.bfloat16)
            solver.resident_contact_mode = False
            solver.set_model(model)
            t0 = time.perf_counter()
            solver.prepare(args)
            secs["prepare"] = time.perf_counter() - t0
            state["entry"] = model.positions.copy()
            solver.run_steps(f, FOM_FRAMES, num_iterations=FOM_ITERS)
            state["after"] = (model.positions.copy(),
                              model.velocities.copy())
            solver.step(f, num_iterations=FOM_ITERS)
            np.save(os.path.join(work, "card", "traj.npy"), traj)
            state.update(traj=traj, groups=groups, solver=solver,
                         basis_dir=basis_dir)

        paths["pipeline: record, bases, prepare, run_steps + step"] = (
            counted_path(torch, counted, "the pipeline (record -> bases -> "
                         f"prepare -> run_steps({FOM_FRAMES}) + step())",
                         {"fused_reduced_iterations", "affine_chunked"},
                         main_pipeline))
        traj, groups, solver = state["traj"], state["groups"], state["solver"]
        ro, ao = solver._resident, solver._affine
        fo = ro.fused
        require(solver._resident_fast_kind == "chunked"
                and solver._resident_kind == "affine",
                "the real-basis solver is not on the bench tiers")
        mean, p99, top = fom_deviation(state["after"][0], traj[-1])
        require(np.isfinite(state["after"][0]).all()
                and np.isfinite(state["after"][1]).all()
                and np.isfinite(model.positions).all(),
                "the reduced solve on real bases left non-finite state")
        out["vs_fom"] = {"mean": mean, "p99": p99, "max": top}
        log(f"[6] pipeline: prepare {secs['prepare']:.2f} s: N={ro.n} "
            f"r={fo.r} n_sel={ro.n_sel} g_total={fo.g_total} m_total="
            f"{fo.m_total}; reduced-vs-FOM after {FOM_FRAMES} steps "
            f"(|P - P_FOM| / max|P_FOM|): mean {mean:.4f}, p99 {p99:.4f}, "
            f"max {top:.4f}; state finite")
        plans = {}
        for name, lib, plan in (
                ("fused_reduced_iterations", "fused_reduced", fused_plan(fo)),
                ("affine_chunked", "affine_chunked", chunk_plan(ao))):
            plans[name] = dict(plan.as_dict(), resident_clusters=(
                resident_clusters(lib, plan)))
            log(f"[6] pipeline, {name} at r = {fo.r}: staging plan "
                f"{list(plan.staged)} in shared memory, "
                f"{list(plan.from_l2) or 'nothing'} from L2, "
                f"{plan.smem_bytes} B a block, "
                f"{plans[name]['resident_clusters']} clusters resident")

        # ---- 2. the recording again, on the card and on the CPU ---------
        again, _ = record("card, again", dev)
        same = bool(np.array_equal(again, traj))
        for g in groups:
            a = np.load(os.path.join(work, "card", "FOM", g + "_p.npz"))
            b = np.load(os.path.join(work, "card, again", "FOM",
                                     g + "_p.npz"))
            same = same and a.files == b.files and all(
                np.array_equal(a[k], b[k]) for k in a.files)
        log(f"[6] pipeline: the recording again on the card equals the "
            f"first bit for bit (trajectory and p-snapshots): {same}")
        require(same, "two recordings on the card differ")
        cpu_traj, _ = record("cpu", "cpu", CPU_FRAMES)
        extent = float(np.abs(cpu_traj).max())
        dev_rel = float(np.abs(traj[:CPU_FRAMES] - cpu_traj).max()) / extent
        log(f"[6] pipeline: the card's first {CPU_FRAMES} frames against the "
            f"CPU's: {dev_rel:.3e} of the scene's extent (limit "
            f"{CPU_DEVIATION})")
        require(dev_rel <= CPU_DEVIATION,
                "the card's recording departs from the CPU's")
        out["record_vs_cpu"] = dev_rel

        # ---- 3. the bases again, on the CPU from the card's files --------
        timings = {}
        _, cpu_pos, cpu_groups = build_bases(
            scene(), os.path.join(work, "card", "FOM"), traj,
            os.path.join(work, "cpu bases"), CONSTR_MODES, POS_MODES,
            device="cpu", timings=timings)
        secs["bases, cpu"] = sum(timings.values())
        for g, cc in groups.items():
            cpu = cpu_groups[g]
            K = cc.numComp
            ds, du = pod_bounds(cpu.singVals, K)
            d_s = np.abs(cc.singVals[:K] - cpu.singVals[:K])
            d_u = sign_aligned_diff(cpu.comps, cc.comps)
            ok, ties = deim_picks_agree(cpu.comps, cpu.geom_Pt, cc.geom_Pt,
                                        d_u)
            log(f"[6] pipeline, {g}: the card's bases against the CPU's "
                f"({K} modes): picks equal on {int((cc.geom_Pt == cpu.geom_Pt).sum())}"
                f" of {K}, ties (step, CPU pick, card pick, shortfall) "
                f"{ties}; components within {d_u.max():.3e} (at most "
                f"{(d_u / du).max():.3e} of the bound; {d_u[:8].max():.3e} "
                f"over the first 8 modes), singular values within "
                f"{(d_s / cpu.singVals[:K]).max():.3e} relative (at most "
                f"{(d_s / ds).max():.3e} of the bound)")
            require(cpu.numComp == K and ok, f"{g}: the card's DEIM picks "
                    "are not the CPU's greedy picks")
            require(bool((d_u <= du).all() and (d_s <= ds).all()),
                    f"{g}: the card's POD departs from the CPU's beyond "
                    "the rounding of the Gram method")
        pos_c = np.load(os.path.join(work, "card", "pos_basis.npz"))[
            "components"]
        pos_h = np.load(cpu_pos)["components"]
        log(f"[6] pipeline: position bases (r = {len(pos_c)}), card against "
            f"CPU, by dimension, the first 8 modes: " + ", ".join(
                f"{sign_aligned_diff(pos_h[:8, :, d], pos_c[:8, :, d]).max():.3e}"
                for d in range(3)) + f"; bases on the CPU "
            f"{secs['bases, cpu']:.2f} s")

        # ---- 4. the ring-down window on the entry point ------------------
        v0 = EXCITE * (traj[-1] - traj[-2]) / dt
        v0[model.fixed_flags] = 0.0
        model.positions, model.velocities = state["entry"].copy(), v0
        solver.frame = 0
        f0 = np.zeros_like(f)
        solver.run_steps(f0, PIPE_WARMUP, num_iterations=ITERATIONS)
        ring = (model.positions.copy(), model.velocities.copy())
        window = {}

        def serve():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.run_steps(f0, WINDOW_STEPS, num_iterations=ITERATIONS)
            torch.cuda.synchronize()
            window["s"] = time.perf_counter() - t0

        paths["pipeline: ring-down window"] = counted_path(
            torch, counted, f"the ring-down window on real bases "
            f"(run_steps({WINDOW_STEPS}))", {"affine_chunked"}, serve)
        end_y = float(model.positions[:, 1].min())
        require(solver._last_fast_steps == WINDOW_STEPS,
                "tier 1 did not certify the ring-down window on real bases")
        require(np.isfinite(model.positions).all()
                and np.isfinite(model.velocities).all() and end_y > 5.0,
                f"the ring-down window ended non-finite or near the floor "
                f"(min y {end_y:.3f})")
        entry_sps = WINDOW_STEPS / window["s"]

        # ---- 5. kernels 1 and 5 on real bases ----------------------------
        Pr, Vr = (solver._to_device(x) for x in ring)
        Pg = solver._to_device(state["entry"])
        Vg = torch.zeros_like(Pg)
        Fx = solver._to_device(f)
        F0 = torch.zeros_like(Fx)
        rb = solver._rb_extra()
        fo64 = as_f64(fo)
        k1 = {"err": 0.0}
        for label, P_, V_, F_ in (("hang state under gravity", Pg, Vg, Fx),
                                  ("ring-down state", Pr, Vr, F0)):
            sn, rb_const = predict(ro, P_, V_, force_term(ro, F_), rb)
            sel = sn[:, :ro.n_sel]
            u_k = fused_reduced_iterations(fo, sel, rb_const, ITERATIONS)
            u_p = fused_reduced_iterations_plain(fo, sel, rb_const,
                                                 ITERATIONS)
            u_64 = fused_reduced_iterations_plain(
                fo64, sel.double(), rb_const.double(), ITERATIONS)
            ok, e_k, e_p = as_accurate(u_k, u_p, u_64)
            k1["err"] = max(k1["err"], max_abs(u_k, u_p))
            log(f"[6] pipeline, kernel 1 ({label}): vs plain max abs "
                f"{max_abs(u_k, u_p):.3e} (max|u| "
                f"{float(u_p.abs().max()):.3e}); vs float64: kernel "
                f"{e_k:.3e}, plain {e_p:.3e} (limit {ACC_RATIO}x)")
            require(bool(torch.isfinite(u_k).all()) and ok,
                    "kernel 1 is less accurate than its plain version on "
                    "real bases")
        k1["ms"] = cuda_ms(torch, lambda: fused_reduced_iterations(
            fo, sel, rb_const, ITERATIONS), reps=200)
        k1["plain_ms"] = cuda_ms(torch, lambda: fused_reduced_iterations_plain(
            fo, sel, rb_const, ITERATIONS), reps=PLAIN_REPS, warmup=0)
        model.positions, model.velocities = (x.copy() for x in ring)
        solver.step(f0, num_iterations=ITERATIONS)
        t0 = time.perf_counter()
        for _ in range(20):
            solver.step(f0, num_iterations=ITERATIONS)
        step_ms = 1e3 * (time.perf_counter() - t0) / 20

        def one(fn):
            def run(P_, V_):
                o = fn(ao, P_, V_, F0, rb, 1, ITERATIONS)
                require(o[2] == 1, f"{fn.__name__} stopped on a free step")
                return o[:2]
            return run

        k5_err, _ = step_by_step(
            torch, "pipeline, kernel 5 (ring-down state)", ro,
            one(affine_chunked), one(affine_chunked_plain), Pr, Vr, F0, rb,
            SCENE_STEPS)
        for label, P_, V_, F_ in (("ring-down state", Pr, Vr, F0),
                                  ("hang state under gravity", Pg, Vg, Fx)):
            err, _ = carried_steps(
                torch, f"pipeline, kernel 5 ({label}), carried steps", 5,
                ao, affine_chunked_plain, P_, V_, F_, rb, SCENE_STEPS,
                CHUNK_EVERY)
            k5_err = max(k5_err, err)
        def k5_window(**kw):
            return lambda: affine_chunked(ao, Pr, Vr, F0, rb, WINDOW_STEPS,
                                          ITERATIONS, **kw)

        k5_ms = cuda_ms(torch, k5_window(), reps=10, warmup=1)
        require(k5_window()()[2] == WINDOW_STEPS,
                "kernel 5 stopped in the ring-down window on real bases")
        # where the O(r) floor bound stands on these bases: the exact-free
        # build stops at its first trip; the window with the exact check on
        # every step (the bound off) and in chunks of PIPE_CHUNK steps
        first_trip = k5_window(options=ChunkOptions(floor_exact=False))()[2]
        k5_exact_ms = cuda_ms(torch, k5_window(options=ChunkOptions(
            floor_bound_skip=False)), reps=10, warmup=1)
        k5_short_ms = cuda_ms(torch, k5_window(rebase_every=PIPE_CHUNK),
                              reps=10, warmup=1)
        k1["device_ms"] = device_ms(torch, lambda: fused_reduced_iterations(
            fo, sel, rb_const, ITERATIONS), reps=100)
        trips = bound_trips(ao, Pr, Vr, F0, rb, WINDOW_STEPS)
        k5_plain_ms = cuda_ms(torch, lambda: affine_chunked_plain(
            ao, Pr, Vr, F0, rb, SCENE_STEPS, ITERATIONS), reps=PLAIN_REPS,
            warmup=0)
        launch_path = "pipeline: record, bases, prepare, run_steps + step"
        k1_bound, k1_by = bound_ms(*k1_cost(fo, ro.n_sel, ITERATIONS))
        k5_bound, k5_by = bound_ms(*k5_cost(ao, WINDOW_STEPS, ITERATIONS,
                                            CHUNK_EVERY, exact_steps=trips))
        log(f"[6] pipeline on real bases: run_steps over {WINDOW_STEPS} "
            f"steps (certified) {entry_sps:.0f} steps/s at the entry point; "
            f"kernel 5 {1e3 * k5_ms / WINDOW_STEPS:.2f} us/step over the "
            f"window (bound {1e3 * k5_bound / WINDOW_STEPS:.4f}, {k5_by}; "
            f"plain {1e3 * k5_plain_ms / SCENE_STEPS:.1f} us/step); kernel "
            f"1 {1e3 * k1['ms']:.2f} us a call, "
            f"{1e3 * k1['device_ms']:.2f} us a launch on the device (bound "
            f"{1e3 * k1_bound:.4f}, {k1_by}; plain "
            f"{1e3 * k1['plain_ms']:.1f} us), step() {1e3 * step_ms:.1f} us "
            f"at the entry point; end min y {end_y:.3f}")
        log(f"[6] pipeline, kernel 5's O(r) floor bound on real bases "
            f"(umax {ao.umax:.4f}): "
            + (f"it first trips at step {first_trip} of the ring-down window "
               f"(the exact-free build's stop)" if first_trip < WINDOW_STEPS
               else "no trip in the ring-down window")
            + f", trips on {trips} of its {WINDOW_STEPS} steps (the plain "
            f"version on the host; the bound counts their exact checks)"
            + f"; the window "
            f"{1e3 * k5_ms / WINDOW_STEPS:.2f} us/step on the default build, "
            f"{1e3 * k5_exact_ms / WINDOW_STEPS:.2f} with the exact check on "
            f"every step, {1e3 * k5_short_ms / WINDOW_STEPS:.2f} in chunks of "
            f"{PIPE_CHUNK} steps")
        log("[6] pipeline seconds: " + ", ".join(
            f"{k} {v:.2f}" for k, v in secs.items()))
        common = {"launches_path": launch_path, "vs_fom": out["vs_fom"],
                  "record_vs_cpu": dev_rel, "pipeline_s": secs}
        return {
            "fused_reduced_iterations": dict(
                common, launches=paths[launch_path]["fused_reduced_iterations"],
                max_abs_err=k1["err"], ms=k1["ms"], plain_ms=k1["plain_ms"],
                bound_ms=k1_bound, bound_by=k1_by, step_ms=step_ms,
                device_ms=k1["device_ms"],
                staging_plan=plans["fused_reduced_iterations"]),
            "affine_chunked": dict(
                common, launches=paths[launch_path]["affine_chunked"],
                max_abs_err=k5_err, ms=k5_ms, steps_per_call=WINDOW_STEPS,
                plain_ms=k5_plain_ms, plain_steps_per_call=SCENE_STEPS,
                bound_ms=k5_bound, bound_by=k5_by,
                entry_steps_per_s=entry_sps, umax=ao.umax,
                bound_first_trip=first_trip, bound_trips=trips,
                exact_every_step_ms=k5_exact_ms,
                short_chunks_ms=k5_short_ms, short_chunk_steps=PIPE_CHUNK,
                window_launches=paths["pipeline: ring-down window"][
                    "affine_chunked"],
                staging_plan=plans["affine_chunked"])}


# the launches of each kernel in the kernels line: those of the path
# that serves it (kernels 1 and 5: the main path; 3: the lean contact
# tier; 4: tier 1 with resident_chunked_tier1=False; 3 in contact mode:
# the contact tier with resident_contact_mode=True; 2: the contact tier
# at >= CHUNKED_TIER1_MIN_VERTS)
LAUNCH_PATH = {
    "fused_reduced_iterations": "main path",
    "affine_chunked": "main path",
    "resident_affine": "lean contact tier, contact scene",
    "resident_affine_exit": "resident_chunked_tier1=False, bench window",
    "resident_affine_contact": "resident_contact_mode=True, contact scene",
    "resident_multistep": "CHUNKED_TIER1_MIN_VERTS=0, contact scene"}


def demo_cloth(args):
    """The model of CLOTH_DEMO as the JAX package's scenario builds it at
    frame 0 (``demos/scenarios.py`` ``_frame0``): ``cloth_model(width,
    height)`` normalized into the unit box, 2 units up, floor on, the
    demo's masses, its bending, spring and strain groups at its weights,
    and its fixed corners (``fix_left_corners``, ``fix_right_corners``: the
    top and bottom vertices of the left and right sides).  The scenario's
    scheduled releases (frames 20, 60 and 140) are not run."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    V, F = cloth_model(args.cloth_width, args.cloth_height)
    model = DeformableModel(rescale(V), F,
                            masses=np.full(len(V), args.mass_per_particle),
                            floor_collision=True, init_height_shift=2.0)
    model.compute_cloth_corner_indices()
    sides = model._side_surface_verts
    ends = np.union1d(sides["top"], sides["bottom"])
    for side in ("left", "right"):
        for vi in np.intersect1d(sides[side], ends):
            model.fix(vi)
    model.add_vertex_bending_constraint(args.vert_bending_constraint_wi)
    model.add_edge_spring_constraint(args.edge_constraint_wi)
    model.add_tri_constrain_strain(args.sigma_min, args.sigma_max,
                                   args.strain_limit_constraint_wi)
    return model


def group_bases(model, json_path, record, work, basis_dir, dev, secs, label,
                **overrides):
    """One group's bases from an example config pointed at ``record``
    (``bases/pipeline.py``), its stages' seconds gathered in ``secs`` under
    ``label`` -> the ConstraintComponents.  The pipeline's warnings (the
    configs ask for more modes than some recordings hold) are printed."""
    import warnings

    from animsnapbases_tpu_torch.bases.pipeline import (
        build_bases_from_config,
        example_config,
        export_mesh,
    )

    param = example_config(json_path, record, work,
                           **{**GROUP_OVERRIDES, **overrides})
    export_mesh(model, param)
    timings = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cc = build_bases_from_config(param, basis_dir, device=dev,
                                     timings=timings)
    for stage, t in timings.items():
        secs[f"{label}: bases, {stage}"] = t
    said = sorted({str(w.message) for w in caught
                   if "animsnapbases_tpu_torch" in w.filename})
    log(f"[7] {label}: {param.constProj_basis_type} + "
        f"{param.constProj_bases_interpolation_type}, "
        f"{param.constProj_numFrames} frames, {cc.numComp} components, "
        f"{len(cc.geom_alpha)} elements selected in "
        f"{sum(timings.values()):.2f} s" + (f"; warned: {said}" if said
                                           else ""))
    require(len(cc.geom_alpha) > 0 and np.isfinite(cc.comps).all(),
            f"{label}: no usable bases")
    return cc


def card_and_cpu(torch, label, args, build, f, steps, dev, secs):
    """The reduced solver of ``args`` on ``build()``'s model, on the card
    and on the CPU (float64 on both: a configuration that is not fully
    reduced serves in ``device.PIPELINE_DTYPE``): prepare, then ``steps``
    steps.  Held step by step: each of the card's ``step()`` calls from
    the CPU's state before that step lands within CPU_DEVIATION of the
    scene's extent of the CPU's next state.  The card's free run
    (``run_steps(steps, record=True)`` from the start) is printed beside
    the CPU's, not held: the reduced step map amplifies rounding (the dense
    factor carries the 1e10 masses of pinned vertices), so two float64
    orders part over a window.  -> (the card's free trajectory, its
    solver)."""
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    solvers = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        solver = AnimSnapBasesSolver(args, device=device)
        solver.set_model(build())
        t0 = time.perf_counter()
        solver.prepare(args)
        secs[f"{label}: prepare, {where}"] = time.perf_counter() - t0
        solvers[where] = solver
    card, cpu = solvers["card"], solvers["cpu"]
    states = [(cpu.model.positions.copy(), cpu.model.velocities.copy())]
    t0 = time.perf_counter()
    for _ in range(steps):
        cpu.step(f, num_iterations=ITERATIONS)
        states.append((cpu.model.positions.copy(),
                       cpu.model.velocities.copy()))
    secs[f"{label}: {steps} steps, cpu"] = time.perf_counter() - t0
    extent = float(np.abs(states[-1][0]).max())
    per_step = []
    for i in range(steps):
        card.model.positions, card.model.velocities = (
            x.copy() for x in states[i])
        card.frame = i
        card.step(f, num_iterations=ITERATIONS)
        per_step.append(float(np.abs(card.model.positions
                                     - states[i + 1][0]).max()) / extent)
    per_step = np.array(per_step)
    card.model.positions, card.model.velocities = (x.copy()
                                                   for x in states[0])
    card.frame = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = card.run_steps(f, steps, num_iterations=ITERATIONS, record=True)
    torch.cuda.synchronize()
    secs[f"{label}: {steps} steps, card"] = time.perf_counter() - t0
    free = float(np.abs(traj[-1] - states[-1][0]).max()) / extent
    log(f"[7] {label}: {card._full.mode} path; each of {steps} steps on the "
        f"card from the CPU's state: at most {per_step.max():.3e} of the "
        f"scene's extent from the CPU's step (step "
        f"{int(per_step.argmax()) + 1}; limit {CPU_DEVIATION}); the free "
        f"runs {free:.3e} apart after {steps} steps (not held)")
    require(np.isfinite(traj).all() and per_step.max() <= CPU_DEVIATION,
            f"{label}: a step on the card departs from the CPU's")
    return traj, card


def group_demo(torch, dev, work, secs, smi, batched):
    """(a) The demo: CLOTH_DEMO's cloth (:func:`demo_cloth`) recorded for
    GROUP_FRAMES frames by the port's ``Solver`` (its dense tier), each
    group's bases from the six cloth example configs (row DEIM and geom),
    then the reduced solver as the demo config asks (``deim_pod_vectorized``,
    positions full: the dense Cholesky on the card) and on the geom bases
    under a block type (``verts_bending`` full there), each held against the
    CPU step by step -> {reduction type: reduced-vs-FOM (mean, p99,
    max)}."""
    import copy

    from animsnapbases_tpu_torch.bases.pipeline import (
        fom_deviation,
        record_fom,
    )
    from animsnapbases_tpu_torch.config.sim_config import SimConfig

    root = os.path.dirname(os.path.abspath(__file__))
    args = SimConfig(os.path.join(root, CLOTH_DEMO)).build_args("Cloth")
    model = demo_cloth(args)
    f = gravity(model)
    record = os.path.join(work, "demo", "FOM")
    t0 = time.perf_counter()
    traj, fom = record_fom(demo_cloth(args), f, record, GROUP_FRAMES,
                           args.solver_iterations, args.dt, args.damping,
                           global_solve="dense", device=dev)
    secs["demo: record"] = time.perf_counter() - t0
    log(f"[7] demo: {model.n_verts} vertices, {int(model.fixed_flags.sum())}"
        f" pinned, groups {sorted(model.groups)}; recorded {GROUP_FRAMES} "
        f"frames ({fom._mode} global solve) in {secs['demo: record']:.2f} s "
        f"({smi})")
    dirs, stats = {}, {}
    for itype in ("deim", "geom"):
        dirs[itype] = os.path.join(work, "demo", itype, "bases")
        for g, tag in CLOTH_KINDS.items():
            group_bases(model, os.path.join(root, CLOTH_EXAMPLE.format(
                itype, tag)), record, os.path.join(work, "demo", itype, g),
                dirs[itype], dev, secs, f"demo, {g}, {itype}")
    for itype, bdir in dirs.items():
        rtype = SERVED_AS[itype]
        a = copy.copy(args)
        a.constraint_projection_basis_type = rtype
        a.geom_interpolation_basis_dir = bdir
        a.geom_interpolation_basis_file = "basis.npz"
        if itype == "geom":
            # a verts_bending geom file lists vertex ids where the solver
            # reads constrained-vertex rows (ROADMAP Queue C): the group
            # serves full
            a.vert_bending_reduced = False
        label = f"demo, {itype} bases as {rtype}"
        card, solver = card_and_cpu(torch, label, a,
                                    lambda: demo_cloth(args), f,
                                    GROUP_STEPS, dev, secs)
        require(solver._full.mode == "dense",
                "the demo's solve is not on the dense Cholesky")
        if itype == "deim":
            m0 = demo_cloth(args)
            batched[label] = batched_full(
                torch, label, solver, f, (m0.positions, m0.velocities),
                secs, smi)
        stats[rtype] = fom_deviation(card[-1], traj[GROUP_STEPS - 1])
        log(f"[7] demo, {itype} bases as {rtype}: reduced-vs-FOM after "
            f"{GROUP_STEPS} steps (|P - P_FOM| / max|P_FOM|): mean "
            f"{stats[rtype][0]:.3e}, p99 {stats[rtype][1]:.3e}, max "
            f"{stats[rtype][2]:.3e} ({smi})")
    return stats


def group_bench(torch, dev, shared, secs, smi, batched):
    """(b) The bench cloth (:func:`bench_scene`) without position
    reduction: phase [6]'s recording (FOM_FRAMES frames) and bases, read
    from its files under ``shared``, then the reduced solver of
    ``reduced_args`` with the positions full (the host LU above
    ``DENSE_LIMIT``: at 3N = 43,200) and with the positions reduced and ``edge_spring`` full, each over
    FOM_FRAMES steps, held against the CPU step by step and against the
    recording -> {path: reduced-vs-FOM (mean, p99, max)}."""
    from animsnapbases_tpu_torch.bases.pipeline import (
        fom_deviation,
        reduced_args,
    )
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    def scene():
        return bench_scene(DeformableModel, cloth_model)

    dt = 0.016
    model = scene()
    full = ("dense" if 3 * model.n_verts <= AnimSnapBasesSolver.DENSE_LIMIT
            else "host")
    f = gravity(model)
    traj = np.load(os.path.join(shared, "card", "traj.npy"))
    basis_dir = os.path.join(shared, "card", "bases")
    pos_path = os.path.join(shared, "card", "pos_basis.npz")
    require(len(traj) == FOM_FRAMES, f"phase [6]'s recording has "
            f"{len(traj)} frames, not {FOM_FRAMES}")
    log(f"[7] bench: phase [6]'s recording ({FOM_FRAMES} frames) and bases "
        f"({smi})")
    stats = {}
    for label, position_reduced, edge_reduced, mode in (
            ("positions full", False, True, full),
            ("positions reduced, edge_spring full", True, False, "mixed")):
        args = reduced_args(basis_dir, pos_path, min(REDUCED_MODES,
                                                      CONSTR_MODES),
                            POS_MODES, dt, BENCH_DAMPING)
        args.position_reduced = position_reduced
        args.edge_spring_reduced = edge_reduced
        card, solver = card_and_cpu(torch, f"bench, {label}", args, scene,
                                    f, FOM_FRAMES, dev, secs)
        require(solver._full.mode == mode,
                f"bench, {label}: served on {solver._full.mode}, not {mode}")
        if mode == "host":
            refuses_batched(f"bench, {label}", solver, f)
        else:
            m0 = scene()
            batched[f"bench, {label}"] = batched_full(
                torch, f"bench, {label}", solver, f,
                (m0.positions, m0.velocities), secs, smi)
        stats[label] = fom_deviation(card[-1], traj[-1])
        log(f"[7] bench, {label}: reduced-vs-FOM after {FOM_FRAMES} steps: "
            f"mean {stats[label][0]:.3e}, p99 {stats[label][1]:.3e}, max "
            f"{stats[label][2]:.3e} ({smi})")
    return stats


def group_bar(torch, counted, paths, dev, work, secs, smi):
    """(c) Block forms on real bases, through the kernels: the bar of
    BAR_DEMO (:func:`bar_scene`, tets_deformation_gradient) recorded for
    BAR_FRAMES frames (host LU), ``pca_blocks`` + ``deim_block_form`` bases
    and ``pod_vectorized`` + ``geom`` bases from the bar's example configs,
    a position basis of the recorded displacements (r = BAR_POS_MODES);
    each served fully reduced (``deim_pca_blocks``,
    ``geom_pca_blocks_withSt``; float32 state and matrices) through
    ``prepare -> step -> run_steps`` (a counted path: kernels 1 and 5 in
    their block-form builds), tier 1 certifying the window; kernel 1 held
    against float64 and kernel 5 against its plain version step by step and
    in the steps one call carries, BAR_DEPTH steps (as the tet scenes of
    :func:`tet_bending`); both timed beside their bounds (kernel 5 and its
    plain version in BAR_DEPTH-step calls) ->
    {kernel name: {reduction type: entry}}."""
    import copy

    from animsnapbases_tpu_torch.bases.pipeline import (
        fom_deviation,
        record_fom,
    )
    from animsnapbases_tpu_torch.bases.position_reduction import (
        position_basis_from_trajectory,
        save_position_basis,
    )
    from animsnapbases_tpu_torch.config.sim_config import SimConfig
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        affine_chunked,
        affine_chunked_plain,
        chunk_plan,
    )
    from animsnapbases_tpu_torch.ops.cluster import resident_clusters
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_plan,
        fused_reduced_iterations,
        fused_reduced_iterations_plain,
    )
    from animsnapbases_tpu_torch.ops.resident import force_term, predict
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    root = os.path.dirname(os.path.abspath(__file__))
    args = SimConfig(os.path.join(root, BAR_DEMO)).build_args("Bar")
    kinds = {"tets_deformation_gradient":
             args.deformation_gradient_constraint_wi}

    def scene():
        return bar_scene(args, kinds)

    model = scene()
    f = gravity(model)
    record = os.path.join(work, "bar", "FOM")
    t0 = time.perf_counter()
    traj, _ = record_fom(scene(), f, record, BAR_FRAMES, ITERATIONS, args.dt,
                         args.damping, device=dev)
    secs["bar: record"] = time.perf_counter() - t0
    log(f"[7] bar: {model.n_verts} vertices, {len(model.elements)} tets; "
        f"recorded {BAR_FRAMES} frames in {secs['bar: record']:.2f} s "
        f"({smi})")
    dirs = {}
    for itype, example, btype in (("deim_block_form", "deim", "pca_blocks"),
                                  ("geom", "geom", "pod_vectorized")):
        dirs[itype] = os.path.join(work, "bar", itype, "bases")
        group_bases(model, os.path.join(root, BAR_EXAMPLE.format(example)),
                    record, os.path.join(work, "bar", itype), dirs[itype],
                    dev, secs, f"bar, {itype}", basis_type=btype,
                    interpolation_type=itype, **BAR_OVERRIDES)
    t0 = time.perf_counter()
    pos_path = os.path.join(work, "bar", "pos_basis.npz")
    save_position_basis(pos_path, position_basis_from_trajectory(
        traj - model.positions[None], BAR_POS_MODES, device=dev))
    secs["bar: position basis"] = time.perf_counter() - t0

    out = {"fused_reduced_iterations": {}, "affine_chunked": {}}
    for itype, bdir in dirs.items():
        rtype = SERVED_AS[itype]
        a = copy.copy(args)
        a.constraint_projection_basis_type = rtype
        a.geom_interpolation_basis_dir = bdir
        a.geom_interpolation_basis_file = "basis.npz"
        a.position_reduced = True
        a.position_num_components = BAR_POS_MODES
        a.position_basis_file = pos_path
        m = scene()
        # float32 matrices: in bfloat16, sn (~7 units up) rounds to a 1/32
        # grid before U^T A_c, whose tets weigh 1e8, and the solve lands 3
        # units off after one step (the plain version on the CPU)
        solver = AnimSnapBasesSolver(a, device=dev, dtype=torch.float32,
                                     matmul_dtype=torch.float32)
        solver.set_model(m)
        label = f"bar, {itype} bases as {rtype}"

        def serve():
            t0 = time.perf_counter()
            solver.prepare(a)
            secs[f"{label}: prepare"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            solver.step(f, num_iterations=ITERATIONS)
            solver.run_steps(f, GROUP_STEPS - 1, num_iterations=ITERATIONS)
            torch.cuda.synchronize()
            secs[f"{label}: {GROUP_STEPS} steps"] = time.perf_counter() - t0

        key = f"per-group: {label}"
        paths[key] = counted_path(
            torch, counted, f"{label} (prepare -> step + run_steps("
            f"{GROUP_STEPS - 1}))", {"fused_reduced_iterations",
                                     "affine_chunked"}, serve)
        ro, ao = solver._resident, solver._affine
        fo = ro.fused
        require(solver._full is None and solver._last_fast_steps
                == GROUP_STEPS - 1 and np.isfinite(m.positions).all(),
                f"{label}: tier 1 did not certify the window "
                f"({solver._last_fast_steps})")
        vs_fom = fom_deviation(m.positions, traj[GROUP_STEPS - 1])
        log(f"[7] {label}: N={ro.n} r={fo.r} n_sel={ro.n_sel} g_total="
            f"{fo.g_total} m_total={fo.m_total} table columns "
            f"{kind_columns(fo)}; reduced-vs-FOM after {GROUP_STEPS} steps: "
            f"mean {vs_fom[0]:.3e}, p99 {vs_fom[1]:.3e}, max {vs_fom[2]:.3e}"
            f" ({smi})")

        # kernels 1 and 5 on these bases, from the rest state under gravity
        P = solver._to_device(scene().positions)
        V = torch.zeros_like(P)
        Fx = solver._to_device(f)
        rb = solver._rb_extra()
        sn, rb_const = predict(ro, P, V, force_term(ro, Fx), rb)
        sel = sn[:, :ro.n_sel]
        u_k = fused_reduced_iterations(fo, sel, rb_const, ITERATIONS)
        u_p = fused_reduced_iterations_plain(fo, sel, rb_const, ITERATIONS)
        u_64 = fused_reduced_iterations_plain(
            as_f64(fo), sel.double(), rb_const.double(), ITERATIONS)
        ok, e_k, e_p = as_accurate(u_k, u_p, u_64)
        k1_err = max_abs(u_k, u_p)
        log(f"[7] {label}, kernel 1: vs plain max abs {k1_err:.3e} (max|u| "
            f"{float(u_p.abs().max()):.3e}); vs float64: kernel {e_k:.3e}, "
            f"plain {e_p:.3e} (limit {ACC_RATIO}x)")
        require(bool(torch.isfinite(u_k).all()) and ok,
                f"{label}: kernel 1 is less accurate than its plain version")

        def one(fn):
            def run(P_, V_):
                o = fn(ao, P_, V_, Fx, rb, 1, ITERATIONS)
                require(o[2] == 1, f"{fn.__name__} stopped on a free step")
                return o[:2]
            return run

        k5_err, _ = step_by_step(
            torch, f"{label}, kernel 5", ro, one(affine_chunked),
            one(affine_chunked_plain), P, V, Fx, rb, BAR_DEPTH)
        err, _ = carried_steps(torch, f"{label}, kernel 5, carried steps", 5,
                               ao, affine_chunked_plain, P, V, Fx, rb,
                               BAR_DEPTH, CHUNK_EVERY)
        k5_err = max(k5_err, err)
        require(affine_chunked(ao, P, V, Fx, rb, BAR_DEPTH,
                               ITERATIONS)[2] == BAR_DEPTH,
                f"{label}: kernel 5 stopped in the {BAR_DEPTH}-step window")
        k1_ms = cuda_ms(torch, lambda: fused_reduced_iterations(
            fo, sel, rb_const, ITERATIONS), reps=200)
        k1_dev = device_ms(torch, lambda: fused_reduced_iterations(
            fo, sel, rb_const, ITERATIONS), reps=100)
        k1_plain = cuda_ms(torch, lambda: fused_reduced_iterations_plain(
            fo, sel, rb_const, ITERATIONS), reps=PLAIN_REPS, warmup=0)
        k5_ms = cuda_ms(torch, lambda: affine_chunked(
            ao, P, V, Fx, rb, BAR_DEPTH, ITERATIONS))
        k5_plain = cuda_ms(torch, lambda: affine_chunked_plain(
            ao, P, V, Fx, rb, BAR_DEPTH, ITERATIONS), reps=PLAIN_REPS,
            warmup=0)
        trips = bound_trips(ao, P, V, Fx, rb, BAR_DEPTH)
        k1_bound, k1_by = bound_ms(*k1_cost(fo, ro.n_sel, ITERATIONS))
        k5_bound, k5_by = bound_ms(*k5_cost(ao, BAR_DEPTH, ITERATIONS,
                                            CHUNK_EVERY, exact_steps=trips))
        log(f"[7] {label}: kernel 1 {1e3 * k1_ms:.2f} us a call, "
            f"{1e3 * k1_dev:.2f} us a launch on the device (bound "
            f"{1e3 * k1_bound:.4f} us, {k1_by}; plain {1e3 * k1_plain:.1f} "
            f"us); kernel 5 {1e3 * k5_ms / BAR_DEPTH:.2f} us/step over "
            f"{BAR_DEPTH}-step calls (bound "
            f"{1e3 * k5_bound / BAR_DEPTH:.4f} us/step, {k5_by}; floor "
            f"bound trips on {trips} of them; plain "
            f"{1e3 * k5_plain / BAR_DEPTH:.1f} us/step) ({smi})")
        common = {"launches_path": key, "vs_fom": dict(zip(
            ("mean", "p99", "max"), vs_fom))}
        plans = {"fused_reduced_iterations": ("fused_reduced",
                                              fused_plan(fo)),
                 "affine_chunked": ("affine_chunked", chunk_plan(ao))}
        for name, err, ms, plain, bound, by, extra in (
                ("fused_reduced_iterations", k1_err, k1_ms, k1_plain,
                 k1_bound, k1_by, {"device_ms": k1_dev}),
                ("affine_chunked", k5_err, k5_ms, k5_plain, k5_bound, k5_by,
                 {"steps_per_call": BAR_DEPTH, "bound_trips": trips})):
            lib, plan = plans[name]
            out[name][rtype] = dict(
                common, launches=paths[key][name], max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bound, bound_by=by,
                staging_plan=dict(plan.as_dict(), resident_clusters=(
                    resident_clusters(lib, plan))),
                table_columns=kind_columns(fo), **extra)
    return out


def per_group_phase(torch, counted, paths, dev, smi, shared):
    """[7] The reference's per-group workflow on the card, at the
    reference's own sizes: record a full-order run, compute each group's
    bases from its example config, replay with the reduced solver.  (a)
    the demo cloth (:func:`group_demo`), (b) the bench cloth without
    position reduction on phase [6]'s files under ``shared``
    (:func:`group_bench`), (c) the bar's block forms
    through kernels 1 and 5 (:func:`group_bar`).  Each stage's seconds are
    printed beside the card's name and power limit.  Returns {kernel name:
    the entries the kernels line carries under "per_group"}."""
    secs, batched = {}, {}
    with tempfile.TemporaryDirectory() as work:
        demo = group_demo(torch, dev, work, secs, smi, batched)
        bench = group_bench(torch, dev, shared, secs, smi, batched)
        out = group_bar(torch, counted, paths, dev, work, secs, smi)
    log(f"[7] per-group workflow seconds ({smi}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()))
    workflow = {"demo_vs_fom": {k: dict(zip(("mean", "p99", "max"), v))
                                for k, v in demo.items()},
                "bench_vs_fom": {k: dict(zip(("mean", "p99", "max"), v))
                                 for k, v in bench.items()},
                "batched_vs_solo": batched,
                "seconds": secs}
    for entries in out.values():
        entries["workflow"] = workflow
    return out


def batched_full(torch, label, solver, f, start, secs, smi):
    """[7] The batched runners of a solve that is not fully reduced
    (``solver._full``, "mixed" or "dense") at FULL_BATCH sims on the card
    from ``start``, sim b under (1 + 0.05 b) x ``f``: ``make_batched_run``
    over FULL_BATCH_STEPS[mode] steps and ``make_batched_step``, each sim
    against its solo ``run_steps`` / ``step()`` on the card within
    SOLO_DEVIATION of the extent (velocities: of the extent over dt) ->
    {call: (P, V) deviations}."""
    B = FULL_BATCH
    model, mode = solver.model, solver._full.mode
    steps = FULL_BATCH_STEPS[mode]
    pos = np.repeat(start[0][None], B, axis=0)
    vel = np.repeat(start[1][None], B, axis=0)
    fs = np.stack([f * (1.0 + 0.05 * b) for b in range(B)])
    out = {}
    for call, n in (("make_batched_run", steps), ("make_batched_step", 1)):
        solver.frame = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if call == "make_batched_run":
            p, v = solver.make_batched_run()(pos, vel, fs, n,
                                             num_iterations=ITERATIONS)
            require(solver._last_batched_path == "batched-full",
                    f"{label}: make_batched_run took "
                    f"{solver._last_batched_path}")
        else:
            p, v = solver.make_batched_step()(pos, vel, fs, ITERATIONS)
        torch.cuda.synchronize()
        secs[f"{label}: {call}, {B} sims x {n} steps"] = (
            time.perf_counter() - t0)
        extent = float(np.abs(p).max())
        worst = [0.0, 0.0]
        for b in range(B):
            model.positions, model.velocities = pos[b].copy(), vel[b].copy()
            solver.frame = 0
            if call == "make_batched_step":
                solver.step(fs[b], num_iterations=ITERATIONS)
            else:
                solver.run_steps(fs[b], n, num_iterations=ITERATIONS)
            worst = [max(worst[0], float(np.abs(model.positions - p[b]).max())
                         / extent),
                     max(worst[1], float(np.abs(model.velocities
                                                - v[b]).max())
                         * solver.dt / extent)]
        out[call] = worst
        log(f"[7] {label}: {call} ({n} step{'s' if n > 1 else ''}) at {B} "
            f"sims on the batched full-space step ({mode}): each sim at most "
            f"{worst[0]:.3e} of the extent from its solo run on the card (V: "
            f"{worst[1]:.3e} of the extent over dt; limit {SOLO_DEVIATION})"
            f" ({smi})")
        require(np.isfinite(p).all() and max(worst) <= SOLO_DEVIATION,
                f"{label}: a sim of {call} departs from its solo run")
    return out


def refuses_batched(label, solver, f):
    """[7] The host LU has no batched solve: both runners raise
    RuntimeError."""
    state = [np.repeat(x[None], 2, axis=0) for x in (
        solver.model.positions, solver.model.velocities, f)]
    for make, call in ((solver.make_batched_run, lambda r: r(*state, 2)),
                       (solver.make_batched_step, lambda r: r(*state))):
        try:
            call(make())
        except RuntimeError as e:
            require("host LU" in str(e), f"{label}: {e}")
            continue
        require(False, f"{label}: {make.__name__} served the host LU")
    log(f"[7] {label}: make_batched_run and make_batched_step raise "
        "RuntimeError (the host LU)")


def sc_scene(DeformableModel, cloth_model, rows, fold=False):
    """The cloth of ``scripts/bench_selfcollision.py`` (rows x rows, one
    unit a cell, z += 0.1 x, masses 10, floor off, tris_strain 0.95-1.05 and
    edge_spring at wi = 1e4, the left side pinned); with ``fold``, folded
    onto itself along y first (as ``tests/test_self_collision.py:51-68``
    folds its cloth), the upper half SC_GAP above the lower, every vertex
    jittered in the plane by SC_JITTER."""
    V, F = cloth_model(rows, rows)
    V = V.copy()
    if fold:
        half = (rows - 1) / 2.0
        top = V[:, 1] > half
        V[top, 1] = (rows - 1) - V[top, 1]
        V[top, 2] += SC_GAP
        V[:, :2] += np.random.default_rng(8).normal(scale=SC_JITTER,
                                                    size=(len(V), 2))
    V[:, 2] += 0.1 * V[:, 0]
    model = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                            floor_collision=False)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.add_edge_spring_constraint(wi=1e4)
    model.compute_cloth_corner_indices()
    model.fix_surface_side_vertices("left")
    return model


def sc_solver(torch, dev, model, matmul_dtype, dtype=None, mode="device"):
    """The synthetic reduced solver of ``scripts/bench_selfcollision.py``
    (r = SC_R, damping 2e-3) on ``model``, ``enable_self_collision = mode``
    captured at prepare, window cap SC_CAP."""
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    solver = synthetic_reduced_solver(
        model, r=SC_R, device=dev, dtype=dtype or torch.float32,
        matmul_dtype=matmul_dtype, extra_args={"damping": 2e-3})
    solver.enable_self_collision = mode
    solver.self_collision_window_cap = SC_CAP
    solver.prepare(solver.args)            # rebuilds the step: captures
    return solver


def same_sets(a, b):
    """Per row, whether two (n, k) candidate lists hold the same
    triangles."""
    return (a.sort(dim=1).values == b.sort(dim=1).values).all(dim=1)


def probes_vs_cpu(torch, label, q32, faces, smi):
    """The probe, the lower bound and the pass of (n, 3) float32 positions
    on the card against the same functions in float64 on the CPU from the
    same values (one shared candidate pass on each side): the per-vertex
    clearance and the pass's corrections within SC_ROUND float32
    roundings of the extent where the candidate sets agree, the bound at
    most the probe on the card -> the readings."""
    from animsnapbases_tpu_torch.sim import collisions_device as cd

    extent = float(q32.abs().max())
    tol = SC_ROUND * F32_EPS * extent
    out = {}
    t0 = time.perf_counter()
    for where, q, fc in (("card", q32, faces),
                         ("cpu", q32.double().cpu(), faces.cpu())):
        idx, delta, d, own = cd._candidate_distances(q, fc, cd.K_NEAREST,
                                                     cd.MAX_PAIRS)
        out[where] = (idx.cpu(), cd.clearances(d, own).double().cpu(),
                      (cd._push(q, delta, d, own, cd.MIN_DIST, 1.0)
                       - q).double().cpu(),
                      float(cd.min_clearance_lower_bound_device(q, fc)))
    secs = time.perf_counter() - t0
    (i32, c32, p32, b32), (i64, c64, p64, b64) = out["card"], out["cpu"]
    agree = same_sets(i32, i64)
    n_off = int((~agree).sum())
    fin = torch.isfinite(c64) & torch.isfinite(c32)
    dc = float((c32 - c64)[agree & fin].abs().max()) if bool(
        (agree & fin).any()) else 0.0
    dp = float((p32 - p64)[agree].abs().max())
    probe32, probe64 = float(c32.min()), float(c64.min())
    log(f"[8] {label}: probe {probe32:.6f} on the card (float32), "
        f"{probe64:.6f} on the CPU (float64), float32 - float64 "
        f"{probe32 - probe64:.3e}; lower bound {b32:.6f} and {b64:.6f}, "
        f"float32 - float64 {b32 - b64:.3e}; candidate sets differ at {n_off} of {len(agree)} "
        f"vertices; where they agree the clearances part by {dc:.3e} and "
        f"the corrections by {dp:.3e} (limit {tol:.3e}: {SC_ROUND} float32 "
        f"roundings of the extent {extent:.1f}); corrections "
        f"{float(p32.abs().max()):.3e} at most; {secs:.1f} s ({smi})")
    require(dc <= tol and dp <= tol,
            f"{label}: the card's probe or pass parts from float64")
    require(b32 <= probe32, f"{label}: the lower bound {b32} exceeds the "
            f"probe {probe32}")
    return {"probe": probe32, "probe_f64": probe64,
            "probe_f32_minus_f64": probe32 - probe64, "bound": b32,
            "bound_f64": b64, "bound_f32_minus_f64": b32 - b64,
            "candidate_sets_differ": n_off,
            "clearance_err": dc, "correction_err": dp}


def sc_times(torch, q, faces):
    """Milliseconds per call of the probe, the lower bound and the pass on
    (n, 3) float32 positions on the card (CUDA events, median of SC_REPS
    after one call)."""
    from animsnapbases_tpu_torch.sim import collisions_device as cd

    return {name: cuda_ms(torch, lambda fn=fn: fn(q, faces), reps=SC_REPS,
                          warmup=1)
            for name, fn in (("probe_ms", cd.min_clearance_device),
                             ("bound_ms_per_call",
                              cd.min_clearance_lower_bound_device),
                             ("pass_ms", cd.resolve_self_collision_device))}


def sc_breakdown(torch, solver, rest, fext):
    """The ring-down window again from ``rest``, each tier-1 call, lower
    bound and exact probe between two synchronizations -> {part: seconds},
    the rest of the call under "other" (the window loop's reads, the
    transfers)."""
    import animsnapbases_tpu_torch.sim.reduced as red

    spent = {"tier 1": 0.0, "lower bound": 0.0, "exact probe": 0.0}
    calls = {"tier 1": 0, "lower bound": 0, "exact probe": 0}
    real = {"min_clearance_lower_bound_device":
            red.min_clearance_lower_bound_device,
            "min_clearance_device": red.min_clearance_device}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
            calls[name] += 1
            return out
        return run

    fast = solver._resident_fast
    solver._resident_fast = timed("tier 1", fast)
    red.min_clearance_lower_bound_device = timed(
        "lower bound", real["min_clearance_lower_bound_device"])
    red.min_clearance_device = timed("exact probe",
                                     real["min_clearance_device"])
    try:
        solver.model.positions, solver.model.velocities = (
            x.copy() for x in rest)
        solver.frame = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        solver.run_steps(fext, SC_WINDOW, num_iterations=ITERATIONS)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
    finally:
        solver._resident_fast = fast
        for name, fn in real.items():
            setattr(red, name, fn)
    out = {f"{k} ({calls[k]} calls)": v for k, v in spent.items()}
    out["other"] = total - sum(spent.values())
    out["total"] = total
    return out


def sc_clear(torch, counted, paths, dev, smi):
    """[8] (a) The clear tier at full width: the bench cloth of
    ``scripts/bench_selfcollision.py`` (:func:`sc_scene`, bfloat16
    matrices) rings down over SC_WINDOW steps of ``run_steps`` (a counted
    path: kernel 5 alone), certified by tier 1; the end clearance above
    min_dist; the probe, bound and pass against float64 on the CPU
    (:func:`probes_vs_cpu`); kernel 5 against its plain version step by
    step; ``self_collision_resident = False`` (kernel 1 with the pass, a
    counted path) against the tier over SC_SHORT steps -> the kernel-5
    entry."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        affine_chunked,
        affine_chunked_plain,
    )
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    t0 = time.perf_counter()
    model = sc_scene(DeformableModel, cloth_model, SC_ROWS)
    solver = sc_solver(torch, dev, model, torch.bfloat16)
    prep = time.perf_counter() - t0
    ro, ao = solver._resident, solver._affine
    n, m = model.n_verts, len(model.faces)
    log(f"[8] (a) the clear tier: {n} vertices, {m} triangles ({n * m:.3e} "
        f"pairs), r={ao.fused.r}, prepared in {prep:.1f} s; tiers: "
        f"{solver._resident_fast_kind} tier 1, {solver._resident_kind} "
        f"contact tier ({smi})")
    rest = (model.positions.copy(), model.velocities.copy())
    zero = np.zeros_like(model.positions)
    key = f"self-collision: run_steps({SC_WINDOW}), clear"
    took = []

    def window():
        torch.cuda.synchronize()
        t = time.perf_counter()
        solver.run_steps(zero, SC_WINDOW, num_iterations=ITERATIONS)
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t)

    paths[key] = counted_path(torch, counted, f"(a) run_steps({SC_WINDOW}) "
                              "under the device pass", {"affine_chunked"},
                              window)
    windows = solver._last_sc_windows
    clearance = solver._self_collision_clearance()
    log(f"[8] (a) run_steps({SC_WINDOW}): {SC_WINDOW / took[0]:.1f} steps/s "
        f"at the entry point ({took[0]:.3f} s); windows {windows}; "
        f"_last_fast_steps {solver._last_fast_steps}; end clearance "
        f"{clearance:.6f} (min_dist {SC_MIN_DIST}) ({smi})")
    require(solver._last_fast_steps == SC_WINDOW,
            f"(a): tier 1 did not certify the window "
            f"({solver._last_fast_steps})")
    require(np.isfinite(model.positions).all()
            and np.isfinite(model.velocities).all(), "(a): non-finite state")
    require(clearance > SC_MIN_DIST, f"(a): end clearance {clearance}")

    end = (model.positions.copy(), model.velocities.copy())
    spent = sc_breakdown(torch, solver, rest, zero)
    model.positions, model.velocities = end
    log(f"[8] (a) where the window's time goes (a second run, each part "
        f"synchronized): " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                       spent.items()) + f" ({smi})")
    faces = solver._model_collide().faces
    q32 = torch.as_tensor(model.positions, dtype=torch.float32, device=dev)
    readings = probes_vs_cpu(torch, "(a) end state", q32, faces, smi)
    times = sc_times(torch, q32, faces)

    # kernel 5 against its plain version, from the window's end state
    P = solver._to_device(model.positions)
    V = solver._to_device(model.velocities)
    Fx = solver._to_device(zero)
    rb = solver._rb_extra()

    def one(fn):
        def run(P_, V_):
            o = fn(ao, P_, V_, Fx, rb, 1, ITERATIONS)
            require(o[2] == 1, f"{fn.__name__} stopped on a free step")
            return o[:2]
        return run

    k5_err, _ = step_by_step(torch, "(a) kernel 5", ro, one(affine_chunked),
                             one(affine_chunked_plain), P, V, Fx, rb,
                             SC_DEPTH)
    k5_ms = cuda_ms(torch, lambda: affine_chunked(
        ao, P, V, Fx, rb, WINDOW_STEPS, ITERATIONS), reps=5, warmup=1)
    k5_plain = cuda_ms(torch, lambda: affine_chunked_plain(
        ao, P, V, Fx, rb, SCENE_STEPS, ITERATIONS), reps=PLAIN_REPS,
        warmup=0)
    k5_bound, k5_by = bound_ms(*k5_cost(ao, WINDOW_STEPS, ITERATIONS,
                                        CHUNK_EVERY))

    # self_collision_resident=False against the tier, SC_SHORT steps from
    # the kicked rest shape: the pass is the identity here
    kick = np.zeros_like(rest[1])
    kick[~np.asarray(model.fixed_flags, bool), 2] = SC_KICK
    start = (rest[0], kick)
    model.positions, model.velocities = (x.copy() for x in start)
    solver.run_steps(zero, SC_SHORT, num_iterations=ITERATIONS)
    tier, tier_windows = model.positions.copy(), solver._last_sc_windows
    motion = float(np.abs(tier - rest[0]).max())
    solver.self_collision_resident = False
    solver.prepare(solver.args)
    model.positions, model.velocities = (x.copy() for x in start)
    key_off = "self-collision: self_collision_resident=False"
    t = time.perf_counter()
    paths[key_off] = counted_path(
        torch, counted, f"(a) self_collision_resident=False, run_steps("
        f"{SC_SHORT})", {"fused_reduced_iterations"},
        lambda: solver.run_steps(zero, SC_SHORT, num_iterations=ITERATIONS))
    off_ms = 1e3 * (time.perf_counter() - t) / SC_SHORT
    d_off = float(np.abs(model.positions - tier).max())
    log(f"[8] (a) self_collision_resident=False (kernel 1 with the pass, "
        f"{off_ms:.2f} ms a step) against the tier over {SC_SHORT} steps "
        f"from the rest shape kicked at {SC_KICK} along z: max|dP| "
        f"{d_off:.3e}, the window's largest displacement {motion:.3e} (rel "
        f"{d_off / motion:.3e}, limit {SC_OFF_REL}); the tier's windows "
        f"{[(w['path'], w['steps']) for w in tier_windows]}; windows "
        f"{solver._last_sc_windows} ({smi})")
    require(all(w["path"] == "tier 1" for w in tier_windows),
            "(a): the kicked window left tier 1")
    require(d_off <= SC_OFF_REL * motion
            and solver._last_sc_windows is None,
            "(a): self_collision_resident=False departs from the tier")
    log(f"[8] (a) kernel 5 {1e3 * k5_ms / WINDOW_STEPS:.2f} us/step over "
        f"{WINDOW_STEPS}-step calls (bound "
        f"{1e3 * k5_bound / WINDOW_STEPS:.4f} us/step, {k5_by}; plain "
        f"{1e3 * k5_plain / SCENE_STEPS:.1f} us/step); the probe "
        f"{times['probe_ms']:.2f} ms, the lower bound "
        f"{times['bound_ms_per_call']:.2f} ms, the pass "
        f"{times['pass_ms']:.2f} ms a call ({smi})")
    return dict(readings, **times, launches_path=key,
                launches=paths[key]["affine_chunked"], max_abs_err=k5_err,
                ms=k5_ms, plain_ms=k5_plain, bound_ms=k5_bound,
                bound_by=k5_by, steps_per_call=WINDOW_STEPS,
                window_steps=SC_WINDOW, steps_per_s=SC_WINDOW / took[0],
                windows=windows, window_seconds=spent,
                end_clearance=clearance,
                resident_off_ms_per_step=off_ms,
                resident_off_vs_tier=d_off / motion,
                resident_off_motion=motion, prepare_s=prep)


def sc_fold(torch, counted, paths, dev, smi):
    """[8] (b) The proximity path: the cloth folded onto itself
    (:func:`sc_scene` with ``fold``, float32 matrices), ``run_steps(
    SC_FOLD_STEPS)`` a counted path (kernel 1 with the pass; no window is
    certified); each step rebuilt from the card's state (kernel 1 on the
    card, then the pass) and held: the served run's end state bit for bit,
    the solve against one float64 step of the CPU's plain version from the
    same state within SC_STEP_TOL of the extent, the pass's corrections
    against the pass in float64 from the same positions (on the card: on
    the CPU one call takes ~10 s at this size) within SC_ROUND float32
    roundings of the extent where the candidate sets agree; the pass must
    push (the probed clearance rises toward min_dist); kernel 1 against
    float64 and timed -> the kernel-1 entry."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
        fused_reduced_iterations_plain,
    )
    from animsnapbases_tpu_torch.ops.resident import (
        force_term,
        predict,
        step_once,
    )
    from animsnapbases_tpu_torch.sim import collisions_device as cd
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    t0 = time.perf_counter()
    model = sc_scene(DeformableModel, cloth_model, SC_ROWS, fold=True)
    solver = sc_solver(torch, dev, model, torch.float32)
    cpu = sc_solver(torch, "cpu", sc_scene(DeformableModel, cloth_model,
                                           SC_ROWS, fold=True),
                    torch.float64, torch.float64, mode=False)
    prep = time.perf_counter() - t0
    ro, fo = solver._resident, solver._resident.fused
    require(np.array_equal(ro.perm, cpu._resident.perm),
            "(b): the card's and the CPU's permutations differ")
    faces = solver._model_collide().faces
    q0 = torch.as_tensor(model.positions, dtype=torch.float32, device=dev)
    probe0 = float(cd.min_clearance_device(q0, faces))
    rest = (model.positions.copy(), model.velocities.copy())
    zero = np.zeros_like(model.positions)
    key = f"self-collision: run_steps({SC_FOLD_STEPS}), fold"
    took = []

    def window():
        torch.cuda.synchronize()
        t = time.perf_counter()
        solver.run_steps(zero, SC_FOLD_STEPS, num_iterations=ITERATIONS)
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t)

    paths[key] = counted_path(torch, counted, f"(b) run_steps("
                              f"{SC_FOLD_STEPS}) on the fold",
                              {"fused_reduced_iterations"}, window)
    served = (model.positions.copy(), model.velocities.copy())
    probe1 = solver._self_collision_clearance()
    log(f"[8] (b) the fold: {model.n_verts} vertices, gap {SC_GAP}, "
        f"prepared in {prep:.1f} s (the card's solver and the CPU's); "
        f"run_steps({SC_FOLD_STEPS}) {1e3 * took[0] / SC_FOLD_STEPS:.2f} ms "
        f"a step; windows {solver._last_sc_windows}; _last_fast_steps "
        f"{solver._last_fast_steps}; probed clearance {probe0:.3e} -> "
        f"{probe1:.3e} (min_dist {SC_MIN_DIST}) ({smi})")
    require(solver._last_fast_steps is None
            and solver._last_sc_windows == [
                {"path": "per-step", "steps": SC_FOLD_STEPS}],
            "(b): the fold did not take the per-step path")
    require(probe1 > probe0, "(b): the pass did not push the layers apart")

    # each step rebuilt and held
    P = solver._to_device(rest[0])
    V = solver._to_device(rest[1])
    fa = force_term(ro, solver._to_device(zero))
    rb = solver._rb_extra()
    ro64 = cpu._resident
    fa64 = force_term(ro64, cpu._to_device(zero))
    rb64 = cpu._rb_extra()
    worst = {"solve": 0.0, "pass": 0.0, "differ": 0, "pushed": 0,
             "scale": 0.0, "half stiffness": 0.0, "nearest only": 0.0}
    t0 = time.perf_counter()
    for i in range(SC_FOLD_STEPS):
        q, _ = step_once(ro, P, V, fa, rb, ITERATIONS,
                         iterate=fused_reduced_iterations)
        q64, _ = step_once(ro64, cpu._to_device(solver._to_host(P)),
                           cpu._to_device(solver._to_host(V)), fa64, rb64,
                           ITERATIONS)
        qn = q.T                                        # permuted (N, 3)
        qn64 = q64.T.to(dev)
        fperm = solver._perm_collide_fn().faces
        # the solver's own pass (the served run's), then the float64 pass
        # from the same (float32) positions
        Pn = solver._perm_pass(q)
        out = Pn.T
        idx, delta, d, own = cd._candidate_distances(
            qn, fperm, cd.K_NEAREST, cd.MAX_PAIRS)
        q_wide = qn.double()
        idx64, delta64, d64, own64 = cd._candidate_distances(
            q_wide, fperm, cd.K_NEAREST, cd.MAX_PAIRS)
        out64 = cd._push(q_wide, delta64, d64, own64, cd.MIN_DIST, 1.0)
        agree = same_sets(idx, idx64)
        extent = float(qn64.abs().max())
        corr = (out - qn).double()
        corr64 = out64 - q_wide
        # planted faults: the pass at half stiffness, and on the nearest
        # candidate alone
        faults = {"half stiffness": cd._push(qn, delta, d, own, cd.MIN_DIST,
                                             0.5),
                  "nearest only": cd._push(qn, delta[:, :1], d[:, :1],
                                           own[:, :1], cd.MIN_DIST, 1.0)}
        worst["solve"] = max(worst["solve"],
                             max_abs(qn, qn64) / extent)
        worst["scale"] = max(worst["scale"],
                             float(corr64[agree].abs().max()))
        worst["pass"] = max(worst["pass"], float(
            (corr - corr64)[agree].abs().max()))
        for name, fq in faults.items():
            worst[name] = max(worst[name], float(
                ((fq - qn).double() - corr64)[agree].abs().max()))
        worst["differ"] = max(worst["differ"], int((~agree).sum()))
        worst["pushed"] = max(worst["pushed"],
                              int((corr.abs().sum(1) > 0).sum()))
        V = (Pn - P) / ro.dt
        P = Pn
    hold_s = time.perf_counter() - t0
    rel = {k: worst[k] / max(worst["scale"], 1e-30)
           for k in ("pass", "half stiffness", "nearest only")}
    same = bool(np.array_equal(solver._to_host(P), served[0])
                and np.array_equal(solver._to_host(V), served[1]))
    log(f"[8] (b) each of {SC_FOLD_STEPS} steps rebuilt on the card from its"
        f" state (kernel 1, then the pass): the served run's end state bit "
        f"for bit: {same}; the solve at most {worst['solve']:.3e} of the "
        f"extent from the CPU's float64 step (limit {SC_STEP_TOL}); where "
        f"the candidate sets agree the pass's corrections at most "
        f"{worst['pass']:.3e} from float64 ({rel['pass']:.3e} of the "
        f"largest correction {worst['scale']:.3e}, "
        f"{worst['pass'] / (F32_EPS * extent):.2f} float32 roundings of "
        f"the extent; limit {SC_FOLD_REL}), planted faults: half stiffness "
        f"{rel['half stiffness']:.3e}, the nearest candidate alone "
        f"{rel['nearest only']:.3e} (the sets differ at up to "
        f"{worst['differ']} vertices a step); up to {worst['pushed']} "
        f"vertices pushed a step; {hold_s:.1f} s ({smi})")
    require(same, "(b): the served run is not kernel 1 with the pass")
    require(worst["solve"] <= SC_STEP_TOL and rel["pass"] <= SC_FOLD_REL,
            "(b): a step on the card departs from float64")
    require(min(rel["half stiffness"], rel["nearest only"]) > SC_FOLD_REL,
            "(b): the pass's hold does not tell a planted fault")
    require(worst["pushed"] > 0, "(b): the pass pushed no vertex")

    # kernel 1 on the fold's first step: against float64, timed
    P0 = solver._to_device(rest[0])
    sn, rb_const = predict(ro, P0, torch.zeros_like(P0), fa, rb)
    sel = sn[:, :ro.n_sel]
    u_k = fused_reduced_iterations(fo, sel, rb_const, ITERATIONS)
    u_p = fused_reduced_iterations_plain(fo, sel, rb_const, ITERATIONS)
    u_64 = fused_reduced_iterations_plain(as_f64(fo), sel.double(),
                                          rb_const.double(), ITERATIONS)
    ok, e_k, e_p = as_accurate(u_k, u_p, u_64)
    require(ok, "(b): kernel 1 is less accurate than its plain version")
    k1_err = max_abs(u_k, u_p)
    k1_ms = cuda_ms(torch, lambda: fused_reduced_iterations(
        fo, sel, rb_const, ITERATIONS), reps=200)
    k1_dev = device_ms(torch, lambda: fused_reduced_iterations(
        fo, sel, rb_const, ITERATIONS), reps=100)
    k1_plain = cuda_ms(torch, lambda: fused_reduced_iterations_plain(
        fo, sel, rb_const, ITERATIONS), reps=PLAIN_REPS, warmup=0)
    k1_bound, k1_by = bound_ms(*k1_cost(fo, ro.n_sel, ITERATIONS))
    times = sc_times(torch, q0, faces)
    log(f"[8] (b) kernel 1: vs plain {k1_err:.3e}, vs float64 kernel "
        f"{e_k:.3e} plain {e_p:.3e}; {1e3 * k1_ms:.2f} us a call, "
        f"{1e3 * k1_dev:.2f} us a launch on the device (bound "
        f"{1e3 * k1_bound:.4f} us, {k1_by}; plain {1e3 * k1_plain:.1f} us); "
        f"on the fold the probe {times['probe_ms']:.2f} ms, the lower bound "
        f"{times['bound_ms_per_call']:.2f} ms, the pass "
        f"{times['pass_ms']:.2f} ms a call ({smi})")
    return dict(times, launches_path=key,
                launches=paths[key]["fused_reduced_iterations"],
                max_abs_err=k1_err, ms=k1_ms, device_ms=k1_dev,
                plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by,
                ms_per_step_with_pass=1e3 * took[0] / SC_FOLD_STEPS,
                probe_before=probe0, probe_after=probe1,
                solve_vs_f64=worst["solve"],
                pass_vs_f64=rel["pass"],
                pass_vs_f64_roundings=worst["pass"] / (F32_EPS * extent),
                planted_half_stiffness=rel["half stiffness"],
                planted_nearest_only=rel["nearest only"],
                candidate_sets_differ=worst["differ"],
                pushed=worst["pushed"], prepare_s=prep)


def sc_fom(torch, dev, smi):
    """[8] The full-order ``Solver`` on the small fold (the 6x12 cloth of
    ``tests/test_self_collision.py``, jittered), in ``"device"`` and True
    modes: one step each on the card (float64) from the same state as on
    the CPU, within CPU_DEVIATION of the extent; each pass pushed (the step
    without it ends elsewhere)."""
    from animsnapbases_tpu_torch.config.sim_config import default_sim_args
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.sim.solver import Solver

    rows, cols = SC_FOM
    V, F = cloth_model(rows, cols)
    V = V * 0.004
    top = V[:, 1] > (cols - 1) / 2.0 * 0.004
    V[top, 1] = (cols - 1) * 0.004 - V[top, 1]
    V[top, 2] += 0.6 * SC_MIN_DIST
    V = V + np.random.default_rng(5).normal(scale=2e-5, size=V.shape)
    args = default_sim_args()
    args.dt = 0.016
    f = np.zeros_like(V)
    f[:, 2] = -9.81 * 10.0 * 0.01
    out = {}
    for mode in ("device", True, False):
        for where, device in (("card", dev), ("cpu", "cpu")):
            model = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                                    floor_collision=False)
            model.add_edge_spring_constraint(wi=1e4)
            s = Solver(device=device)
            s.enable_self_collision = mode
            s.set_model(model)
            s.prepare(args)
            s.step(f, num_iterations=ITERATIONS)
            out[mode, where] = model.positions.copy()
    extent = float(np.abs(V).max())
    for mode in ("device", True):
        d = float(np.abs(out[mode, "card"] - out[mode, "cpu"]).max())
        push = float(np.abs(out[mode, "card"] - out[False, "card"]).max())
        log(f"[8] FOM Solver, enable_self_collision={mode!r}: one step on "
            f"the card {d / extent:.3e} of the extent from the CPU's (limit "
            f"{CPU_DEVIATION}); the passes moved it {push:.3e} ({smi})")
        require(d <= CPU_DEVIATION * extent and push > 0,
                f"FOM Solver {mode!r}: the card departs from the CPU")


def self_collision_phase(torch, counted, paths, dev, smi):
    """[8] Self-collision: (a) the clear tier at full width
    (:func:`sc_clear`), (b) the proximity path on the folded cloth
    (:func:`sc_fold`), the full-order solver's passes (:func:`sc_fom`) ->
    {kernel name: its entry under "self_collision"}."""
    from animsnapbases_tpu_torch.sim.collisions_device import MIN_DIST

    require(MIN_DIST == SC_MIN_DIST, f"the pass's distance {MIN_DIST} is "
            f"not the scenes' {SC_MIN_DIST}")
    t0 = time.perf_counter()
    k5 = sc_clear(torch, counted, paths, dev, smi)
    t1 = time.perf_counter()
    k1 = sc_fold(torch, counted, paths, dev, smi)
    t2 = time.perf_counter()
    sc_fom(torch, dev, smi)
    log(f"[8] seconds: (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, FOM "
        f"{time.perf_counter() - t2:.1f} ({smi})")
    return {"affine_chunked": k5, "fused_reduced_iterations": k1}


def diff_phase(torch, dev, smi, basis_dir, pos_path):
    """[9] Differentiable rollouts (``sim/diff.py``, float64 plain torch on
    the card, no kernel) on phase [6]'s recording and bases of the bench
    scene (r = 48), through ``demos/fit_material.py``'s pieces.  (a) The
    bench scene with DIFF_PINS positional constraints added (so that the
    targets have a gradient): one rollout of DIFF_HORIZON steps at
    DIFF_ITERS iterations from the hang state under gravity, and the
    gradient of its trajectory's mean squared displacement with respect to
    the scales, a force multiplier and the positional targets, on the card
    and again on the CPU from the same bases files, held within
    DIFF_ROUNDINGS float64 roundings of cond(Ar) (relative to the largest
    entry; the trajectory to the scene's extent); the scales' gradient
    against central differences on the card at each of DIFF_FD_EPS, the
    closest within DIFF_FD_TOL.  (b) The
    ``--bench`` fit (its defaults: 250 Adam steps, horizon 12, lr 0.05):
    fitted scales, relative errors, loss first and last, ms an Adam step,
    one rollout's forward and forward + backward in ms, the card's peak
    memory; it must converge (the script's ``ok``).  (c) The twin
    experiment (the script's default mode) end to end on the card: its
    ``ok``.  Returns the phase's readings."""
    from animsnapbases_tpu_torch.demos import fit_material as fm
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    out = {}
    t_all = time.perf_counter()
    # the --bench configuration on phase [6]'s files
    cfg = dict(fm.BENCH, modes=min(REDUCED_MODES, CONSTR_MODES),
               pos_modes=POS_MODES)

    def scene():
        return bench_scene(DeformableModel, cloth_model)

    def pinned():
        model = scene()
        free = np.flatnonzero(model.mass < 1e9)
        for vi in free[np.linspace(0, len(free) - 1, DIFF_PINS).astype(int)]:
            model.add_positional_constraint(int(vi), wi=1e5)
        return model

    # ---- (a) forward and gradients, card against CPU ---------------------
    def rollout_grads(device):
        sim, model = fm.diff_sim(pinned, cfg, basis_dir, pos_path, device)
        t = sim.tensor
        q0 = t(model.positions)
        scales = sim.ones_scales().requires_grad_(True)
        c = t(1.0).requires_grad_(True)
        targets = t(model.positional_targets(0))[None].requires_grad_(True)
        run = sim.make_rollout(DIFF_HORIZON, DIFF_ITERS,
                               save_trajectory=True)
        f = t(fm.gravity(model))
        v0 = t(model.velocities)
        _, _, traj = run(q0, v0, c * f, targets, scales)
        loss = ((traj - q0) ** 2).mean()
        loss.backward()
        Ar = sim.mass_r + torch.einsum("g,gdrs->drs", sim.ones_scales(),
                                       sim.G)
        cond = [float(torch.linalg.cond(Ar[d])) for d in range(3)]
        return (sim, model, run, (q0, v0, f, targets.detach()),
                {"trajectory": traj.detach(), "scales": scales.grad,
                 "force": c.grad, "targets": targets.grad}, cond)

    t0 = time.perf_counter()
    sim, model, run, inputs, card, cond = rollout_grads(dev)
    torch.cuda.synchronize()
    out["card_s"] = time.perf_counter() - t0
    _, _, _, _, host, _ = rollout_grads("cpu")
    gaps = {}
    for key, x in card.items():
        ref = host[key]
        gaps[key] = float((x.cpu() - ref).abs().max()
                          / max(float(ref.abs().max()), 1e-300))
    limit = DIFF_ROUNDINGS * max(cond) * float(torch.finfo(torch.float64).eps)
    log(f"[9] diff, bench scene (N={sim.n_verts}, r={sim.r}, "
        f"{DIFF_PINS} positional pins, groups {sim.group_names}): "
        f"{DIFF_HORIZON}-step rollout at {DIFF_ITERS} iterations, card "
        f"against CPU (float64 both): " + ", ".join(
            f"{k} {v:.3e}" for k, v in gaps.items())
        + f" relative (limit {limit:.3e}: {DIFF_ROUNDINGS} roundings of "
        f"cond(Ar)); cond(Ar) by dimension "
        + ", ".join(f"{c_:.3e}" for c_ in cond)
        + f"; gradients: scales {card['scales'].tolist()}, force "
        f"{float(card['force']):.6e}, targets max "
        f"{float(card['targets'].abs().max()):.3e} ({smi})")
    for key, gap in gaps.items():
        require(gap <= limit and bool(torch.isfinite(card[key]).all()),
                f"diff: the card's {key} departs from the CPU's by {gap:.3e} "
                "relative")
    q0, v0, f, targets = inputs

    def loss(scales):
        with torch.no_grad():
            traj = run(q0, v0, f, targets, scales)[2]
            return float(((traj - q0) ** 2).mean())

    ones = sim.ones_scales()
    g = card["scales"].tolist()
    fd_rel = {}
    for eps in DIFF_FD_EPS:
        fd = []
        for i in range(len(ones)):
            e = torch.zeros_like(ones)
            e[i] = eps
            fd.append((loss(ones + e) - loss(ones - e)) / (2 * eps))
        top = max(abs(x) for x in g)
        fd_rel[eps] = max(abs(a - b) for a, b in zip(g, fd)) / max(top,
                                                                  1e-300)
        log(f"[9] diff: the scales' gradient {g} against central "
            f"differences at eps {eps} on the card {fd}: largest gap "
            f"{fd_rel[eps]:.3e} of the largest entry")
    fd_best = min(fd_rel.values())
    log(f"[9] diff: central differences, the closest gap {fd_best:.3e} "
        f"(limit {DIFF_FD_TOL})")
    require(fd_best <= DIFF_FD_TOL, "diff: the scales' gradient departs "
            "from central differences at every eps")
    out.update(card_vs_cpu=gaps, card_vs_cpu_limit=limit, cond_Ar=cond,
               fd_rel=fd_rel, fd_best=fd_best)

    # ---- (b) the --bench fit ----------------------------------------------
    sim, model = fm.diff_sim(scene, cfg, basis_dir, pos_path, dev)
    t = sim.tensor
    q0, v0 = t(model.positions), t(model.velocities)
    f, targets = t(fm.gravity(model)), t(model.positional_targets(0))[None]
    steps, horizon, lr = cfg["defaults"]
    steps = DIFF_FIT_STEPS or steps
    run = sim.make_rollout(horizon, fm.ITERS, save_trajectory=True)
    scales = sim.ones_scales().requires_grad_(True)

    def forward():
        with torch.no_grad():
            run(q0, v0, f, targets, scales)

    def backward():
        ((run(q0, v0, f, targets, scales)[2] - q0) ** 2).mean().backward()

    fwd_ms = cuda_ms(torch, forward, reps=DIFF_REPS, warmup=1)
    both_ms = cuda_ms(torch, backward, reps=DIFF_REPS, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    detail, ok = fm.fit(sim, model, cfg, steps, horizon, lr)
    detail.update(forward_ms=fwd_ms, forward_backward_ms=both_ms,
                  max_memory_allocated=torch.cuda.max_memory_allocated())
    log(f"[9] diff, the --bench fit ({smi}): " + json.dumps(detail))
    require(ok, f"diff: the --bench fit did not converge (relative errors "
            f"{detail['rel_err']}, loss {detail['loss_first']:.3e} -> "
            f"{detail['loss_last']:.3e})")
    out["bench_fit"] = detail

    # ---- (c) the twin experiment, end to end ------------------------------
    t0 = time.perf_counter()
    data, ok = fm.run(False, dev, steps=DIFF_FIT_STEPS)
    data["detail"]["end_to_end_s"] = time.perf_counter() - t0
    log(f"[9] diff, the twin experiment ({smi}): " + json.dumps(data))
    require(ok, f"diff: the twin experiment did not converge "
            f"({data['detail']['rel_err']})")
    out["twin"] = data["detail"]
    out["seconds"] = time.perf_counter() - t_all
    return out


def greedy_replay(pc, R0, k):
    """``pc``'s extraction (global or local support) replayed for its
    first ``k`` steps from ``R0``, the same device steps -> (the residual
    entering step k, step k's dominant mode wk before the cone
    projection)."""
    from animsnapbases_tpu_torch.bases import greedy

    R = R0
    for i in range(k + 1):
        idx = int(greedy.select_vertex(R))
        _, wk = greedy.dominant_mode(R, idx)
        if i == k:
            return R, wk
        support = None
        if pc.support == "local":
            wk = greedy.signed_nonneg_weight(wk)
            support = pc._tensor(1.0 - pc._support_map(idx))
        R = greedy.deflate(R, wk, support)[1]


def cone_sides(wk):
    """(max of wk's positive part, max of its negative part) over max|wk|:
    the scales of the two cone projections ``signed_nonneg_weight`` weighs
    against each other after ``project_weight`` normalizes each to max 1."""
    top = float(wk.abs().max())
    return (float(wk.clamp(min=0).max()) / top,
            float((-wk).clamp(min=0).max()) / top)


def greedy_holds(label, card, cpu, R0):
    """The card's greedy extraction (``card``, a PositionComponents after
    its extraction) against the CPU's float64 run on the same snapshots
    (``cpu``; ``R0`` its snapshot tensor), on the steps whose residual
    entering them exceeds POSB_CUT of the first: step by step, the same
    pick and the same residual after it (within POSB_SIGMA relative, where
    that too exceeds the cut), up to the first step where the two part.  There the step must be one
    whose choice rounding sets, in the CPU's run replayed: a different
    pick a tie of the residual's row energies within POSB_TIE, or (local
    support) the same pick with the cone side of wk chosen by rounding,
    one side's largest entry within POSB_NOISE of max|wk| (JAX's
    ``project_weight`` normalizes that side's rounding noise to max 1, so
    the JAX code's own choice there follows its rounding).  Later steps
    follow other deflations and are not compared.  sigma0 within
    POSB_SIGMA relative on the steps before; the reconstructions W C
    within POSB_EXTENT of the snapshots' extent where the two never part
    and the CPU ran as many steps.  Where one run has fewer steps than the
    other, the steps both ran are compared -> the readings."""
    n = min(len(card.picks), len(cpu.picks))
    sig_c, res_c = card.measures_at_largeDeforVerts[:n, 1:].T
    sig_h, res_h = cpu.measures_at_largeDeforVerts[:n, 1:].T
    res_in = np.concatenate([[float(R0.norm())], res_h[:-1]])
    under = np.nonzero(res_in <= POSB_CUT * res_in[0])[0]
    n_signal = int(under[0]) if len(under) else len(res_in)
    # the residual after a step is compared where it stays above the cut
    after = res_h[:n_signal] > POSB_CUT * res_in[0]
    parted = np.nonzero(
        (card.picks[:n_signal] != cpu.picks[:n_signal])
        | (after & (np.abs(res_c[:n_signal] - res_h[:n_signal])
                    > POSB_SIGMA * res_h[:n_signal])))[0]
    held, part = n_signal, None
    if len(parted):
        held = k = int(parted[0])
        R, wk = greedy_replay(cpu, R0, k)
        if card.picks[k] != cpu.picks[k]:
            e = (R ** 2).sum(dim=(0, 2))
            short = 1.0 - float(e[int(card.picks[k])] / e.max())
            part = {"step": k, "why": "pick tie", "cpu_pick":
                    int(cpu.picks[k]), "card_pick": int(card.picks[k]),
                    "shortfall": short}
            ok = short <= POSB_TIE
        else:
            sides = cone_sides(wk)
            part = {"step": k, "why": "cone side set by rounding",
                    "pick": int(cpu.picks[k]), "positive_side": sides[0],
                    "negative_side": sides[1]}
            ok = cpu.support == "local" and min(sides) <= POSB_NOISE
        require(ok, f"{label}: the card's extraction parts from the CPU's "
                f"at step {k} where rounding does not set the choice: {part}")
    d_sig = float(np.max(np.abs(sig_c[:held] - sig_h[:held])
                         / sig_h[:held])) if held else 0.0
    require(d_sig <= POSB_SIGMA, f"{label}: sigma0 departs from the CPU's "
            f"by {d_sig:.3e} relative")
    rec = None
    if part is None and n == card.numComp:
        extent = float(R0.abs().max())
        rec = float(np.abs(card.reconstruct(card.numComp)
                           - cpu.reconstruct(cpu.numComp)).max()) / extent
        require(rec <= POSB_EXTENT, f"{label}: the reconstruction departs "
                f"from the CPU's by {rec:.3e} of the extent")
    log(f"[10] position bases, {label} ({card.numComp} components, the "
        f"CPU's run {n} steps): the card's steps equal the CPU's (pick, "
        f"residual after) on {held} of the {n_signal} steps above the cut "
        f"({n - n_signal} steps under it: residual <= {POSB_CUT} of the "
        f"first, not compared); parted at {part}; sigma0 within "
        f"{d_sig:.3e} relative (limit {POSB_SIGMA}); reconstruction "
        + (f"within {rec:.3e} of the extent (limit {POSB_EXTENT})"
           if rec is not None else "not compared (the paths parted)"
           if part is not None else "not compared (the CPU's run was "
           "cut)")
        + f"; sigma0 first/last {sig_h[0]:.4e}/{sig_h[-1]:.4e}, residual "
        f"last {res_h[-1]:.3e}")
    return {"steps_above_cut": n_signal, "steps_held": held, "parted": part,
            "sigma0_rel": d_sig, "reconstruction": rec, "steps_replayed": n}


def position_phase(torch, counted, paths, dev, smi, work, pod_vs_fom=None):
    """[10] The reference's position-bases workflow
    (``configs/examples/bunny_gFall_posSubspace.json`` through
    ``cli.run_position_pipeline``'s steps) on the card from the port's own
    recording, with the bench cloth in place of the bunny: the bench scene
    recorded by ``Solver`` (host LU) for POSB_FRAMES frames at phase [6]'s
    settings (its first FOM_FRAMES frames held bit for bit against phase
    [6]'s ``card/traj.npy`` under ``work``); every 2nd frame (the config's
    increment, up to its 100 frames) imported (``import_frames``: float32,
    zero-area triangles and small components dropped, normalized) and
    aligned ``_centered`` on the card (``align_frames``; planar frames by
    the rank-2 rule); the snapshots (Volkwein masses, standardized,
    geodesics prefactored); global PCA (the config's 100 components),
    local-support PCA (0.1-0.5) and SPLOCS (the config's 10 iterations of
    10 ADMM steps, lambda 2, rho 10, from the local components) on the
    card, each held against the CPU's float64 run on the same arrays (the
    extractions step by step up to a step whose choice rounding sets,
    :func:`greedy_holds`; the aligned frames; the SPLOCS energies); the
    global components post-processed (U^T M U = I held), their first
    POSB_SERVE served as the position basis on phase [6]'s constraint
    bases (``work/card/bases``) at its configuration (f32 state, POSB_MATMUL
    matrices): ``run_steps(FOM_FRAMES)`` from the hang state and one
    ``step()``, a counted path (kernels 1 and 5), the reduced-vs-FOM
    statistic beside phase [6]'s POD basis (``pod_vs_fom``); kernel 1
    against float64 and kernel 5 step by step and in carried steps against
    its plain version, both timed.  No h5py: the recording stays in memory.
    Returns {kernel name: its "position_bases" readings}."""
    import copy

    from animsnapbases_tpu_torch.bases.pca import PositionComponents
    from animsnapbases_tpu_torch.bases.pipeline import (
        fom_deviation,
        record_fom,
        reduced_args,
    )
    from animsnapbases_tpu_torch.bases.position_reduction import (
        save_position_basis,
    )
    from animsnapbases_tpu_torch.config.bases_config import BasesConfig
    from animsnapbases_tpu_torch.device import PIPELINE_DTYPE
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.geometry.procrustes import (
        RANK2_RTOL,
        align_frames,
        procrustes_transforms,
    )
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        affine_chunked,
        affine_chunked_plain,
    )
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
        fused_reduced_iterations_plain,
    )
    from animsnapbases_tpu_torch.ops.resident import force_term, predict
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver
    from animsnapbases_tpu_torch.snapshots.pipeline import import_frames
    from animsnapbases_tpu_torch.snapshots.position import PositionSnapshots
    from animsnapbases_tpu_torch.utils.checks import utmu_orthogonality_error

    dt = 0.016
    secs, out = {}, {}
    held = {"CPU reruns": 0.0}
    reruns = {}

    def scene():
        return bench_scene(DeformableModel, cloth_model)

    def rerun(stage, fn):
        """The CPU's float64 run of a stage, for the holds (not a stage)."""
        t0 = time.perf_counter()
        res = fn()
        t = time.perf_counter() - t0
        held["CPU reruns"] += t
        reruns[stage] = reruns.get(stage, 0.0) + t
        return res

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return res

    param = BasesConfig.from_json(POSB_CONFIG, results_dir=os.path.join(
        work, "position results"))
    for key, value in POSB_OVERRIDES.items():
        setattr(param, key, value)
    reduced = ["the bunny mesh (absent) -> the bench cloth (14,400 vertices "
               "at full size)", "the .off sequence and .h5 files -> the "
               "recording in memory (import_frames, no h5py)",
               "local PCA and SPLOCS at the config's component count on "
               "the same snapshots (the config asks global PCA only)",
               "the test animation not imported (the bases read the train "
               "frames only)"]
    log(f"[10] position bases: {POSB_CONFIG} ({param.vertPos_numFrames} "
        f"frames at increment {param.frame_increment}, {param.preAlignement}"
        f", rest {param.vertPos_rest_shape}, Volkwein "
        f"{param.q_massWeight}, standardized {param.q_standarize}, "
        f"orthogonalized {param.q_orthogonal}, support "
        f"{param.vertPos_smooth_min_dist}-{param.vertPos_smooth_max_dist}, "
        f"{param.vertPos_numComponents} components, SPLOCS "
        f"{param.splocs_max_itrs}x{param.splocs_admm_num_itrs} lambda "
        f"{param.splocs_lambda} rho {param.splocs_rho}); reduced: "
        + json.dumps(reduced))

    # ---- record: the bench scene for POSB_FRAMES frames ------------------
    model = scene()
    f = gravity(model)
    traj, _ = timed("record", lambda: record_fom(
        model, f, None, POSB_FRAMES, FOM_ITERS, dt, BENCH_DAMPING,
        device=dev))
    first = np.load(os.path.join(work, "card", "traj.npy"))
    same = bool(np.array_equal(traj[:len(first)], first))
    log(f"[10] position bases: recorded {POSB_FRAMES} frames at {FOM_ITERS} "
        f"iterations on the card in {secs['record']:.2f} s; its first "
        f"{len(first)} frames equal phase [6]'s recording bit for bit: "
        f"{same}")
    require(same, "the recording's first frames differ from phase [6]'s")

    # ---- import and align, card against CPU ------------------------------
    frames = traj[::param.frame_increment][:param.vertPos_numFrames]
    verts, tris, _, _ = import_frames(frames, model.faces)

    def align(device):
        v = torch.as_tensor(verts, dtype=PIPELINE_DTYPE, device=device)
        return align_frames(v, param.rigid), procrustes_transforms(
            v, v[0])[2]

    card_al, card_s = timed("align", lambda: align(dev))
    cpu_al, cpu_s = rerun("align", lambda: align("cpu"))
    extent = float(np.abs(verts).max())
    d_al = float((card_al.cpu() - cpu_al).abs().max()) / extent
    ratio_c = (card_s[:, 2] / card_s[:, 0]).cpu().numpy()
    ratio_h = (cpu_s[:, 2] / cpu_s[:, 0]).numpy()
    rank2 = ratio_h < RANK2_RTOL
    log(f"[10] position bases: aligned {len(verts)} frames on the card "
        f"({param.preAlignement}) in {secs['align']:.3f} s; against the "
        f"CPU {d_al:.3e} of the extent (limit {POSB_EXTENT}); rank-2 frames "
        f"(s3/s1 < {RANK2_RTOL}) card {int((ratio_c < RANK2_RTOL).sum())}, "
        f"CPU {int(rank2.sum())}, largest s3/s1 among them "
        f"{ratio_h[rank2].max() if rank2.any() else 0.0:.3e}, smallest "
        f"among the others "
        f"{ratio_h[~rank2].min() if (~rank2).any() else float('inf'):.3e}")
    require(d_al <= POSB_EXTENT and bool(
        np.array_equal(ratio_c < RANK2_RTOL, rank2)),
        "the card's aligned frames depart from the CPU's")
    aligned = card_al.cpu().numpy().astype(np.float32)
    out["align"] = {"vs_cpu": d_al, "rank2_frames": int(rank2.sum())}

    # ---- snapshots and the geodesic prefactor (host) ---------------------
    snaps = timed("geodesic prefactor", lambda: PositionSnapshots.from_arrays(
        aligned, tris, rest_shape=param.vertPos_rest_shape,
        masses_file=param.vertPos_masses_file,
        standardize=param.q_standarize, mass_weight=param.q_massWeight))
    R0 = torch.as_tensor(snaps.snapTensor, dtype=PIPELINE_DTYPE)

    def components(support, device):
        p = copy.copy(param)
        p.q_support = support
        p.vertPos_bases_type = "PCA"
        return PositionComponents(p, snaps, device=device)

    # ---- global and local PCA, card against CPU --------------------------
    runs = {}
    for label, support, stage in (("global PCA", "global", "global PCA"),
                                  ("local PCA", "local", "local PCA")):
        card = components(support, dev)
        timed(stage, card.extract_k_components)
        cpu = components(support, "cpu")
        rerun(stage, cpu.extract_k_components)
        out[stage] = greedy_holds(label, card, cpu, R0)
        runs[support] = card

    # ---- SPLOCS from the local components, card against CPU --------------
    history = []
    for device in (dev, "cpu"):
        p = copy.copy(param)
        p.q_support, p.vertPos_bases_type = "local", "SPLOCS"
        sp = PositionComponents(p, snaps, device=device)
        sp.comps = runs["local"].comps.copy()
        sp.weigs = runs["local"].weigs.copy()
        run = lambda: sp.splocs_glob_optimization(  # noqa: E731
            param.splocs_max_itrs, param.splocs_admm_num_itrs)
        if device == dev:
            timed("SPLOCS", run)
            splocs_card = sp
        else:
            rerun("SPLOCS", run)
        history.append(np.array(sp.splocs_history)[:, 1:])
    h_card, h_cpu = history
    require(h_card.shape == h_cpu.shape, "the card's SPLOCS history and the "
            "CPU's differ in length")
    d_e = float(np.max(np.abs(h_card - h_cpu) / np.abs(h_cpu)))
    log(f"[10] position bases, SPLOCS ({param.splocs_max_itrs} iterations "
        f"on the card and the CPU): energy {h_card[0, 0]:.6e} -> "
        f"{h_card[-1, 0]:.6e}, E_rms {h_card[0, 1]:.4e} -> "
        f"{h_card[-1, 1]:.4e}; the card's history within {d_e:.3e} "
        f"relative of the CPU's (limit {POSB_ENERGY}); "
        f"sparsity (zero share by dimension) "
        f"{[round(float(x), 4) for x in (splocs_card.comps == 0).mean(axis=(0, 1))]}")
    require(d_e <= POSB_ENERGY, "the card's SPLOCS energies depart from the "
            "CPU's")
    out["SPLOCS"] = {"energy_rel": d_e, "energy": h_card[:, 0].tolist(),
                     "iterations_replayed": len(h_cpu)}

    # ---- post-process the global components ------------------------------
    pca = runs["global"]
    timed("post-process", pca.post_process_components)
    err = utmu_orthogonality_error(pca.comps, snaps.mass)
    ortho = pca.is_utmu_orthogonal()
    log(f"[10] position bases: post-processed {pca.numComp} global "
        f"components in {secs['post-process']:.3f} s: U^T M U = I within "
        f"{err:.3e} (is_utmu_orthogonal {ortho}), rank-deficient dimensions "
        f"{getattr(pca, 'rank_deficient_dims', [])}, linearly independent "
        f"{pca.linear_independent}")
    require(ortho, "the post-processed components are not M-orthonormal")

    # ---- serve the first POSB_SERVE components on kernels 1 and 5 -------
    pos_path = os.path.join(work, "pca_pos_basis.npz")
    save_position_basis(pos_path, pca.comps[:POSB_SERVE])
    args = reduced_args(os.path.join(work, "card", "bases"), pos_path,
                        min(REDUCED_MODES, CONSTR_MODES), POSB_SERVE, dt,
                        BENCH_DAMPING)
    model = scene()
    solver = AnimSnapBasesSolver(args, device=dev, dtype=torch.float32,
                                 matmul_dtype=getattr(torch, POSB_MATMUL))
    solver.resident_contact_mode = False
    solver.set_model(model)
    timed("prepare", lambda: solver.prepare(args))
    entry = model.positions.copy()
    state = {}

    def serve():
        t0 = time.perf_counter()
        solver.run_steps(f, FOM_FRAMES, num_iterations=FOM_ITERS)
        state["after"] = model.positions.copy()
        solver.step(f, num_iterations=FOM_ITERS)
        secs["serve"] = time.perf_counter() - t0

    launch_path = (f"position bases: run_steps({FOM_FRAMES}) + step on the "
                   "PCA basis")
    paths[launch_path] = counted_path(
        torch, counted, f"the PCA position basis (prepare -> run_steps("
        f"{FOM_FRAMES}) + step())", {"fused_reduced_iterations",
                                     "affine_chunked"}, serve)
    require(solver._resident_fast_kind == "chunked"
            and solver._resident_kind == "affine",
            "the PCA-basis solver is not on the bench tiers")
    require(np.isfinite(state["after"]).all()
            and np.isfinite(model.positions).all(),
            "the reduced solve on the PCA basis left non-finite state")
    mean, p99, top = fom_deviation(state["after"], traj[FOM_FRAMES - 1])
    out["vs_fom"] = {"mean": mean, "p99": p99, "max": top}
    log(f"[10] position bases, served (r = {POSB_SERVE}, f32 state, "
        f"{POSB_MATMUL} matrices, phase [6]'s constraint bases): prepare "
        f"{secs['prepare']:.2f} s; reduced-vs-FOM after {FOM_FRAMES} steps "
        f"(|P - P_FOM| / max|P_FOM|): mean {mean:.4f}, p99 {p99:.4f}, max "
        f"{top:.4f}; phase [6]'s POD basis: "
        + (", ".join(f"{k} {v:.4f}" for k, v in pod_vs_fom.items())
           if pod_vs_fom else "not given"))

    # ---- kernels 1 and 5 on the PCA basis --------------------------------
    t_k = time.perf_counter()
    ro, ao = solver._resident, solver._affine
    fo = ro.fused
    Pg = solver._to_device(entry)
    Vg = torch.zeros_like(Pg)
    Fx = solver._to_device(f)
    rb = solver._rb_extra()
    sn, rb_const = predict(ro, Pg, Vg, force_term(ro, Fx), rb)
    sel = sn[:, :ro.n_sel]
    u_k = fused_reduced_iterations(fo, sel, rb_const, ITERATIONS)
    u_p = fused_reduced_iterations_plain(fo, sel, rb_const, ITERATIONS)
    u_64 = fused_reduced_iterations_plain(as_f64(fo), sel.double(),
                                          rb_const.double(), ITERATIONS)
    ok, e_k, e_p = as_accurate(u_k, u_p, u_64)
    k1_err = max_abs(u_k, u_p)
    log(f"[10] position bases, kernel 1 (hang state under gravity): vs "
        f"plain max abs {k1_err:.3e} (max|u| {float(u_p.abs().max()):.3e}); "
        f"vs float64: kernel {e_k:.3e}, plain {e_p:.3e} (limit "
        f"{ACC_RATIO}x)")
    require(bool(torch.isfinite(u_k).all()) and ok, "kernel 1 is less "
            "accurate than its plain version on the PCA basis")

    def one(fn):
        def run(P_, V_):
            o = fn(ao, P_, V_, Fx, rb, 1, ITERATIONS)
            require(o[2] == 1, f"{fn.__name__} stopped on a free step")
            return o[:2]
        return run

    k5_err, _ = step_by_step(
        torch, "position bases, kernel 5 (hang state under gravity)", ro,
        one(affine_chunked), one(affine_chunked_plain), Pg, Vg, Fx, rb,
        SCENE_STEPS)
    err, _ = carried_steps(
        torch, "position bases, kernel 5 (hang state under gravity), "
        "carried steps", 5, ao, affine_chunked_plain, Pg, Vg, Fx, rb,
        SCENE_STEPS, CHUNK_EVERY)
    k5_err = max(k5_err, err)
    k1_ms = cuda_ms(torch, lambda: fused_reduced_iterations(
        fo, sel, rb_const, ITERATIONS), reps=200)
    k1_plain = cuda_ms(torch, lambda: fused_reduced_iterations_plain(
        fo, sel, rb_const, ITERATIONS), reps=PLAIN_REPS, warmup=0)
    k5_ms = cuda_ms(torch, lambda: affine_chunked(
        ao, Pg, Vg, Fx, rb, SCENE_STEPS, ITERATIONS), reps=10, warmup=1)
    k5_plain = cuda_ms(torch, lambda: affine_chunked_plain(
        ao, Pg, Vg, Fx, rb, SCENE_STEPS, ITERATIONS), reps=PLAIN_REPS,
        warmup=0)
    trips = bound_trips(ao, Pg, Vg, Fx, rb, SCENE_STEPS)
    k1_bound, k1_by = bound_ms(*k1_cost(fo, ro.n_sel, ITERATIONS))
    k5_bound, k5_by = bound_ms(*k5_cost(ao, SCENE_STEPS, ITERATIONS,
                                        CHUNK_EVERY, exact_steps=trips))
    log(f"[10] position bases, times ({smi}): kernel 1 "
        f"{1e3 * k1_ms:.2f} us a call (bound {1e3 * k1_bound:.4f}, {k1_by}; "
        f"plain {1e3 * k1_plain:.1f}); kernel 5 "
        f"{1e3 * k5_ms / SCENE_STEPS:.2f} us/step in {SCENE_STEPS}-step "
        f"calls (bound {1e3 * k5_bound / SCENE_STEPS:.4f}, {k5_by}, its "
        f"floor bound tripping on {trips} of {SCENE_STEPS} steps; plain "
        f"{1e3 * k5_plain / SCENE_STEPS:.1f}); umax {ao.umax:.4f}")
    held["kernel holds and times"] = time.perf_counter() - t_k
    log("[10] position bases seconds (" + smi + "): " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()) + "; beside the stages, "
        "for the holds: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     held.items()) + " (CPU reruns: "
        + ", ".join(f"{k} {v:.2f}" for k, v in reruns.items()) + ")")
    common = {"launches_path": launch_path, "vs_fom": out["vs_fom"],
              "pod_vs_fom": pod_vs_fom, "stage_s": secs, "holds_s": held,
              "matmul_dtype": POSB_MATMUL, "r": POSB_SERVE,
              "holds": {k: v for k, v in out.items() if k != "vs_fom"},
              "cpu_reruns_s": reruns, "library_ms": None}
    return {
        "fused_reduced_iterations": dict(
            common, launches=paths[launch_path]["fused_reduced_iterations"],
            max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain,
            bound_ms=k1_bound, bound_by=k1_by),
        "affine_chunked": dict(
            common, launches=paths[launch_path]["affine_chunked"],
            max_abs_err=k5_err, ms=k5_ms, steps_per_call=SCENE_STEPS,
            plain_ms=k5_plain, plain_steps_per_call=SCENE_STEPS,
            bound_ms=k5_bound, bound_by=k5_by, bound_trips=trips,
            umax=ao.umax)}


def have_matplotlib():
    """Whether matplotlib imports on this host (the phase draws only
    there; drawing is host plotting, not the device path)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def scen_config(work, name, reduction=None, **directories):
    """SCEN_CONFIG with its cloth replaced by SCEN_SYSTEM, the entries of
    its ``constraint_projetions_reduction`` section by ``reduction`` and of
    its ``directories`` by ``directories``, written under ``work`` -> its
    path."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, SCEN_CONFIG)) as fp:
        cfg = json.load(fp)
    cfg["system"]["Cloth"].update(SCEN_SYSTEM)
    cfg["constraint_projetions_reduction"].update(reduction or {})
    cfg["directories"].update(directories)
    path = os.path.join(work, name)
    with open(path, "w") as fp:
        json.dump(cfg, fp, indent=1)
    return path


def scen_event_holds(label, traj, config, solver_name, dt, secs):
    """Each event of SCEN_EVENTS that the run crossed: the card's state at
    that frame (positions ``traj[e - 1]``, velocities (traj[e - 1] -
    traj[e - 2]) / dt, as the card computed them) through the event and
    SCEN_HOLD_STEPS frames on the CPU, by the same scenario driver, held
    within CPU_DEVIATION of the scene's extent of the card's frames ->
    {event: deviation}."""
    from animsnapbases_tpu_torch.config.sim_config import SimConfig
    from animsnapbases_tpu_torch.demos.scenarios import build_scenario

    out = {}
    t0 = time.perf_counter()
    extent = float(np.abs(traj).max())
    for e in SCEN_EVENTS:
        if e + SCEN_HOLD_STEPS > len(traj) or e < 2:
            continue
        params = SimConfig(config)
        args = params.build_args()
        args.solver = solver_name
        args.output_dir = os.path.join(os.path.dirname(config),
                                       f"cpu {label} {e}")
        d = build_scenario(SCEN_NAME, args, params=params, device="cpu")
        d._frame0()
        for ev in sorted(k for k in d.schedule
                         if isinstance(k, int) and k < e):
            d.schedule[ev](d)
        d.model.positions = traj[e - 1].copy()
        d.model.velocities = (traj[e - 1] - traj[e - 2]) / dt
        d.solver.frame = e
        d.solver.set_dirty()
        d.run(max_frames=e + SCEN_HOLD_STEPS)
        cpu = np.array(d.trajectory)
        out[e] = float(np.abs(cpu - traj[e:e + SCEN_HOLD_STEPS]).max()
                       ) / extent
    secs[f"{label}: CPU holds"] = time.perf_counter() - t0
    log(f"[11] scenarios, {label}: at each event the card's state through "
        f"the event and {SCEN_HOLD_STEPS} frames on the CPU: "
        + ", ".join(f"frame {e}: {v:.3e}" for e, v in out.items())
        + f" of the scene's extent (limit {CPU_DEVIATION})")
    require(all(v <= CPU_DEVIATION for v in out.values()),
            f"{label}: a frame on the card departs from the CPU's at an "
            "event")
    return out


def scen_bases_holds(g, cc, cpu):
    """The card's bases of group ``g`` (``cc``) against the CPU's run of
    the same config (``cpu``): the standardized components less the mean
    and scaled back are the POD's modes, held within :func:`pod_bounds`
    after aligning each mode's sign with the CPU's; the CPU's components
    rebuilt from its modes in the card's signs and its DEIM run again on
    them, the card's picks equal or ties (:func:`deim_picks_agree`) ->
    the readings."""
    import copy

    def modes(c):
        sn = c.nonlinearSnapshots
        return (c.comps - sn.mean[np.newaxis]) * sn.pre_scale_factor

    # the rank cut (singular values above 1e-12 of the first) may fall
    # on either side of a mode that rounding sets: one whose singular
    # value the Gram method cannot resolve (its bound as large as itself)
    K = min(cc.numComp, cpu.numComp)
    ds_all, _ = pod_bounds(cpu.singVals, max(cc.numComp, cpu.numComp))
    cut_ok = bool((ds_all[K:] >= cpu.singVals[K:len(ds_all)]).all())
    raw_c, raw_h = modes(cc)[:K], modes(cpu)[:K]
    sign = np.where((raw_c * raw_h).sum(axis=(1, 2)) < 0, -1.0, 1.0)
    ds, du = pod_bounds(cpu.singVals, K)
    d_u = np.abs(raw_c - sign[:, None, None] * raw_h).reshape(K, -1).max(
        axis=1)
    d_s = np.abs(cc.singVals[:K] - cpu.singVals[:K])
    sn = cpu.nonlinearSnapshots
    ref = copy.copy(cpu)
    ref.comps = (sign[:, None, None] * raw_h / sn.pre_scale_factor
                 + sn.mean[np.newaxis])
    ref.numComp = K
    ref._comps_device = None
    ref.deim()
    mode_diff = sign_aligned_diff(ref.comps, cc.comps[:K])
    picks = np.asarray(cc.geom_Pt)[:K]
    ok, ties = deim_picks_agree(ref.comps, ref.geom_Pt, picks, mode_diff)
    log(f"[11] scenarios, {g}: the card's bases against the CPU's "
        f"({cc.numComp} and {cpu.numComp} modes above the rank cut; "
        f"{K} compared, {int((sign < 0).sum())} of opposite sign): picks "
        f"equal on {int((picks == np.asarray(ref.geom_Pt)).sum())} of "
        f"{len(ref.geom_Pt)}, ties (step, CPU pick, card pick, shortfall) "
        f"{ties}; modes within {d_u.max():.3e} (at most "
        f"{(d_u / du).max():.3e} of the bound), singular values within "
        f"{(d_s / cpu.singVals[:K]).max():.3e} relative (at most "
        f"{(d_s / ds).max():.3e} of the bound); the modes past the shorter "
        f"rank set by rounding: {cut_ok}")
    require(cut_ok, f"{g}: the card's rank cut is not the CPU's")
    require(ok, f"{g}: the card's DEIM picks are not the CPU's greedy "
            "picks")
    require(bool((d_u <= du).all() and (d_s <= ds).all()),
            f"{g}: the card's POD departs from the CPU's beyond the "
            "rounding of the Gram method")
    return {"modes": [cc.numComp, cpu.numComp],
            "opposite_signs": int((sign < 0).sum()), "ties": ties,
            "mode_vs_bound": float((d_u / du).max())}


def scen_demo(dev, work, secs, smi):
    """(a) SCEN_NAME through the port's command lines at the reference's
    size: ``sim_cli`` records it (``Solver``, p-snapshots and ``.off``
    positions), ``cli.main`` builds each group's bases from its
    ``cloth_automated_deim_*`` example config pointed at the recording
    (npz, convergence CSVs, ``function_timings.txt``; the figures where
    matplotlib imports), ``sim_cli`` replays the scenario on those bases
    with the positions full (the dense Cholesky on the card), and the
    accuracy of the two ``.off`` sequences (``compute_accuracy``).  Held:
    each event through SCEN_HOLD_STEPS frames on the CPU
    (:func:`scen_event_holds`, the recording and the replay), each
    group's bases against the CPU's run of its config
    (:func:`scen_bases_holds`), the CSV against
    ``compute_accuracy_arrays`` on the in-memory trajectories -> the
    phase's state for (b)."""
    import csv
    import shutil

    from animsnapbases_tpu_torch import cli as bases_cli
    from animsnapbases_tpu_torch import sim_cli
    from animsnapbases_tpu_torch.analysis.accuracy import (
        compute_accuracy,
        compute_accuracy_arrays,
    )
    from animsnapbases_tpu_torch.analysis.figures import (
        nonlinearity_diagnostics,
    )
    from animsnapbases_tpu_torch.bases.pipeline import example_config
    from animsnapbases_tpu_torch.utils.timing import global_timer

    root = os.path.dirname(os.path.abspath(__file__))
    draw = have_matplotlib()
    dev_flags = ["--cpu"] if dev.type == "cpu" else []
    frames = ["--max-frames", str(SCEN_FRAMES)] if SCEN_FRAMES else []
    config = scen_config(work, "demo.json")
    fom_out = os.path.join(work, "fom")
    t0 = time.perf_counter()
    fom = sim_cli.cli(["--example", SCEN_NAME, "--config", config,
                       "--solver", "Solver", "--record", "--record-positions",
                       "--output", fom_out] + frames + dev_flags)
    secs["(a) record"] = time.perf_counter() - t0
    model = fom.model
    traj = np.array(fom.trajectory)
    dt = fom.args.dt
    log(f"[11] scenarios, (a) {SCEN_NAME} ({SCEN_CONFIG}: "
        f"{model.n_verts} vertices, events at {list(SCEN_EVENTS)}) recorded "
        f"by sim_cli in {secs['(a) record']:.2f} s: {len(traj)} frames "
        f"({fom.solver._mode} global solve), "
        f"{len(os.listdir(fom.pos_dir))} .off files, p-snapshots "
        f"{sorted(f for f in os.listdir(fom.record_path) if f.endswith('_p.npz'))}"
        f" ({smi})")
    require(np.isfinite(traj).all(), "the recording is not finite")
    holds = {"record": scen_event_holds("(a) recording", traj, config,
                                        "Solver", dt, secs)}

    # ---- the bases CLI on the three example configs ----------------------
    # where the sim config's reduction reads them: its directory, then its
    # type's name and properties (the properties emptied)
    basis_root = os.path.join(work, "bases") + os.sep
    basis_dir = basis_root + fom.args.constraint_projection_basis_type
    groups, bases_holds = {}, {}
    for g, tag in CLOTH_KINDS.items():
        json_path = os.path.join(root, CLOTH_EXAMPLE.format("deim", tag))
        param = example_config(json_path, fom.record_path, fom_out,
                               **SCEN_OVERRIDES)
        if not draw:
            param.run_geom_tests = False
        global_timer().records.clear()
        t0 = time.perf_counter()
        cc = bases_cli.main(param, device=dev)["constproj"]
        if not draw:
            nonlinearity_diagnostics(cc, pca_tests=False,
                                     postProcess_tests=True, geom_tests=True,
                                     steps=1)
        secs[f"(a) bases, {g}"] = time.perf_counter() - t0
        outd = param.constProj_output_directory
        made = sorted(os.listdir(outd))
        npz = os.path.join(
            outd, "components_interpol_alphas_interpol_verts_interpol_"
            "alpha_ranges.npz")
        csvs = [f for f in made if f.endswith("_convergence_tests_train.csv")
                or f.endswith("_convergence_tests_test.csv")]
        require(os.path.exists(npz) and len(csvs) == 2 and
                "function_timings.txt" in made,
                f"{g}: the bases CLI did not write its npz, CSVs and timings "
                f"({made})")
        gdir = os.path.join(basis_dir, g)
        os.makedirs(gdir, exist_ok=True)
        shutil.copy(npz, os.path.join(gdir, "basis.npz"))
        groups[g] = cc
        log(f"[11] scenarios, (a) cli.main on {os.path.basename(json_path)}: "
            f"{cc.numComp} components, {len(cc.geom_Pt)} DEIM rows, in "
            f"{secs[f'(a) bases, {g}']:.2f} s; wrote {made} "
            f"({'figures drawn' if draw else 'no matplotlib: CSVs only'})")
        # the same config on the CPU, its mesh copied beside it
        cpu_work = os.path.join(work, "cpu bases")
        mesh = os.path.relpath(param.tri_mesh_file, fom_out)
        os.makedirs(os.path.dirname(os.path.join(cpu_work, mesh)),
                    exist_ok=True)
        shutil.copy(param.tri_mesh_file, os.path.join(cpu_work, mesh))
        cpu_param = example_config(json_path, fom.record_path, cpu_work,
                                   **SCEN_OVERRIDES)
        cpu_param.run_geom_tests = False
        t0 = time.perf_counter()
        cpu = bases_cli.run_constproj_pipeline(cpu_param, device="cpu")
        secs[f"(a) CPU bases, {g}"] = time.perf_counter() - t0
        bases_holds[g] = scen_bases_holds(g, cc, cpu)
    holds["bases"] = bases_holds

    # ---- the reduced replay through sim_cli, positions full --------------
    replay_config = scen_config(
        work, "replay.json", geom_interpolation_basis_dir=basis_root,
        geom_interpolation_basis_file="basis.npz",
        reduction={"properties": ""})
    replay_out = os.path.join(work, "replay")
    t0 = time.perf_counter()
    rep = sim_cli.cli(["--example", SCEN_NAME, "--config", replay_config,
                       "--solver", "animSnapBasesSolver",
                       "--record-positions", "--output", replay_out]
                      + frames + dev_flags)
    secs["(a) replay"] = time.perf_counter() - t0
    traj_r = np.array(rep.trajectory)
    require(rep.solver._full is not None and rep.solver._full.mode == "dense",
            "the replay is not on the dense Cholesky")
    require(np.isfinite(traj_r).all() and len(traj_r) == len(traj),
            "the replay is not finite or not as long as the recording")
    holds["replay"] = scen_event_holds(
        "(a) replay", traj_r, replay_config, "animSnapBasesSolver", dt,
        secs)

    # ---- on-mesh accuracy of the two .off sequences -----------------------
    t0 = time.perf_counter()
    acc_dir = os.path.join(work, "accuracy")
    rows = compute_accuracy(os.path.join(fom.pos_dir, "pos_%d.off"),
                            os.path.join(rep.pos_dir, "pos_%d.off"),
                            range(len(traj)), out_dir=acc_dir)
    secs["(a) accuracy"] = time.perf_counter() - t0
    with open(os.path.join(acc_dir, "on_mesh_accuracy.csv")) as fp:
        written = list(csv.DictReader(fp))
    mem, l2, ang = compute_accuracy_arrays(traj, traj_r, model.faces)
    dev_csv = max(
        max(abs(float(w[k]) - m[k]) / max(abs(m[k]), 1e-300)
            for k in ("rel_l2", "normal_angle"))
        for w, m in zip(written, mem))
    log(f"[11] scenarios, (a) replay (deim_pod_vectorized, positions full) "
        f"in {secs['(a) replay']:.2f} s; on-mesh accuracy of the .off "
        f"sequences ({len(rows)} frames, {secs['(a) accuracy']:.2f} s): "
        f"mean rel-L2 {np.mean([r['rel_l2'] for r in rows]):.4e}, mean "
        f"normal angle {np.mean([r['normal_angle'] for r in rows]):.4f} rad"
        f", last frame {rows[-1]['rel_l2']:.4e} / "
        f"{rows[-1]['normal_angle']:.4f}; the CSV against the in-memory "
        f"trajectories within {dev_csv:.3e} relative (limit {CSV_RTOL})")
    require(len(written) == len(mem) == len(traj)
            and [int(w["frame"]) for w in written] == list(range(len(traj)))
            and dev_csv <= CSV_RTOL,
            "the accuracy CSV departs from the in-memory trajectories")
    return types.SimpleNamespace(
        fom=fom, traj=traj, replay=traj_r, basis_root=basis_root,
        basis_dir=basis_dir, fom_out=fom_out, draw=draw, holds=holds,
        dt=dt, accuracy={"mean_rel_l2": float(np.mean(l2.mean(axis=1))),
                         "mean_normal_angle": float(np.mean(ang.mean(
                             axis=1)))})


def scen_k1_entry(torch, label, seg, iters):
    """Kernel 1 on a prepared segment (``seg``: its fused operands and the
    state it started from): the first step's iteration loop against the
    plain version and float64 (:func:`as_accurate`), its time, the plain
    version's and the bound -> the entry's readings."""
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
        fused_reduced_iterations_plain,
    )
    from animsnapbases_tpu_torch.ops.resident import force_term, predict

    ro = seg["ro"]
    fo = ro.fused
    sn, rb_const = predict(ro, seg["P"], seg["V"], force_term(ro, seg["F"]),
                           seg["rb"])
    sel = sn[:, :ro.n_sel]
    u_k = fused_reduced_iterations(fo, sel, rb_const, iters)
    u_p = fused_reduced_iterations_plain(fo, sel, rb_const, iters)
    u_64 = fused_reduced_iterations_plain(as_f64(fo), sel.double(),
                                          rb_const.double(), iters)
    ok, e_k, e_p = as_accurate(u_k, u_p, u_64)
    log(f"[11] scenarios, {label}, kernel 1 on the first step after the "
        f"prepare at frame {seg['frame']} (cond(Ar) {seg['cond']:.3e}): vs "
        f"plain max abs {max_abs(u_k, u_p):.3e} (max|u| "
        f"{float(u_p.abs().max()):.3e}); vs float64: kernel {e_k:.3e}, plain "
        f"{e_p:.3e} (limit {ACC_RATIO}x)")
    require(bool(torch.isfinite(u_k).all()) and ok,
            f"{label}: kernel 1 is less accurate than its plain version "
            f"after the prepare at frame {seg['frame']}")
    return {"err": max_abs(u_k, u_p), "timed": (fo, sel, rb_const)}


def scen_k1_times(torch, timed, iters):
    """ms of kernel 1 and of its plain version on ``timed``'s inputs, and
    the bound -> (ms, plain_ms, bound_ms, bound_by)."""
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
        fused_reduced_iterations_plain,
    )

    fo, sel, rb_const = timed
    ms = cuda_ms(torch, lambda: fused_reduced_iterations(
        fo, sel, rb_const, iters), reps=100)
    plain = cuda_ms(torch, lambda: fused_reduced_iterations_plain(
        fo, sel, rb_const, iters), reps=PLAIN_REPS, warmup=0)
    bound, by = bound_ms(*k1_cost(fo, sel.shape[1], iters))
    return ms, plain, bound, by


def spy_prepares(torch, solver, fext):
    """Wrap ``solver.prepare`` so that each call records the segment it
    starts: its frame, its fused operands, the state and force on the
    device, the target term and cond(Ar) (the largest of the three
    dimensions' reduced matrices) -> the list the calls append to."""
    segs = []
    real = solver.prepare

    def prepare(*a, **kw):
        real(*a, **kw)
        model = solver.model
        segs.append({
            "frame": solver.frame, "ro": solver._resident,
            "P": solver._to_device(model.positions),
            "V": solver._to_device(model.velocities),
            "F": solver._to_device(fext(model)), "rb": solver._rb_extra(),
            "cond": max(float(np.linalg.cond(m)) for m in solver._inv_np)})

    solver.prepare = prepare
    return segs


def scen_reduced_driver(torch, config, out_dir, dtype):
    """SCEN_NAME on ``config`` (the fully reduced replay's) on the CPU in
    ``dtype`` (state and matrices; float32 runs kernel 1's plain version),
    its frame 0 set up -> the driver."""
    from animsnapbases_tpu_torch.config.sim_config import SimConfig
    from animsnapbases_tpu_torch.demos.scenarios import build_scenario
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    params = SimConfig(config)
    args = params.build_args()
    args.solver = "animSnapBasesSolver"
    args.output_dir = out_dir
    d = build_scenario(SCEN_NAME, args, params=params, device="cpu")
    d.solver = AnimSnapBasesSolver(args, device="cpu", dtype=dtype,
                                   matmul_dtype=dtype)
    d._frame0()
    return d


def scen_reduced_holds(torch, segs, traj, config, secs):
    """(b) at each prepare (frame 0 and each event) with SCEN_HOLD_STEPS
    frames after it in ``traj``: the card's state as the prepare read it
    (``segs``) through the event and those frames on the CPU by the same
    scenario driver, in float64 and in float32; the
    card's frames held against the float64 run within ACC_RATIO times the
    float32 run's distance from it, or the float32 rounding of the frames'
    largest entry (:func:`as_accurate`) -> {frame: distances}."""
    out = {}
    t0 = time.perf_counter()
    for s in segs:
        e = s["frame"]
        if e + SCEN_HOLD_STEPS > len(traj):
            continue
        runs = []
        for dtype in (torch.float64, torch.float32):
            d = scen_reduced_driver(torch, config, os.path.join(
                os.path.dirname(config), f"cpu (b) {e} {dtype}"), dtype)
            for ev in sorted(k for k in d.schedule
                             if isinstance(k, int) and k < e):
                d.schedule[ev](d)
            iperm = s["ro"].iperm
            d.model.positions = s["P"].double().cpu().numpy().T[iperm]
            d.model.velocities = s["V"].double().cpu().numpy().T[iperm]
            d.solver.frame = e
            d.solver.set_dirty()
            d.run(max_frames=e + SCEN_HOLD_STEPS)
            runs.append(torch.as_tensor(np.array(d.trajectory)))
        card = torch.as_tensor(traj[e:e + SCEN_HOLD_STEPS])
        ok, e_k, e_p = as_accurate(card, runs[1], runs[0])
        out[e] = {"card": e_k, "plain": e_p, "ok": ok}
    secs["(b) CPU holds"] = time.perf_counter() - t0
    log(f"[11] scenarios, (b): at each prepare the card's state through the "
        f"event and {SCEN_HOLD_STEPS} frames on the CPU, max abs from its "
        f"float64 run (the card; its float32 run, limit {ACC_RATIO}x): "
        + ", ".join(f"frame {e}: {v['card']:.3e}; {v['plain']:.3e}"
                    for e, v in out.items()))
    require(all(v["ok"] for v in out.values()),
            "(b): the card's frames after a prepare are less accurate than "
            "the CPU's float32 run")
    return out


def scen_segments(rows, bounds):
    """Per segment (``bounds``: its first frames and the run's end): the
    mean and max rel-L2 and the mean normal angle of the ``rows`` of
    ``compute_accuracy_arrays`` -> a list of dicts."""
    per_seg = []
    for f0, f1 in zip(bounds[:-1], bounds[1:]):
        seg_l2 = [r["rel_l2"] for r in rows[f0:f1]]
        seg_ang = [r["normal_angle"] for r in rows[f0:f1]]
        per_seg.append({"frames": [f0, f1],
                        "mean_rel_l2": float(np.mean(seg_l2)),
                        "max_rel_l2": float(np.max(seg_l2)),
                        "mean_normal_angle": float(np.mean(seg_ang))})
    return per_seg


def scen_reduced(torch, counted, paths, dev, work, a, secs):
    """(b) SCEN_NAME fully reduced: (a)'s bases and a position basis of
    (a)'s recording (``position_basis_from_trajectory``, r =
    SCEN_POS_MODES), float32 state and float32 matrices, every frame
    through ``run_steps(record=True)``: kernel 1, one launch a frame, a
    counted path; every event prepares again.  cond(Ar) of each segment,
    the card's frames after each prepare against the CPU's
    (:func:`scen_reduced_holds`), kernel 1 against float64 on the first
    step after each prepare, the per-frame rel-L2 and normal angle against
    the recording, beside the per-segment ones of the whole replay in
    float64 on the CPU -> (kernel 1's readings, the trajectory)."""
    from animsnapbases_tpu_torch.analysis.accuracy import (
        compute_accuracy_arrays,
    )
    from animsnapbases_tpu_torch.bases.position_reduction import (
        position_basis_from_trajectory,
        save_position_basis,
    )
    from animsnapbases_tpu_torch.config.sim_config import SimConfig
    from animsnapbases_tpu_torch.demos.scenarios import build_scenario

    t0 = time.perf_counter()
    pos_path = os.path.join(work, "scenario_pos_basis.npz")
    save_position_basis(pos_path, position_basis_from_trajectory(
        a.traj, SCEN_POS_MODES, device=dev))
    secs["(b) position basis"] = time.perf_counter() - t0
    config = scen_config(
        work, "reduced.json", geom_interpolation_basis_dir=a.basis_root,
        geom_interpolation_basis_file="basis.npz",
        reduction={"properties": "", "position_reduced": True,
                   "position_num_components": SCEN_POS_MODES,
                   "position_basis_file": pos_path})
    params = SimConfig(config)
    args = params.build_args()
    args.solver = "animSnapBasesSolver"
    args.output_dir = os.path.join(work, "reduced")
    driver = build_scenario(SCEN_NAME, args, params=params, device=dev)
    mass = float(args.mass_per_particle)

    def fext(model):
        f = np.zeros_like(model.positions)
        f[:, 1] -= 9.81 * mass
        return f

    segs = spy_prepares(torch, driver.solver, fext)
    frames = SCEN_FRAMES or driver.stop_frame
    launch_path = f"scenarios: (b) {SCEN_NAME} fully reduced"
    t0 = time.perf_counter()
    paths[launch_path] = counted_path(
        torch, counted, f"(b) {SCEN_NAME} fully reduced ({frames} frames "
        f"through run_steps(record=True))", {"fused_reduced_iterations"},
        lambda: driver.run(max_frames=SCEN_FRAMES))
    secs["(b) replay"] = time.perf_counter() - t0
    traj = np.array(driver.trajectory)
    launches = paths[launch_path]["fused_reduced_iterations"]
    solver = driver.solver
    require(solver.dtype == (torch.float32 if dev.type == "cuda"
                             else solver.dtype)
            and solver.matmul_dtype == solver.dtype,
            "(b) does not serve float32 state and float32 matrices")
    require(len(traj) == frames and solver.frame == frames,
            f"(b) replayed {len(traj)} of {frames} frames")
    events = [e for e in SCEN_EVENTS if e < frames]
    require([s["frame"] for s in segs] == [0] + events,
            f"(b) prepared at frames {[s['frame'] for s in segs]}, not at "
            f"0 and each event {events}")
    if dev.type == "cuda":
        require(launches == frames, f"(b) kernel 1 launched {launches} "
                f"times over {frames} frames")
    finite = bool(np.isfinite(traj).all())
    rows, l2, ang = compute_accuracy_arrays(a.traj[:len(traj)], traj,
                                            driver.model.faces)
    bounds = [s["frame"] for s in segs] + [frames]
    per_seg = scen_segments(rows, bounds)
    for p, s in zip(per_seg, segs):
        p["cond_Ar"] = s["cond"]
    log(f"[11] scenarios, (b) fully reduced (r = {SCEN_POS_MODES} of the "
        f"recording, {solver.dtype} state, {solver.matmul_dtype} matrices) "
        f"in {secs['(b) replay']:.2f} s: {len(traj)} frames, kernel 1 "
        f"launched {launches} times, finite {finite}; per segment (frames, "
        f"cond(Ar), rel-L2 mean/max, normal angle mean): "
        + "; ".join(f"{p['frames']}: {p['cond_Ar']:.3e}, "
                    f"{p['mean_rel_l2']:.3e}/{p['max_rel_l2']:.3e}, "
                    f"{p['mean_normal_angle']:.4f}" for p in per_seg))
    log("[11] scenarios, (b) per frame rel-L2: " + " ".join(
        f"{r['rel_l2']:.3e}" for r in rows))
    log("[11] scenarios, (b) per frame normal angle: " + " ".join(
        f"{r['normal_angle']:.4f}" for r in rows))
    holds = scen_reduced_holds(torch, segs, traj, config, secs)
    # the whole replay in float64 on the CPU, beside the card's (not held:
    # the float32 and float64 runs part over the segments)
    t0 = time.perf_counter()
    d = scen_reduced_driver(torch, config, os.path.join(work, "cpu (b)"),
                            torch.float64)
    d.run(max_frames=SCEN_FRAMES)
    cpu = np.array(d.trajectory)
    secs["(b) CPU float64 replay"] = time.perf_counter() - t0
    cpu_seg = scen_segments(compute_accuracy_arrays(
        a.traj[:len(cpu)], cpu, d.model.faces)[0], bounds)
    log(f"[11] scenarios, (b) the same replay on the CPU in float64 in "
        f"{secs['(b) CPU float64 replay']:.2f} s: per segment rel-L2 "
        f"mean/max, normal angle mean: " + "; ".join(
            f"{p['frames']}: {p['mean_rel_l2']:.3e}/{p['max_rel_l2']:.3e}, "
            f"{p['mean_normal_angle']:.4f}" for p in cpu_seg)
        + f"; the card's last frame {max_abs(torch.as_tensor(traj[-1]),
                                               torch.as_tensor(cpu[-1])):.3e}"
        " from its last (max abs)")
    err, timed = 0.0, None
    for s in segs:
        k1 = scen_k1_entry(torch, "(b)", s, args.solver_iterations)
        err = max(err, k1["err"])
        timed = k1["timed"]
    ms, plain, bound, by = scen_k1_times(torch, timed, args.solver_iterations)
    return {"launches_path": launch_path, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "frames": frames, "r": SCEN_POS_MODES, "finite": finite,
            "segments": per_seg, "cpu_float64_segments": cpu_seg,
            "event_holds": holds,
            "matmul_dtype": str(solver.matmul_dtype).split(".")[-1]}


def scen_report(torch, counted, paths, dev, work, shared, secs, smi):
    """(c) The accuracy report (``analysis/accuracy_report.py``) on the
    bench scene from phase [6]'s recording and bases (``shared``): the
    reduced replay of the recorded window (``replay``: kernel 1, one
    launch a frame, a counted path) in float32 state with bfloat16
    matrices, then with float32 matrices, each through ``report`` with the
    script's gates (a gate crossed raises); the JSON lines written under
    ``work`` -> {matrices: kernel 1's readings}."""
    from animsnapbases_tpu_torch.analysis import accuracy_report as ar
    from animsnapbases_tpu_torch.bases.pipeline import reduced_args
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    traj = np.load(os.path.join(shared, "card", "traj.npy"))
    args = reduced_args(os.path.join(shared, "card", "bases"),
                        os.path.join(shared, "card", "pos_basis.npz"),
                        min(REDUCED_MODES, CONSTR_MODES), POS_MODES, 0.016,
                        BENCH_DAMPING)
    draw = have_matplotlib()
    out = {}
    for mm in ("bfloat16", "float32"):
        model = bench_scene(DeformableModel, cloth_model)
        solver = AnimSnapBasesSolver(args, device=dev, dtype=torch.float32,
                                     matmul_dtype=getattr(torch, mm))
        solver.resident_contact_mode = False
        solver.set_model(model)
        segs = spy_prepares(torch, solver, gravity)
        solver.prepare(args)
        launch_path = f"scenarios: (c) accuracy report, {mm} matrices"
        got = {}
        t0 = time.perf_counter()
        paths[launch_path] = counted_path(
            torch, counted, f"(c) the accuracy report's replay ({len(traj)} "
            f"frames, {mm} matrices)", {"fused_reduced_iterations"},
            lambda: got.update(traj=ar.replay(solver, model, len(traj))))
        secs[f"(c) replay, {mm}"] = time.perf_counter() - t0
        launches = paths[launch_path]["fused_reduced_iterations"]
        if dev.type == "cuda":
            require(launches == len(traj), f"(c) kernel 1 launched "
                    f"{launches} times over {len(traj)} frames")
        line_path = os.path.join(work, f"accuracy_report_{mm}.json")

        def emit(line):
            with open(line_path, "w") as fp:
                fp.write(line + "\n")
            log(f"[11] scenarios, (c) accuracy report, {mm} matrices: {line}")

        t0 = time.perf_counter()
        # the heat maps and the rotating capture: once, on the first
        # reading (host plotting, not the device path)
        rep = ar.report(traj, got["traj"], model.faces,
                        os.path.join(work, f"accuracy {mm}"),
                        draw=draw and not out, emit=emit)
        secs[f"(c) report, {mm}"] = time.perf_counter() - t0
        k1 = scen_k1_entry(torch, f"(c) {mm} matrices", segs[0],
                           FOM_ITERS)
        ms, plain, bound, by = scen_k1_times(torch, k1["timed"], FOM_ITERS)
        detail = rep["line"]["detail"]
        log(f"[11] scenarios, (c) {mm} matrices: mean rel-L2 "
            f"{rep['line']['value']} (gate {ar.REL_L2_GATE}), mean normal "
            f"angle {detail['mean_normal_angle_rad']} rad (gate "
            f"{ar.NORMAL_ANGLE_GATE}); the report in "
            f"{secs[f'(c) report, {mm}']:.2f} s "
            f"({'drawn' if draw and not out else 'not drawn'}: matplotlib "
            f"{'imports' if draw else 'is absent'} on this host); kernel 1 "
            f"{1e3 * ms:.2f} us a call (bound {1e3 * bound:.4f}, {by}; plain "
            f"{1e3 * plain:.1f}) ({smi})")
        out[mm] = {"launches_path": launch_path, "launches": launches,
                   "max_abs_err": k1["err"], "ms": ms, "plain_ms": plain,
                   "bound_ms": bound, "bound_by": by, "library_ms": None,
                   "mean_rel_l2": rep["line"]["value"],
                   "mean_normal_angle": detail["mean_normal_angle_rad"],
                   "gate_passed": detail["gate_passed"],
                   "drawn": bool(draw and len(out) == 0)}
    return out


def scenarios_phase(torch, counted, paths, dev, smi, shared):
    """[11] The reference's loop through the port's command lines and the
    analysis: (a) :func:`scen_demo`, (b) :func:`scen_reduced`, (c)
    :func:`scen_report` on phase [6]'s files under ``shared`` -> {kernel
    name: its "scenarios" readings}."""
    secs = {}
    # under ``shared``: phase [12]'s sweep reads (a)'s recording and bases
    # through SCEN_MANIFEST
    work = os.path.join(shared, "scenarios")
    os.makedirs(work, exist_ok=True)
    a = scen_demo(dev, work, secs, smi)
    with open(os.path.join(shared, SCEN_MANIFEST), "w") as fp:
        json.dump({"record": a.fom.record_path, "work": a.fom_out,
                   "bases": a.basis_dir, "draw": a.draw}, fp)
    b = scen_reduced(torch, counted, paths, dev, work, a, secs)
    c = scen_report(torch, counted, paths, dev, work, shared, secs, smi)
    log("[11] scenarios seconds (" + smi + "): " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()))
    return {"fused_reduced_iterations": {
        "event_demo_full": {"holds": a.holds, "accuracy": a.accuracy},
        "event_demo_reduced": b, "accuracy_report": c, "stage_s": secs}}


def mc_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def mc_counts(counted):
    return {fn.__name__: fn.launches for fn in counted}


def mc_serve(torch, spec, solver, mesh, label, state, dev, counted, rank):
    """One sharded ``make_batched_run`` window on this rank (counters set
    to 0 before it), then, on rank 0, the single-process run of the same
    batch -> the readings."""
    import torch.distributed as dist

    pos, vel, fs = state
    steps, iters = spec["steps"], spec["iterations"]
    run = solver.make_batched_run(mesh, batch_axis="data")
    dist.barrier()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    p, v = run(pos, vel, fs, steps, num_iterations=iters)
    mc_sync(torch, dev)
    out = {"seconds": time.perf_counter() - t0,
           "path": solver._last_batched_path,
           "counts": mc_counts(counted), "sims": len(pos)}
    out["us_per_step"] = 1e6 * out["seconds"] / steps
    dist.barrier()
    if rank == 0:
        t0 = time.perf_counter()
        p1, v1 = solver.make_batched_run()(pos, vel, fs, steps,
                                           num_iterations=iters)
        mc_sync(torch, dev)
        out["single_seconds"] = time.perf_counter() - t0
        out["single_us_per_step"] = 1e6 * out["single_seconds"] / steps
        out["single_path"] = solver._last_batched_path
        out["bit_for_bit"] = bool(np.array_equal(p, p1)
                                  and np.array_equal(v, v1))
        out["max_abs"] = float(np.abs(p - p1).max())
        out["finite"] = bool(np.isfinite(p).all())
    dist.barrier()
    return out


def tp_against_steps(torch, solver, q_tp, P0, V0, f, iterations):
    """[12](a) the TP-reduced step ``q_tp`` (N, 3) from the host state (P0,
    V0) against the single-process fully reduced step from the same float32
    state (``step_once`` of ops/resident.py, rank 0 alone): its plain
    version in float64 with every operand widened from the host's float64
    arrays (the reference: no code of the TP step), in float32 with
    float32 matrices (the TP step's arithmetic in another order: its peer
    for :func:`as_accurate`), and in the bench configuration's storage type
    (bfloat16 U and U^T A_c), plain and on kernel 1 -> the readings: the
    TP step within ACC_RATIO of its peer's distance from float64, and within
    ACC_RATIO of kernel 1's step's own distance from float64 of that
    step."""
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
    )
    from animsnapbases_tpu_torch.ops.resident import force_term, step_once

    ro = solver._resident
    perm, dev = ro.perm, ro.mass_inv.device

    def wide(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float64),
                               device=dev)

    ro64 = dataclasses.replace(
        ro, fused=as_f64(ro.fused),
        U_liftT=wide(solver.U[perm].transpose(2, 1, 0)),
        ut_acT=wide(solver._ut_ac_np[:, :, perm]),
        mass_inv=wide(1.0 / solver.model.mass[perm]).reshape(1, -1))
    ro32 = dataclasses.replace(ro, U_liftT=ro64.U_liftT.float(),
                               ut_acT=ro64.ut_acT.float())
    P, V, F = (solver._to_device(x) for x in (P0, V0, f))
    rb = solver._rb_extra()

    def host(q):
        return torch.as_tensor(solver._to_host(q))

    def step(o, iterate=None, wide_=False):
        x = [t.double() if wide_ else t for t in (P, V, F, rb)]
        kw = {} if iterate is None else {"iterate": iterate}
        return host(step_once(o, x[0], x[1], force_term(o, x[2]), x[3],
                              iterations, **kw)[0])

    q64 = step(ro64, wide_=True)
    q32 = step(ro32)
    q_bf = step(ro)
    q_k = step(ro, fused_reduced_iterations)
    q_tp = torch.as_tensor(q_tp.cpu().double())
    ok, e_tp, e_32 = as_accurate(q_tp, q32, q64)
    e_k = max_abs(q_k, q64)
    floor = F32_EPS * float(q64.abs().max())
    vs_step = max_abs(q_tp, q_k)
    return {"as_accurate": ok, "tp_err64": e_tp, "peer_err64": e_32,
            "step_err64": e_k, "step_plain_err64": max_abs(q_bf, q64),
            "vs_step": vs_step,
            "vs_step_ok": vs_step <= ACC_RATIO * max(e_k, floor),
            "extent": float(q64.abs().max())}


def multichip_rank(rank, world, spec):
    """[12](a) on one rank of a ``world``-rank gloo group (every rank on
    the one card): the bench scene's sharded serving on both routes, the
    TP-reduced and element-sharded steps, the sharded POD and the sharded
    constraint bases of phase [6]'s recording.  Each rank writes its
    readings to ``spec["out"]/rank<r>.json``; rank 0 runs the
    single-process references.  No hold here: the parent holds them."""
    import copy

    import torch
    import torch.distributed as dist

    from animsnapbases_tpu_torch.bases.pipeline import (
        compute_constproj_bases,
        group_basis_config,
    )
    from animsnapbases_tpu_torch.config.sim_config import default_sim_args
    from animsnapbases_tpu_torch.device import resolve_device
    from animsnapbases_tpu_torch.ops.deim_scan import deim_rows_host_result
    from animsnapbases_tpu_torch.ops.podlinalg import (
        snapshot_pod,
        snapshot_pod_sharded,
    )
    from animsnapbases_tpu_torch.parallel import (
        build_device_mesh,
        make_element_sharded_step,
        make_tp_reduced_step,
    )
    from animsnapbases_tpu_torch.sim.solver import Solver
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    dev = resolve_device(spec["device"])
    dtype = getattr(torch, spec["dtype"])
    matmul = getattr(torch, spec["matmul"])
    data = build_device_mesh((world,), ("data",), dev)
    model_axis = build_device_mesh((world,), ("model",), dev)
    counted = port_counters()
    res = {"rank": rank}
    t0 = time.perf_counter()
    model = copy.deepcopy(spec["model"])
    solver = scene_solver(synthetic_reduced_solver, model, spec["K"],
                          spec["r"], spec["damping"], device=dev,
                          dtype=dtype, matmul_dtype=matmul)
    res["prepare_s"] = time.perf_counter() - t0
    # ---- the sharded serving: resident route, then the large-model route
    res["resident"] = mc_serve(torch, spec, solver, data, "resident",
                               spec["ring"], dev, counted, rank)
    solver.CHUNKED_TIER1_MIN_VERTS = 0
    solver.prepare(solver.args)
    res["chunked"] = mc_serve(torch, spec, solver, data, "chunked",
                              spec["ring"], dev, counted, rank)
    res["chunked_mixed"] = mc_serve(torch, spec, solver, data,
                                    "chunked, mixed", spec["mixed"], dev,
                                    counted, rank)
    # ---- the TP-reduced step against the single-process step (kernel 1)
    P0, V0 = spec["main_state"]
    f = gravity(model)
    tp = make_tp_reduced_step(solver, model_axis)
    tp(P0, V0, f, num_iterations=spec["iterations"])     # warm
    mc_sync(torch, dev)
    dist.barrier()
    t0 = time.perf_counter()
    q, _ = tp(P0, V0, f, num_iterations=spec["iterations"])
    mc_sync(torch, dev)
    res["tp"] = {"seconds": time.perf_counter() - t0,
                 "finite": bool(torch.isfinite(q).all())}
    if rank == 0:
        res["tp"].update(tp_against_steps(torch, solver, q, P0, V0, f,
                                          spec["iterations"]))
    # ---- the element-sharded FOM step against Solver.step (device CG)
    fom_model = copy.deepcopy(spec["model"])
    fom = Solver(device=dev)
    fom.set_model(fom_model)
    args = default_sim_args()
    args.dt = solver.dt
    fom.prepare(args)
    rest = fom_model.positions.copy()
    step = make_element_sharded_step(copy.deepcopy(spec["model"]),
                                     solver.dt, model_axis,
                                     num_iterations=spec["fom_iters"],
                                     device=dev)
    dist.barrier()
    t0 = time.perf_counter()
    qf, _ = step(rest, np.zeros_like(rest), f)
    mc_sync(torch, dev)
    el_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fom.step(f, num_iterations=spec["fom_iters"])
    mc_sync(torch, dev)
    res["element"] = {"seconds": el_s, "solver_seconds":
                      time.perf_counter() - t0, "mode": fom._mode,
                      "max_abs": float(np.abs(qf.cpu().numpy()
                                              - fom_model.positions).max()),
                      "extent": float(np.abs(fom_model.positions).max())}
    # ---- the sharded POD
    rng = np.random.default_rng(0)
    n_rows, cols = spec["pod"]
    X = rng.normal(size=(n_rows, cols)) * np.geomspace(10.0, 0.1, cols)
    dist.barrier()
    t0 = time.perf_counter()
    U, s, _ = snapshot_pod_sharded(X, model_axis, device=dev)
    mc_sync(torch, dev)
    pod = {"seconds": time.perf_counter() - t0}
    U1, s1, _ = snapshot_pod(X, device=dev)
    ds, du = pod_bounds(s1.cpu().numpy(), cols)
    pod["within_bounds"] = bool(
        (np.abs(s.cpu().numpy() - s1.cpu().numpy()) <= ds).all()
        and (sign_aligned_diff(U1.cpu().numpy().T, U.cpu().numpy().T)
             <= du).all())
    pod["u_max_abs"] = float(sign_aligned_diff(
        U1.cpu().numpy().T, U.cpu().numpy().T).max())
    res["pod"] = pod
    # ---- phase [6]'s recording through ConstraintComponents, 2 shards
    bases = {}
    for gname, p in spec["groups"]:
        def config(shards, sub):
            param = group_basis_config(
                spec["record"], gname, p, spec["constr_modes"],
                spec["frames"], os.path.join(spec["out"], f"r{rank}{sub}"))
            param.device_mesh_shards = shards
            # with a mesh the DEIM runs the device scan: so does the
            # unsharded run it is held to
            param.deim_device = True
            return param
        t0 = time.perf_counter()
        cc = compute_constproj_bases(config(world, ""), device=dev)
        b = {"seconds": time.perf_counter() - t0,
             "sharded": cc.pod_mesh is not None}
        if rank == 0:
            # the scan's invariant: on the sharded run's own basis the
            # unsharded scan picks the same rows (the two PODs differ by
            # rounding, which may break an exact tie of the data otherwise)
            same = deim_rows_host_result(
                torch.as_tensor(cc.comps).transpose(0, 1), p,
                len(cc.comps), device=dev)[0]
            one = compute_constproj_bases(config(0, "one"), device=dev)
            K = len(one.comps)
            _, du = pod_bounds(one.singVals, K)
            d_u = sign_aligned_diff(one.comps, cc.comps)
            ok1, ties1 = deim_picks_agree(one.comps, one.geom_Pt, cc.geom_Pt,
                                          d_u)
            ref = np.load(os.path.join(spec["bases"], gname, "basis.npz"))
            ok6, ties6 = deim_picks_agree(ref["components"], ref["Pt"],
                                          cc.geom_Pt, sign_aligned_diff(
                                              ref["components"], cc.comps))
            b.update(same_basis_picks_equal=bool(np.array_equal(
                         same, cc.geom_Pt)),
                     within_bounds=bool(cc.comps.shape == one.comps.shape
                                        and (d_u <= du).all()),
                     mode_diff_max=float(d_u.max()), unsharded_agree=ok1,
                     unsharded_ties=ties1, phase6_agree=ok6,
                     phase6_ties=ties6)
        bases[gname] = b
    res["bases"] = bases
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as fp:
        json.dump(res, fp)


def multichip_a(torch, dev, smi, shared, solver, main_state):
    """[12](a): :func:`multichip_rank` on MC_RANKS ranks for the bench
    scene of ``solver`` (the main path's: its widths, dtypes and damping),
    its readings held here -> the phase's readings."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.parallel.launch import run_ranks
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.sim.solver import Solver

    model = bench_scene(DeformableModel, cloth_model)
    K = max(solver.num_components.values())
    r = solver.U.shape[1]
    f = gravity(model)
    ring = ensemble_state(main_state, ENSEMBLE)
    mixed = mixed_state(model, main_state, f)
    with tempfile.TemporaryDirectory() as out:
        spec = {"out": out, "device": dev.type, "model": model, "K": K,
                "r": r, "damping": 1.0 - solver.eta,
                "dtype": str(solver.dtype).split(".")[-1],
                "matmul": str(solver.matmul_dtype).split(".")[-1],
                "iterations": ITERATIONS, "steps": WINDOW_STEPS,
                "ring": ring, "mixed": mixed, "main_state": main_state,
                "fom_iters": MC_FOM_ITERS, "pod": MC_POD,
                "record": os.path.join(shared, "card", "FOM"),
                "bases": os.path.join(shared, "card", "bases"),
                "groups": [(g, model.groups[g].p) for g in model.groups
                           if g != "positional"],
                "constr_modes": CONSTR_MODES, "frames": FOM_FRAMES - 1}
        t0 = time.perf_counter()
        run_ranks(MC_RANKS, multichip_rank, (spec,), backend="gloo",
                  timeout=MC_TIMEOUT,
                  threads=1 if dev.type == "cpu" else None)
        wall = time.perf_counter() - t0
        ranks = []
        for i in range(MC_RANKS):
            with open(os.path.join(out, f"rank{i}.json")) as fp:
                ranks.append(json.load(fp))
    r0 = ranks[0]
    n, bl = MC_RANKS, ENSEMBLE // MC_RANKS
    serve = {}
    for key, own, sims in (
            ("resident", ("resident_affine_contact_batched",), ENSEMBLE),
            ("chunked", ("affine_chunked_batched",), ENSEMBLE),
            ("chunked_mixed", ("affine_chunked_batched",
                               "resident_multistep_batched"), MIXED)):
        kind = "resident" if key == "resident" else "chunked"
        base = f"batched-{kind}-sharded[{n}x{sims // n}]"
        for rk in ranks:
            got = rk[key]
            require(got["path"].startswith(base),
                    f"[12] {key}: rank {rk['rank']} took {got['path']}")
            for name, c in got["counts"].items():
                if name in own:
                    require(c > 0, f"{name} was never launched on rank "
                            f"{rk['rank']}'s sharded {key} serving")
                else:
                    require(c == 0, f"{name} was launched {c} times on "
                            f"rank {rk['rank']}'s sharded {key} serving")
        got = r0[key]
        require(got["finite"] and got["bit_for_bit"],
                f"[12] {key}: the sharded sims part from the single-process "
                f"batch by {got['max_abs']:.3e}")
        serve[key] = {"rule": "bit for bit", "max_abs": got["max_abs"],
                      "us_per_step_per_rank": [rk[key]["us_per_step"]
                                               for rk in ranks],
                      "single_us_per_step": got["single_us_per_step"],
                      "path": got["path"], "sims": sims,
                      "launches": [{k: v for k, v in rk[key]["counts"].items()
                                    if v} for rk in ranks]}
        log(f"[12] (a) sharded serving, {key} ({sims} sims, {WINDOW_STEPS} "
            f"steps, {n} ranks on one card): {got['path']}, each sim "
            f"against the single-process batch bit for bit (max abs "
            f"{got['max_abs']:.3e}); µs a step per rank "
            + ", ".join(f"{rk[key]['us_per_step']:.2f}" for rk in ranks)
            + f" beside the single process's {got['single_us_per_step']:.2f}"
            f" ({smi}; the ranks time-share one card: no speed-up is "
            f"expected); launches per rank {serve[key]['launches']}")
    tp = r0["tp"]
    require(tp["finite"] and tp["as_accurate"],
            f"[12] TP-reduced step {tp['tp_err64']:.3e} from the float64 "
            f"single-process step, its float32 peer {tp['peer_err64']:.3e} "
            f"(limit {ACC_RATIO}x)")
    require(tp["vs_step_ok"],
            f"[12] TP-reduced step {tp['vs_step']:.3e} from the single-"
            f"process step (kernel 1), whose own distance from float64 is "
            f"{tp['step_err64']:.3e} (limit {ACC_RATIO}x)")
    log(f"[12] (a) TP-reduced step (bench cloth, r = {r}, {n} ranks): "
        f"{1e3 * tp['seconds']:.2f} ms; from the float64 single-process "
        f"step (plain, operands from the host's float64) {tp['tp_err64']:.3e}"
        f" beside its float32 peer's (float32 matrices) "
        f"{tp['peer_err64']:.3e} (limit {ACC_RATIO}x); from the single-"
        f"process step on kernel 1 {tp['vs_step']:.3e}, whose own distance "
        f"from float64 is {tp['step_err64']:.3e} (limit {ACC_RATIO}x; its "
        f"plain version in the same bfloat16 storage "
        f"{tp['step_plain_err64']:.3e}); extent {tp['extent']:.3e}")
    el = r0["element"]
    require(el["mode"] == ("cg" if model.n_verts * 3 > Solver.DENSE_LIMIT
                           else "dense")
            and el["max_abs"] <= MC_FOM_TOL * el["extent"],
            f"[12] element-sharded step off Solver.step by "
            f"{el['max_abs']:.3e} ({el['mode']})")
    log(f"[12] (a) element-sharded FOM step ({model.n_verts} vertices, "
        f"{el['mode']} solve, {MC_FOM_ITERS} iterations, {n} ranks): "
        f"{el['seconds']:.3f} s beside Solver.step's "
        f"{el['solver_seconds']:.3f} s; max abs {el['max_abs']:.3e} of "
        f"extent {el['extent']:.3e} (limit {MC_FOM_TOL})")
    pod = r0["pod"]
    require(pod["within_bounds"], f"[12] sharded POD {MC_POD} off the "
            f"single POD beyond pod_bounds ({pod['u_max_abs']:.3e})")
    log(f"[12] (a) sharded POD {MC_POD[0]}x{MC_POD[1]}: {pod['seconds']:.3f}"
        f" s, U within pod_bounds (max {pod['u_max_abs']:.3e})")
    for g, b in r0["bases"].items():
        require(b["sharded"] and b["same_basis_picks_equal"]
                and b["within_bounds"] and b["unsharded_agree"]
                and b["phase6_agree"],
                f"[12] {g}: the sharded constraint bases part from the "
                f"unsharded ones or from phase [6]'s: {b}")
        log(f"[12] (a) {g} bases of phase [6]'s recording with "
            f"device_mesh_shards = {n}: {b['seconds']:.2f} s; the sharded "
            f"DEIM scan's picks equal to the unsharded scan's on the same "
            f"basis; against the unsharded pipeline: modes within "
            f"pod_bounds (max {b['mode_diff_max']:.3e}), picks equal or "
            f"ties {b['unsharded_ties']}; against phase [6]'s host DEIM: "
            f"equal or ties {b['phase6_ties']}")
    log(f"[12] (a) {n} ranks: {wall:.1f} s in all, prepare "
        f"{r0['prepare_s']:.1f} s a rank ({smi})")
    return {"serving": serve, "tp": tp, "element": el, "pod": pod,
            "bases": r0["bases"], "seconds": wall}


def start_battery():
    """The smoke battery (``python -m animsnapbases_tpu_torch.smoke``)
    started now as a subprocess, its output to temporary files.
    :func:`run_phases` starts it after phase [2]'s main path, so that it
    runs beside phase [3]'s holds, which time nothing, and waits for its
    end (:func:`battery_result`) before phase [4], so that no timed phase
    shares the card with it; phase [12](b) holds its output."""
    root = os.path.dirname(os.path.abspath(__file__))
    out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
    proc = subprocess.Popen([sys.executable, "-m",
                             "animsnapbases_tpu_torch.smoke"], cwd=root,
                            stdout=out, stderr=err)
    return types.SimpleNamespace(proc=proc, out=out, err=err,
                                 t0=time.perf_counter())


def battery_result(battery):
    """(exit code, stdout, stderr, seconds from its start to its end as
    seen here: the wait's) of a battery of :func:`start_battery`, once it
    has ended."""
    rc = battery.proc.wait(timeout=MC_SUB_TIMEOUT)
    texts = []
    for f in (battery.out, battery.err):
        f.seek(0)
        texts.append(f.read().decode(errors="replace"))
        f.close()
    return rc, texts[0], texts[1], time.perf_counter() - battery.t0


def multichip_b(torch, dev, smi, shared, battery=None):
    """[12](b): the battery whole in a subprocess (``battery``: the
    :func:`battery_result` of one run earlier, else one run now; nine PASS
    lines), then the sweep over phase [11]'s three configs (``--jobs 3``),
    each output equal to phase [11]'s in-process ``cli.main`` output."""
    from animsnapbases_tpu_torch.bases.pipeline import example_config_file
    from animsnapbases_tpu_torch.config.bases_config import BasesConfig

    root = os.path.dirname(os.path.abspath(__file__))
    rc, out, err, wall = battery or battery_result(start_battery())
    secs = {"battery": wall}
    passed = [ln for ln in out.splitlines() if ln.startswith("PASS ")]
    require(rc == 0 and [ln.split()[1] for ln in passed] == list(BATTERY),
            f"[12] the battery: exit {rc}, {passed}; {err[-1500:]}")
    log(f"[12] (b) smoke battery, ended within {wall:.1f} s of its start "
        f"({'beside phase [3]' if battery else 'alone'}): "
        + "; ".join(passed) + f" ({smi})")
    with open(os.path.join(shared, SCEN_MANIFEST)) as fp:
        man = json.load(fp)
    sweep_dir = os.path.join(shared, "sweep")
    os.makedirs(sweep_dir, exist_ok=True)
    over = dict(SCEN_OVERRIDES)
    if not man["draw"]:
        over["run_tests"] = False
    configs = [example_config_file(
        os.path.join(root, CLOTH_EXAMPLE.format("deim", tag)),
        man["record"], man["work"], os.path.join(sweep_dir, f"{g}.json"),
        **over) for g, tag in CLOTH_KINDS.items()]
    results = os.path.join(sweep_dir, "results")
    t0 = time.perf_counter()
    sw = subprocess.run([sys.executable, "-m", "animsnapbases_tpu_torch.sweep",
                         *configs, "--jobs", "3", "--results_dir", results]
                        + (["--cpu"] if dev.type == "cpu" else []),
                        cwd=root, capture_output=True, text=True,
                        timeout=MC_SUB_TIMEOUT)
    secs["sweep"] = time.perf_counter() - t0
    require(sw.returncode == 0, f"[12] the sweep: {sw.stdout[-500:]} "
            f"{sw.stderr[-1500:]}")
    npz = "components_interpol_alphas_interpol_verts_interpol_alpha_ranges.npz"
    same = {}
    for g, cfg in zip(CLOTH_KINDS, configs):
        outd = BasesConfig.from_json(
            cfg, results_dir=results).constProj_output_directory
        got = np.load(os.path.join(outd, npz))
        ref = np.load(os.path.join(man["bases"], g, "basis.npz"))
        K = len(ref["components"])
        d_u = sign_aligned_diff(ref["components"], got["components"])
        bits = all(np.array_equal(ref[k], got[k]) for k in ref.files)
        require(all(np.array_equal(ref[k], got[k]) for k in
                    ("Pt", "interpol_alphas", "interpol_alpha_ranges"))
                and got["components"].shape == ref["components"].shape
                and (bits or d_u.max() <= SWEEP_TOL),
                f"[12] the sweep's {g} bases part from phase [11]'s "
                f"in-process cli.main (modes {d_u.max():.3e})")
        same[g] = {"bit_for_bit": bits, "mode_diff_max": float(d_u.max()),
                   "K": K}
    log(f"[12] (b) sweep of {len(configs)} configs (--jobs 3) in "
        f"{secs['sweep']:.1f} s: {sw.stdout.strip().splitlines()[0]}; "
        f"against phase [11]'s cli.main: {same} ({smi})")
    return {"battery": passed, "sweep": same, "seconds": secs}


def multichip_c(shared):
    """[12](c): the native library built, and its readers equal to the
    Python ones on files the port wrote (phase [11]'s .off frames, a
    components .bin of phase [6]'s bases)."""
    from animsnapbases_tpu_torch.io import binfmt, native
    from animsnapbases_tpu_torch.io.meshes import load_off

    require(native.available(), "[12] the native library did not build")
    with open(os.path.join(shared, SCEN_MANIFEST)) as fp:
        man = json.load(fp)
    pos_dir = next(os.path.join(d, "") for d, _, files in os.walk(
        man["work"]) if any(f.endswith(".off") for f in files))
    offs = sorted((f for f in os.listdir(pos_dir) if f.endswith(".off")),
                  key=lambda f: int(f.rsplit("_", 1)[-1][:-len(".off")]))
    paths = [os.path.join(pos_dir, f) for f in offs]
    t0 = time.perf_counter()
    V, F = native.load_off_sequence(paths)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = [load_off(p) for p in paths]
    t_py = time.perf_counter() - t0
    same_off = (np.array_equal(V, np.stack([v for v, _ in py]))
                and np.array_equal(F, py[0][1]))
    comps = np.load(os.path.join(shared, "card", "bases", "tris_strain",
                                 "basis.npz"))["components"]
    path = os.path.join(shared, "comps.bin")
    binfmt.write_components_bin(path, comps)
    same_bin = np.array_equal(native.read_components_bin(
        path, *comps.shape), binfmt.read_components_bin(path))
    require(same_off and same_bin, "[12] the native reader parts from the "
            "Python reader")
    log(f"[12] (c) native I/O: built at {native.lib_path()}; {len(paths)} "
        f".off frames equal to the Python reader ({t_native:.3f} s native, "
        f"{t_py:.3f} s Python), a {comps.shape} components .bin equal")
    return {"off_frames": len(paths), "native_s": t_native, "python_s": t_py}


def multichip_phase(torch, dev, smi, shared, solver, main_state,
                    battery=None):
    """[12] (a) :func:`multichip_a` on the bench scene of ``solver``, (b)
    :func:`multichip_b` (``battery``: the :func:`battery_result` of one run
    earlier), (c) :func:`multichip_c` -> their readings."""
    t0 = time.perf_counter()
    a = multichip_a(torch, dev, smi, shared, solver, main_state)
    b = multichip_b(torch, dev, smi, shared, battery)
    c = multichip_c(shared)
    return {"sharded": a, "battery_and_sweep": b, "native": c,
            "seconds": time.perf_counter() - t0}


def port_counters():
    """The launch counters the script reads: the twelve kernel wrappers,
    then kernel 5's option builds (``ops/affine_chunked.py``
    ``COUNTERS``)."""
    from animsnapbases_tpu_torch.ops.affine import (
        resident_affine,
        resident_affine_batched,
        resident_affine_contact,
        resident_affine_contact_batched,
        resident_affine_exit,
        resident_affine_exit_batched,
    )
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        COUNTERS,
        affine_chunked,
        affine_chunked_batched,
    )
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
        fused_reduced_iterations_batched,
    )
    from animsnapbases_tpu_torch.ops.resident import (
        resident_multistep,
        resident_multistep_batched,
    )

    return (fused_reduced_iterations, resident_multistep, resident_affine,
            resident_affine_exit, affine_chunked, resident_affine_contact,
            fused_reduced_iterations_batched, resident_multistep_batched,
            resident_affine_batched, affine_chunked_batched,
            resident_affine_contact_batched, resident_affine_exit_batched,
            *COUNTERS)


def build_phase(torch):
    """[1] The card's name and power limit, the versions of torch, CUDA,
    Python and nvcc, and the build of every kernel -> the nvidia-smi line."""
    from animsnapbases_tpu_torch.ops import _build

    # ---- 1. device and build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} nvcc: {nvcc}")
    t0 = time.perf_counter()
    info = _build.build()
    log(f"[1] built {sorted(info)} in {time.perf_counter() - t0:.1f} s")
    for name, rec in sorted(info.items()):
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
    return smi


def bench_phase(torch, counted, dev):
    """[2] The bench scene through the entry points: prepare, then
    ``step`` + ``run_steps(SCENE_STEPS)``, the main path (counted), whose
    tier 1 must certify the window -> the phase's state: the model and
    solver, the rest state, the force, the state run_steps started from
    (``main_in``), the end state (``main_state``), the device and the
    counted paths."""
    # ---- 2. the bench scene through the entry points -------------------
    t0 = time.perf_counter()
    model, solver = bench_solver(torch, dev)
    rest = (model.positions.copy(), model.velocities.copy())
    ro = solver._resident
    fo = ro.fused
    log(f"[2] prepare {time.perf_counter() - t0:.1f} s: N={ro.n} r={fo.r} "
        f"n_sel={ro.n_sel} g_total={fo.g_total} m_total={fo.m_total} "
        f"storage={ro.ut_acT.dtype}; tiers: {solver._resident_fast_kind} "
        f"tier 1, {solver._resident_kind} contact tier")
    f = gravity(model)
    main_in = []          # the state run_steps starts from on the main path

    def main_path():
        solver.step(f, num_iterations=ITERATIONS)
        main_in.extend((model.positions.copy(), model.velocities.copy()))
        solver.run_steps(f, SCENE_STEPS, num_iterations=ITERATIONS)

    t0 = time.perf_counter()
    paths = {"main path": counted_path(
        torch, counted, f"the main path (step + run_steps({SCENE_STEPS}))",
        {"fused_reduced_iterations", "affine_chunked"}, main_path)}
    require(solver._last_fast_steps == SCENE_STEPS,
            f"tier 1 did not certify the {SCENE_STEPS}-step window "
            f"({solver._last_fast_steps})")
    log(f"[2] step + run_steps({SCENE_STEPS}) "
        f"{time.perf_counter() - t0:.2f} s, tier 1 certified the window")
    require(model.positions.shape == (ro.n, 3), "state shape")
    require(np.isfinite(model.positions).all(), "non-finite positions")
    require(np.isfinite(model.velocities).all(), "non-finite velocities")
    log(f"[2] state finite; y in [{model.positions[:, 1].min():.4f}, "
        f"{model.positions[:, 1].max():.4f}], "
        f"|v|max {np.abs(model.velocities).max():.4f}")
    main_state = (model.positions.copy(), model.velocities.copy())
    return types.SimpleNamespace(
        model=model, solver=solver, rest=rest, f=f, main_in=main_in,
        main_state=main_state, paths=paths, dev=dev)


def tiers_phase(torch, counted, b):
    """[2] Each configuration of ``TIER_SWITCHES`` through the tiers
    (:func:`tiered_runs`, each run a counted path), then the solver back
    on its default tiers at the main path's end state; and the small scene
    on the card against the float64 plain version on the CPU."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    solver, model, f, rest = b.solver, b.model, b.f, b.rest
    paths, main_state = b.paths, b.main_state
    t0 = time.perf_counter()
    # every configuration sets resident_contact_mode itself, so that the
    # paths do not depend on its default
    for label, switches, tier1, contact in TIER_SWITCHES:
        reprepare(solver, **switches)
        for run, counts in tiered_runs(torch, counted, solver, model, f,
                                       rest, label, tier1, contact).items():
            paths[f"{label}, {run}"] = counts
    log(f"[2] tiered runs {time.perf_counter() - t0:.1f} s")
    reprepare(solver, CHUNKED_TIER1_MIN_VERTS=type(
        solver).CHUNKED_TIER1_MIN_VERTS)
    model.positions, model.velocities = (x.copy() for x in main_state)

    # the small scene on the card against the float64 plain version
    results = []
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        m = small_scene(DeformableModel, cloth_model)
        s = scene_solver(synthetic_reduced_solver, m, K=6, r=8,
                         damping=0.07, device=device, dtype=dtype)
        g = gravity(m)
        s.step(g, num_iterations=6)
        s.run_steps(g, 7, num_iterations=6)
        results.append(m.positions.copy())
    d = float(np.abs(results[0] - results[1]).max())
    scale = float(np.abs(results[1]).max())
    log(f"[2] small scene, card f32 vs CPU f64 plain after 8 steps: "
        f"max|dP| {d:.3e} (rel {d / scale:.3e}, tol {TOL_SMALL})")
    require(d <= TOL_SMALL * scale, "small scene disagrees with the reference")


def holds_phase(torch, b):
    """[3] Each kernel against its plain version on the bench scene, from
    the same state: one-step calls, the steps one call carries, contact
    mode's recursions -> the readings and the inputs that :func:`times_phase`
    times."""
    from animsnapbases_tpu_torch.ops.affine import (
        FLAG_SLOTS,
        MODE_SLOT,
        _launch_affine,
        affine_run_plain,
        resident_affine,
        resident_affine_contact,
        resident_affine_contact_plain,
        resident_affine_exit,
        resident_affine_exit_plain,
        resident_affine_plain,
    )
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        affine_chunked,
        affine_chunked_plain,
    )
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
        fused_reduced_iterations_plain,
    )
    from animsnapbases_tpu_torch.ops.resident import (
        force_term,
        predict,
        resident_multistep,
        resident_multistep_plain,
    )

    solver, model, f, dev = b.solver, b.model, b.f, b.dev
    main_in = b.main_in
    ro, ao = solver._resident, solver._affine
    fo = ro.fused
    # ---- 3. kernels against their plain versions -----------------------
    t_main = time.perf_counter()
    P = solver._to_device(model.positions)
    V = solver._to_device(model.velocities)
    Fx = solver._to_device(f)
    rb_extra = solver._rb_extra()
    sn, rb_const = predict(ro, P, V, force_term(ro, Fx), rb_extra)
    snT_sel = sn[:, :ro.n_sel]
    u_k = fused_reduced_iterations(fo, snT_sel, rb_const, ITERATIONS)
    u_p = fused_reduced_iterations_plain(fo, snT_sel, rb_const, ITERATIONS)
    fo64 = as_f64(fo)
    u_64 = fused_reduced_iterations_plain(fo64, snT_sel.double(),
                                          rb_const.double(), ITERATIONS)
    torch.cuda.synchronize()
    k1_abs = max_abs(u_k, u_p)
    ok, e_k, e_p = as_accurate(u_k, u_p, u_64)
    log(f"[3] kernel 1, u after {ITERATIONS} iterations: vs plain max abs "
        f"{k1_abs:.3e} (max|u| {float(u_p.abs().max()):.3e}); vs float64: "
        f"kernel {e_k:.3e}, plain {e_p:.3e} (limit {ACC_RATIO}x)")
    require(bool(torch.isfinite(u_k).all()) and ok,
            "kernel 1 is less accurate than its plain version")

    # kernel 2: a 64-step call must equal 64 one-step calls bit for bit
    # (the in-kernel step loop), and each of those steps is held against
    # the plain version from the same state (STEP_TOL).  A 64-step free run
    # is not held to a tolerance: with these random bases the step map
    # amplifies float32 rounding ~1.2x per step, so any two float32 orders
    # part by ~0.1-0.3 in position after 64 steps (printed below).
    k2_err = {}
    ro_f32 = dataclasses.replace(ro, U_liftT=ro.U_liftT.float(),
                                 ut_acT=ro.ut_acT.float())
    for label, r_ops in (("bfloat16", ro), ("float32", ro_f32)):
        # float64 plain version with the matrices in their storage type, so
        # that it rounds sn and u to it where the float32 versions do;
        # printed, not held (see STEP_TOL)
        ro64 = dataclasses.replace(r_ops, fused=fo64,
                                   mass_inv=r_ops.mass_inv.double())
        k2_err[label], (Pi, Vi) = step_by_step(
            torch, f"kernel 2 ({label} storage)", r_ops,
            lambda P_, V_, o=r_ops: resident_multistep(
                o, P_, V_, Fx, rb_extra, 1, ITERATIONS),
            lambda P_, V_, o=r_ops: resident_multistep_plain(
                o, P_, V_, Fx, rb_extra, 1, ITERATIONS),
            P, V, Fx, rb_extra, SCENE_STEPS,
            run_64=lambda P_, V_, o=ro64: resident_multistep_plain(
                o, P_.double(), V_.double(), Fx.double(), rb_extra.double(),
                1, ITERATIONS)[0])
        P_all, V_all = same_as_steps(
            torch, f"kernel 2 ({label} storage)",
            lambda P_, V_, o=r_ops: resident_multistep(
                o, P_, V_, Fx, rb_extra, SCENE_STEPS, ITERATIONS),
            P, V, Pi, Vi, SCENE_STEPS)
        Pp, Vp = resident_multistep_plain(r_ops, P, V, Fx, rb_extra,
                                          SCENE_STEPS, ITERATIONS)
        log(f"[3]   free {SCENE_STEPS}-step run, kernel vs plain (not held "
            f"to a tolerance): P {max_abs(P_all, Pp):.3e}, "
            f"V {max_abs(V_all, Vp):.3e}")

    # kernels 3, 4, 5: each step as a one-step call against the plain
    # version from the same state (STEP_TOL), on contact-free steps (the
    # tier-1 window that bench.py times: no external force, from the main
    # path's end state at a tenth of its velocity) and, for kernel 3, on the
    # bench scene falling under gravity until it reaches the floor.  One
    # call of SCENE_STEPS steps with a rebase (a chunk, for kernel 5) after
    # every step must equal the one-step calls bit for bit, which holds the
    # rebase path as well.
    Pw, Vw = P, 0.1 * V
    F0 = torch.zeros_like(Fx)
    Pc, Vc = (solver._to_device(x) for x in contact_state(model))

    def one(fn, F_, **kw):
        def run(P_, V_):
            out = fn(ao, P_, V_, F_, rb_extra, 1, ITERATIONS, **kw)
            require(len(out) == 2 or out[2] == 1,
                    f"{fn.__name__} stopped on a contact-free step")
            return out[:2]
        return run

    affine_err = {}
    for label, fn, plain, scenes in (
            ("kernel 5", affine_chunked, affine_chunked_plain,
             ((Pw, Vw, F0, "window"),)),
            ("kernel 4", resident_affine_exit, resident_affine_exit_plain,
             ((Pw, Vw, F0, "window"),)),
            ("kernel 3", resident_affine, resident_affine_plain,
             ((Pw, Vw, F0, "window"), (P, V, Fx, "falling"))),
            ("kernel 3 (contact mode)", resident_affine_contact,
             resident_affine_contact_plain,
             ((Pw, Vw, F0, "window"), (P, V, Fx, "falling")))):
        errs = []
        for P0, V0, F_, scene in scenes:
            err, (Pi, Vi) = step_by_step(
                torch, f"{label} ({scene} scene)", ro, one(fn, F_),
                one(plain, F_), P0, V0, F_, rb_extra, SCENE_STEPS)
            same_as_steps(
                torch, f"{label} ({scene} scene, rebase_every=1)",
                lambda P_, V_, F_=F_: fn(ao, P_, V_, F_, rb_extra,
                                         SCENE_STEPS, ITERATIONS,
                                         rebase_every=1),
                P0, V0, Pi, Vi, SCENE_STEPS)
            errs.append(err)
        affine_err[label] = max(errs)
    # the steps one call carries inside it (kernel 5's coefficients within
    # a chunk, kernels 3 and 4 between rebases, and in contact mode its y
    # state), each held against a plain step from the kernel's own state
    # (:func:`carried_steps`): over the main path's own run_steps window
    # (kernel 5 as the main path ran it: one chunk of 64 steps under
    # gravity), over the tier-1 window and, in contact mode, over the
    # contact scene with rebases every 256 (none), 3 and 16 steps: contact
    # mode entered, carried and left at a rebase on the card.  A rebase or
    # a chunk's end re-anchors at the materialized state; that is held by
    # the one-step calls and the rebase_every=1 calls above.
    Pm, Vm = (solver._to_device(x) for x in main_in)
    contact_flags = {}
    for kernel, every, P0, V0, F_, scene in (
            (5, CHUNK_EVERY, Pm, Vm, Fx, "main path's run_steps window"),
            (5, CHUNK_EVERY, Pw, Vw, F0, "window scene"),
            (4, REBASE_EVERY, Pw, Vw, F0, "window scene"),
            (3, REBASE_EVERY, Pw, Vw, F0, "window scene"),
            ("3c", REBASE_EVERY, Pw, Vw, F0, "window scene"),
            *(("3c", every, Pc, Vc, Fx, f"contact scene, rebase_every="
               f"{every}") for every in CONTACT_EVERY)):
        label = ("kernel 3 (contact mode)" if kernel == "3c"
                 else f"kernel {kernel}")
        plain = {5: affine_chunked_plain, 4: resident_affine_exit_plain,
                 3: resident_affine_plain,
                 "3c": resident_affine_contact_plain}[kernel]
        err, flags = carried_steps(
            torch, f"{label} ({scene}), carried steps", kernel, ao,
            lambda *a, plain=plain, every=every: plain(
                *a, rebase_every=every), P0, V0, F_, rb_extra, SCENE_STEPS,
            every)
        affine_err[label] = max(affine_err[label], err)
        if F_ is Fx and kernel == "3c":
            contact_flags[every] = flags[FLAG_SLOTS:]
    # contact mode on the card: the steps it served, its entries (after a
    # rebase left it), and the drift of the recursions buPy/buVy at the last
    # contact step before a rebase, against U^T A_c of the carried Py/Vy
    # taken afresh (as a rebase takes it: Py rounded to the storage type,
    # float64 sums) and unrounded in float64, beside the plain version's
    for every, fl in contact_flags.items():
        log(f"[3] kernel 3 (contact mode), contact scene, rebase_every="
            f"{every}: {int(((fl & 2) > 0).sum())} of {SCENE_STEPS} steps in "
            f"contact mode, entered {int((fl & 1).sum())} times")
        require(int((fl & 1).sum()) >= (2 if every < SCENE_STEPS else 1),
                f"contact mode was not entered (again after a rebase) with "
                f"rebase_every={every}")
    drift, off64 = {}, {}
    ro64 = dataclasses.replace(ro, fused=fo64, mass_inv=ro.mass_inv.double())
    # the float64 step with the matrices unrounded (float64, as prepared on
    # the host), beside the one with them in their storage type
    rox = dataclasses.replace(ro64, **{
        k: torch.as_tensor(np.ascontiguousarray(x[:, :, ro.perm]),
                           device=dev) for k, x in (
            ("U_liftT", solver.U.transpose(2, 1, 0)),
            ("ut_acT", solver._ut_ac_np))})
    for every, steps in ((CONTACT_EVERY[-1], CONTACT_EVERY[-1]),
                         (REBASE_EVERY, SCENE_STEPS),
                         (REBASE_EVERY, DRIFT_STEPS)):
        Pk, Vk, flags, _, y = _launch_affine(ao, Pc, Vc, Fx, rb_extra, steps,
                                             ITERATIONS, every, "contact")
        # what the drift does to the next step: the contact-mode step
        # carried on against the lean step from the same materialized
        # state, each beside the float64 step from it (printed, not held)
        P1 = resident_affine_contact(ao, Pc, Vc, Fx, rb_extra, steps + 1,
                                     ITERATIONS, rebase_every=steps + 1)[0]
        Pl = resident_affine(ao, Pk, Vk, Fx, rb_extra, 1, ITERATIONS)[0]
        P64, Px = (resident_multistep_plain(
            o, Pk.double(), Vk.double(), Fx.double(), rb_extra.double(), 1,
            ITERATIONS)[0] for o in (ro64, rox))
        off64[steps] = (max_abs(P1, P64), max_abs(Pl, P64),
                        max_abs(P64, Pk), max_abs(P1, Px), max_abs(Pl, Px))
        ctx_p, st_p, _ = affine_run_plain(ao, Pc, Vc, Fx, rb_extra, steps,
                                          ITERATIONS, every, True)
        require(bool(int(flags[MODE_SLOT])) and bool(st_p.mode),
                f"contact mode is off after {steps} steps")
        for who, (Py, Vy, buPy, buVy) in (
                ("kernel", y), ("plain", (st_p.Py, st_p.Vy, st_p.buPy,
                                          st_p.buVy))):
            for key, yrow, bu in (("buPy", Py, buPy), ("buVy", Vy, buVy)):
                fresh = ctx_p.project_y(yrow).double()
                exact = ro.ut_acT[1].double() @ yrow.double()
                drift[(steps, who, key)] = tuple(
                    float(torch.linalg.vector_norm(bu.double() - ref)
                          / torch.linalg.vector_norm(ref))
                    for ref in (fresh, exact))
        log(f"[3] kernel 3 (contact mode), contact scene, drift of the "
            f"recursions after {steps} steps (rebase_every={every}), |bu - "
            f"U^T A_c y| / |U^T A_c y| against the rounded / the float64 "
            f"projection: " + ", ".join(
                f"{who} {key} {a:.3e} / {b:.3e}"
                for (n_, who, key), (a, b) in drift.items() if n_ == steps)
            + "; the next step's P from the float64 step with the matrices "
            "stored / unrounded (not held): contact mode carried on "
            f"{off64[steps][0]:.3e} / {off64[steps][3]:.3e}, lean from the "
            f"materialized state {off64[steps][1]:.3e} / "
            f"{off64[steps][4]:.3e} (step size {off64[steps][2]:.3e})")
    # how many of the falling scene's steps clamped
    Pi, Vi, n_fall = P, V, 0
    for _ in range(SCENE_STEPS):
        Pi, Vi, flags, _, _ = _launch_affine(ao, Pi, Vi, Fx, rb_extra, 1,
                                             ITERATIONS, REBASE_EVERY, "lean")
        n_fall += int(flags[FLAG_SLOTS])
    log(f"[3] kernel 3 (falling scene): {n_fall} of its "
        f"{SCENE_STEPS} steps clamped")

    # the contact scene's steps, one by one: a clamped step of kernel 3
    # (its contact tail) must equal kernel 2's step from the same state bit
    # for bit; a free step must be within STEP_TOL of the plain version's
    # step.  On clamped steps kernel 3 against its plain version is
    # printed, not held: while the cloth crumples on the floor the loop's
    # clamps branch differently in two float32 orders at some states
    # (kernel 2 against its plain version parts there by the same
    # amounts); both are printed beside their distance from the float64
    # step.
    fa = force_term(ro, Fx)

    def held_contact_step(label, Pi, Vi):
        """One kernel-3 step from (Pi, Vi), held as above -> (P', V',
        clamped, its share of the plain version's step size, the plain
        version's P')."""
        P3, V3, flags, _, _ = _launch_affine(ao, Pi, Vi, Fx, rb_extra, 1,
                                             ITERATIONS, REBASE_EVERY, "lean")
        Pp, Vp = resident_affine_plain(ao, Pi, Vi, Fx, rb_extra, 1,
                                       ITERATIONS)
        shares = step_share(ro, fa, rb_extra, Pi, Vi, P3, V3, Pp, Vp)
        clamped = bool(int(flags[FLAG_SLOTS]))
        if clamped:
            P2, V2 = resident_multistep(ro, Pi, Vi, Fx, rb_extra, 1,
                                        ITERATIONS)
            require(bool(torch.equal(P3, P2) and torch.equal(V3, V2)),
                    f"{label}: a clamped step of kernel 3 differs from "
                    "kernel 2's step")
        else:
            hold_step(f"{label}, a free step of kernel 3", shares)
        share = max(d / s if s > 0 else 0.0 for d, s in shares.values())
        return P3, V3, clamped, share, Pp

    Pi, Vi = Pc, Vc
    n_contact, within, share_max, free_max = 0, 0, 0.0, 0.0
    off64, nearer = [0.0, 0.0], 0
    for _ in range(SCENE_STEPS):
        P3, V3, clamped, share, Pp = held_contact_step("contact scene", Pi,
                                                       Vi)
        P64, _ = resident_multistep_plain(ro64, Pi.double(), Vi.double(),
                                          Fx.double(), rb_extra.double(), 1,
                                          ITERATIONS)
        d64 = (max_abs(P3, P64), max_abs(Pp, P64))
        off64 = [max(off64[0], d64[0]), max(off64[1], d64[1])]
        nearer += d64[0] <= d64[1]
        n_contact += clamped
        within += share <= STEP_TOL
        share_max = max(share_max, share)
        if not clamped:
            free_max = max(free_max, share)
        Pi, Vi = P3, V3
    torch.cuda.synchronize()
    log(f"[3] kernel 3 (contact scene): {n_contact} of {SCENE_STEPS} steps "
        f"clamped, each equal to kernel 2's step bit for bit; its "
        f"{SCENE_STEPS - n_contact} free steps within {STEP_TOL} of the "
        f"plain version's step size (held), at most {free_max:.3e} of it; "
        f"over all steps against the plain version within {STEP_TOL} on "
        f"{within} of {SCENE_STEPS}, at most {share_max:.3e} (not held on "
        f"clamped steps); P distance from the float64 step: kernel at most "
        f"{off64[0]:.3e}, plain at most {off64[1]:.3e}, the kernel as near "
        f"or nearer on {nearer} of {SCENE_STEPS} steps")
    require(n_contact > 0, "no step of the contact scene clamped")
    same_as_steps(torch, "kernel 3 (contact scene, rebase_every=1)",
                  lambda P_, V_: resident_affine(ao, P_, V_, Fx, rb_extra,
                                                 SCENE_STEPS, ITERATIONS,
                                                 rebase_every=1),
                  Pc, Vc, Pi, Vi, SCENE_STEPS)
    # the tier-1 kernels on the contact scene: the same steps done, and the
    # committed state within STEP_TOL of the committed change; then the
    # hand-over: kernel 3's first step from the state tier 1 committed,
    # held as the contact scene's steps are
    for label, fn, plain in (
            ("kernel 5", affine_chunked, affine_chunked_plain),
            ("kernel 4", resident_affine_exit, resident_affine_exit_plain)):
        Pk, Vk, kk = fn(ao, Pc, Vc, Fx, rb_extra, SCENE_STEPS, ITERATIONS,
                        rebase_every=16)
        Pp, Vp, kp = plain(ao, Pc, Vc, Fx, rb_extra, SCENE_STEPS,
                           ITERATIONS, rebase_every=16)
        dP, dV = max_abs(Pk, Pp), max_abs(Vk, Vp)
        sP, sV = max_abs(Pp, Pc), max_abs(Vp, Vc)
        log(f"[3] {label} (contact scene, rebase_every=16): steps done "
            f"kernel {kk}, plain {kp}; committed state vs plain: P {dP:.3e} "
            f"of a change {sP:.3e}, V {dV:.3e} of a change {sV:.3e}")
        require(kk == kp and 0 < kk < SCENE_STEPS,
                f"{label}: steps done differ on the contact scene")
        require(dP <= STEP_TOL * sP and dV <= STEP_TOL * sV,
                f"{label}: committed contact-scene state differs")
        affine_err[label] = max(affine_err[label], dP, dV)
        _, _, clamped, share, _ = held_contact_step(
            f"hand-over from {label}", Pk, Vk)
        log(f"[3] hand-over from {label} to kernel 3 after {kk} steps: its "
            + ("first step clamped, equal to kernel 2's step bit for bit"
               if clamped else f"first step free, {share:.3e} of the plain "
               f"version's step size (tol {STEP_TOL})"))

    log(f"[3] bench scene holds {time.perf_counter() - t_main:.1f} s")
    return types.SimpleNamespace(
        k1_abs=k1_abs, k2_err=k2_err, affine_err=affine_err, drift=drift,
        P=P, V=V, Fx=Fx, rb_extra=rb_extra, sn=sn, rb_const=rb_const,
        snT_sel=snT_sel, u_k=u_k, Pw=Pw, Vw=Vw, F0=F0, Pc=Pc, Vc=Vc)


def times_phase(torch, b, h):
    """[4] The bench scene's times beside each kernel's bound, the staging
    plans, and the entry point over the tier-1 window; [5] the six solo
    kernels' entries of the kernels line -> those entries."""
    from animsnapbases_tpu_torch.ops.affine import (
        FLAG_SLOTS,
        _launch_affine,
        affine_plan,
        resident_affine,
        resident_affine_contact,
        resident_affine_contact_plain,
        resident_affine_exit,
        resident_affine_exit_plain,
        resident_affine_plain,
    )
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        advance,
        affine_chunked,
        affine_chunked_plain,
        chunk_anchors,
        chunk_plan,
    )
    from animsnapbases_tpu_torch.ops.cluster import (
        THREADS as CLUSTER_THREADS,
        resident_clusters,
    )
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_plan,
        fused_reduced_iterations,
        fused_reduced_iterations_plain,
    )
    from animsnapbases_tpu_torch.ops.resident import (
        force_term,
        resident_multistep,
        resident_multistep_plain,
        resident_plan,
    )

    solver, model, f, dev, paths = b.solver, b.model, b.f, b.dev, b.paths
    ro, ao = solver._resident, solver._affine
    fo = ro.fused
    k1_abs, k2_err, affine_err, drift = (h.k1_abs, h.k2_err, h.affine_err,
                                         h.drift)
    P, V, Fx, rb_extra = h.P, h.V, h.Fx, h.rb_extra
    sn, rb_const, snT_sel, u_k = h.sn, h.rb_const, h.snT_sel, h.u_k
    Pw, Vw, F0, Pc, Vc = h.Pw, h.Vw, h.F0, h.Pc, h.Vc
    t_main = time.perf_counter()
    # ---- 4. times --------------------------------------------------------
    # every kernel runs the cluster loop on the staging plan of its widths
    # (the C launch refuses a plan whose bytes differ from its own carving)
    plans = {}
    for name, fn, lib, plan in (
            ("kernel 1", fused_reduced_iterations, "fused_reduced",
             fused_plan(fo)),
            ("kernel 2", resident_multistep, "resident", resident_plan(ro)),
            ("kernels 3 and 4", resident_affine, "affine", affine_plan(ao)),
            ("kernel 5", affine_chunked, "affine_chunked", chunk_plan(ao))):
        plans[fn.__name__] = dict(plan.as_dict(),
                                  resident_clusters=resident_clusters(
                                      lib, plan))
        log(f"[4] {name}: staging plan {list(plan.staged)} in shared "
            f"memory, {list(plan.from_l2) or 'nothing'} from L2, "
            f"{plan.smem_bytes} B a block; a cluster of 3 blocks of "
            f"{CLUSTER_THREADS} threads (one a dimension) per sim, "
            f"{plans[fn.__name__]['resident_clusters']} clusters resident at "
            f"once")
    # kernel 1: a call between two events (the wrapper's host time
    # included, which its launch outlasted when it was one block), and the
    # device time per launch, the kernel's own
    k1_ms = cuda_ms(torch, lambda: fused_reduced_iterations(
        fo, snT_sel, rb_const, ITERATIONS), reps=200)
    k1_plain_ms = cuda_ms(torch, lambda: fused_reduced_iterations_plain(
        fo, snT_sel, rb_const, ITERATIONS), reps=PLAIN_REPS, warmup=0)
    k1_bound, k1_by = bound_ms(*k1_cost(fo, ro.n_sel, ITERATIONS))
    # where kernel 1's time goes: the slope over the iteration count is
    # the loop body, the intercept the staging, the gather and the solve
    k1_at = {it: cuda_ms(torch, lambda it=it: fused_reduced_iterations(
        fo, snT_sel, rb_const, it), reps=100) for it in (0, 1, 20)}
    k1_dev = {it: device_ms(torch, lambda it=it: fused_reduced_iterations(
        fo, snT_sel, rb_const, it), reps=100)
        for it in (0, ITERATIONS, 20)}
    k1_slope = 1e3 * (k1_dev[20] - k1_dev[0]) / 20
    k1_floor = loop_floor_ms(k1_cost(fo, ro.n_sel, ITERATIONS)[1]["float32"])
    log(f"[4] kernel 1: {1e3 * k1_ms:.2f} us/call at {ITERATIONS} "
        f"iterations ({1e3 * k1_dev[ITERATIONS]:.2f} us/launch on the "
        f"device); plain {1e3 * k1_plain_ms:.1f} us; bound "
        f"{1e3 * k1_bound:.4f} us ({k1_by}); its operations on the "
        f"cluster's {CLUSTER_SMS} SMs {1e3 * k1_floor:.4f} us, and "
        f"{ITERATIONS} exchanges")
    log(f"[4] kernel 1 by iterations: " + ", ".join(
        f"{it}: {1e3 * ms:.2f} us" for it, ms in k1_at.items())
        + f"; slope {1e3 * (k1_at[20] - k1_at[1]) / 19:.3f} us/iteration")
    log(f"[4] kernel 1 by iterations (device): " + ", ".join(
        f"{it}: {1e3 * ms:.2f} us" for it, ms in k1_dev.items())
        + f"; slope {k1_slope:.3f} us/iteration, intercept "
        f"{1e3 * k1_dev[0]:.2f} us/launch")

    def k2_call():
        return resident_multistep(ro, P, V, Fx, rb_extra, SCENE_STEPS,
                                  ITERATIONS)

    k2_ms = cuda_ms(torch, k2_call)
    k2_plain_ms = cuda_ms(torch, lambda: resident_multistep_plain(
        ro, P, V, Fx, rb_extra, SCENE_STEPS, ITERATIONS), reps=PLAIN_REPS,
        warmup=0)
    k2_bound, k2_by = bound_ms(*k2_cost(ro, SCENE_STEPS, ITERATIONS))
    window_ms = cuda_ms(torch, lambda: resident_multistep(
        ro, P, V, Fx, rb_extra, WINDOW_STEPS, ITERATIONS), warmup=1)
    # kernel 2 with no iterations: predictor, projection, solve and lift
    # launches alone
    k2_noiter_ms = cuda_ms(torch, lambda: resident_multistep(
        ro, P, V, Fx, rb_extra, SCENE_STEPS, 0))
    # the one part a single library call computes: the (3, r, N) x (3, N)
    # projection and the lift, as torch.matmul on the stored matrices (the
    # port never calls it on the kernel path)
    snm = sn.to(ro.ut_acT.dtype)[:, :, None]
    um = u_k.to(ro.U_liftT.dtype)[:, None, :]
    part_ms = cuda_ms(torch, lambda: (torch.matmul(ro.ut_acT, snm),
                                      torch.matmul(um, ro.U_liftT)))
    log(f"[4] kernel 2: {1e3 * k2_ms / SCENE_STEPS:.2f} us/step "
        f"({k2_ms:.3f} ms per {SCENE_STEPS}-step call); plain "
        f"{1e3 * k2_plain_ms / SCENE_STEPS:.1f} us/step; bound "
        f"{1e3 * k2_bound / SCENE_STEPS:.4f} us/step ({k2_by})")
    log(f"[4] kernel 2 at 0 iterations: "
        f"{1e3 * k2_noiter_ms / SCENE_STEPS:.2f} us/step")
    log(f"[4] kernel 2 over {WINDOW_STEPS} steps (median of {REPS}): "
        f"{1e3 * window_ms / WINDOW_STEPS:.2f} us/step = "
        f"{WINDOW_STEPS / (window_ms / 1e3):.0f} steps/s")
    log(f"[4] library part (torch.matmul projection + lift, one step): "
        f"{1e3 * part_ms:.2f} us")

    # the tier-1 window (phase 3) over WINDOW_STEPS: contact-free, the
    # tier-1 kernels must complete every step
    k = affine_chunked(ao, Pw, Vw, F0, rb_extra, WINDOW_STEPS, ITERATIONS)[2]
    require(k == WINDOW_STEPS, f"the {WINDOW_STEPS}-step window is not "
            f"contact-free (kernel 5 stopped after {k} steps)")

    def k5(steps, iters=ITERATIONS):
        return lambda: affine_chunked(ao, Pw, Vw, F0, rb_extra, steps, iters)

    k5_ms = cuda_ms(torch, k5(SCENE_STEPS))
    k5_window_ms = cuda_ms(torch, k5(WINDOW_STEPS), warmup=1)
    # the loop's slope and the step's intercept over the window: 20
    # iterations against 10 (with none the window would reach the floor)
    k = affine_chunked(ao, Pw, Vw, F0, rb_extra, WINDOW_STEPS, 20)[2]
    require(k == WINDOW_STEPS, f"the window at 20 iterations is not "
            f"contact-free (kernel 5 stopped after {k} steps)")
    k5_window20_ms = cuda_ms(torch, k5(WINDOW_STEPS, 20), reps=5, warmup=1)
    k5_at = {it: cuda_ms(torch, k5(SCENE_STEPS, it)) for it in (0, 20)}
    k5_plain_ms = cuda_ms(torch, lambda: affine_chunked_plain(
        ao, Pw, Vw, F0, rb_extra, SCENE_STEPS, ITERATIONS), reps=PLAIN_REPS,
        warmup=0)
    k5_bound, k5_by = bound_ms(*k5_cost(ao, SCENE_STEPS, ITERATIONS,
                                        CHUNK_EVERY))
    k5_wbound, _ = bound_ms(*k5_cost(ao, WINDOW_STEPS, ITERATIONS,
                                     CHUNK_EVERY))
    # the outer loop's work between two chunks: the anchors' projections and
    # gathered columns, and the two lifts that materialize the chunk's end
    fa0 = force_term(ro, F0)
    ap = av = torch.eye(3, device=dev)
    wp = wv = torch.zeros(3, fo.r, device=dev)
    outer_ms = cuda_ms(torch, lambda: (chunk_anchors(ao, Pw, Vw),
                                        advance(ao, Pw, Vw, fa0, ap, av, wp,
                                                wv)))
    # the exact floor check on its own: the same call with both bounds
    # made to trip on every step after the first (a huge Cauchy-Schwarz
    # constant and interval constants) and a floor below every vertex, so
    # that each exact check runs and clears
    big = torch.full_like(ao.y_range[0], 1e18)
    ao_trip = dataclasses.replace(ao, umax=1e18,
                                  y_range=torch.stack([-big, big]),
                                  res=dataclasses.replace(ro, floor_h=-1e3))
    k5_trip_ms = cuda_ms(torch, lambda: affine_chunked(
        ao_trip, Pw, Vw, F0, rb_extra, SCENE_STEPS, ITERATIONS))
    exact_us = 1e3 * (k5_trip_ms - k5_ms) / (SCENE_STEPS - 1)
    slope = 1e3 * (k5_at[20] - k5_at[0]) / (20 * SCENE_STEPS)
    w_slope = 1e3 * (k5_window20_ms - k5_window_ms) / (
        (20 - ITERATIONS) * WINDOW_STEPS)
    w_intercept = 1e3 * k5_window_ms / WINDOW_STEPS - ITERATIONS * w_slope
    k5_floor = loop_floor_ms(small_cost(ao, ITERATIONS, fo.g_total)[1])
    log(f"[4] kernel 5: {1e3 * k5_ms / SCENE_STEPS:.2f} us/step "
        f"({k5_ms:.3f} ms per {SCENE_STEPS}-step call); over "
        f"{WINDOW_STEPS} steps {1e3 * k5_window_ms / WINDOW_STEPS:.2f} us/"
        f"step = {WINDOW_STEPS / (k5_window_ms / 1e3):.0f} steps/s; plain "
        f"{1e3 * k5_plain_ms / SCENE_STEPS:.1f} us/step; bound "
        f"{1e3 * k5_bound / SCENE_STEPS:.4f} us/step ({k5_by}), "
        f"{1e3 * k5_wbound / WINDOW_STEPS:.4f} us/step over {WINDOW_STEPS}")
    log(f"[4] kernel 5 by iterations ({SCENE_STEPS}-step calls): 0: "
        f"{1e3 * k5_at[0] / SCENE_STEPS:.2f} us/step, 20: "
        f"{1e3 * k5_at[20] / SCENE_STEPS:.2f} us/step; slope {slope:.3f} "
        f"us/iteration, intercept {1e3 * k5_at[0] / SCENE_STEPS:.2f} us/"
        f"step; over the {WINDOW_STEPS}-step window at 20 iterations "
        f"{1e3 * k5_window20_ms / WINDOW_STEPS:.2f} us/step: slope "
        f"{w_slope:.3f} us/iteration, intercept {w_intercept:.2f} us/step; "
        f"a step's operations on the cluster's {CLUSTER_SMS} SMs "
        f"{1e3 * k5_floor:.4f} us, and {ITERATIONS} exchanges; outer loop "
        f"between chunks {1e3 * outer_ms:.1f} us per chunk; with the exact "
        f"check on every step "
        f"{1e3 * k5_trip_ms / SCENE_STEPS:.2f} us/step, so the exact check "
        f"costs {exact_us:.2f} us")

    def affine_call(fn, P_, V_, F_):
        return lambda: fn(ao, P_, V_, F_, rb_extra, SCENE_STEPS, ITERATIONS)

    k3_ms = cuda_ms(torch, affine_call(resident_affine, Pw, Vw, F0))
    k4_ms = cuda_ms(torch, affine_call(resident_affine_exit, Pw, Vw, F0))
    require(resident_affine_exit(ao, Pw, Vw, F0, rb_extra, SCENE_STEPS,
                                 ITERATIONS)[2] == SCENE_STEPS,
            "kernel 4 stopped in the contact-free window")
    k3_plain_ms = cuda_ms(torch, affine_call(resident_affine_plain, Pw, Vw,
                                             F0), reps=PLAIN_REPS, warmup=0)
    k4_plain_ms = cuda_ms(torch, affine_call(resident_affine_exit_plain, Pw,
                                             Vw, F0), reps=PLAIN_REPS,
                          warmup=0)
    k3_bound, k3_by = bound_ms(*k3_cost(ao, SCENE_STEPS, ITERATIONS,
                                        REBASE_EVERY, 0))
    # the contact scene's window: how many of its steps clamp, kernel 3's
    # time on it beside kernel 2's on the same steps
    flags = _launch_affine(ao, Pc, Vc, Fx, rb_extra, SCENE_STEPS, ITERATIONS,
                           REBASE_EVERY, "lean")[2]
    n_contact = int(flags[FLAG_SLOTS:].sum())   # in one call, as timed
    k3c_ms = cuda_ms(torch, affine_call(resident_affine, Pc, Vc, Fx))
    k2c_ms = cuda_ms(torch, lambda: resident_multistep(
        ro, Pc, Vc, Fx, rb_extra, SCENE_STEPS, ITERATIONS))
    k3c_bound, k3c_by = bound_ms(*k3_cost(ao, SCENE_STEPS, ITERATIONS,
                                          REBASE_EVERY, n_contact))
    log(f"[4] kernel 3, free steps: {1e3 * k3_ms / SCENE_STEPS:.2f} us/step "
        f"({k3_ms:.3f} ms per {SCENE_STEPS}-step call); plain "
        f"{1e3 * k3_plain_ms / SCENE_STEPS:.1f} us/step; bound "
        f"{1e3 * k3_bound / SCENE_STEPS:.4f} us/step ({k3_by})")
    log(f"[4] contact scene, {n_contact} of {SCENE_STEPS} steps clamp: "
        f"kernel 3 {1e3 * k3c_ms / SCENE_STEPS:.2f} us/step (bound "
        f"{1e3 * k3c_bound / SCENE_STEPS:.4f}, {k3c_by}); kernel 2 on the "
        f"same steps {1e3 * k2c_ms / SCENE_STEPS:.2f} us/step")
    log(f"[4] kernel 4: {1e3 * k4_ms / SCENE_STEPS:.2f} us/step "
        f"({k4_ms:.3f} ms per {SCENE_STEPS}-step call); plain "
        f"{1e3 * k4_plain_ms / SCENE_STEPS:.1f} us/step; bound "
        f"{1e3 * k3_bound / SCENE_STEPS:.4f} us/step ({k3_by})")
    # kernel 3's contact-mode build on the contact scene, whose steps clamp,
    # and on the free steps of the tier-1 window (its comparison with the
    # lean build, on which resident_contact_mode's default rests, is
    # tools/ab_contact_mode.py)
    mflags = _launch_affine(ao, Pc, Vc, Fx, rb_extra, SCENE_STEPS, ITERATIONS,
                            REBASE_EVERY, "contact")[2][FLAG_SLOTS:]
    m_contact = int(((mflags & 2) > 0).sum())
    k3m_ms = cuda_ms(torch, affine_call(resident_affine_contact, Pc, Vc, Fx))
    k3m_free_ms = cuda_ms(torch, affine_call(resident_affine_contact, Pw,
                                             Vw, F0))
    k3m_plain_ms = cuda_ms(torch, affine_call(resident_affine_contact_plain,
                                              Pc, Vc, Fx), reps=PLAIN_REPS,
                           warmup=0)
    k3m_bound, k3m_by = bound_ms(*k3m_cost(
        ao, SCENE_STEPS, ITERATIONS, REBASE_EVERY, m_contact, m_contact,
        int((mflags & 1).sum())))
    log(f"[4] kernel 3 (contact mode), contact scene ({m_contact} of "
        f"{SCENE_STEPS} steps in contact mode): {1e3 * k3m_ms / SCENE_STEPS:.2f}"
        f" us/step; plain {1e3 * k3m_plain_ms / SCENE_STEPS:.1f} us/step; "
        f"bound {1e3 * k3m_bound / SCENE_STEPS:.4f} us/step ({k3m_by}); free "
        f"steps {1e3 * k3m_free_ms / SCENE_STEPS:.2f} us/step")

    # the entry point over the same window, host transfers included
    model.positions = solver._to_host(Pw)
    model.velocities = solver._to_host(Vw)
    f0 = np.zeros_like(f)
    solver.run_steps(f0, SCENE_STEPS, num_iterations=ITERATIONS)  # warm-up
    model.positions = solver._to_host(Pw)
    model.velocities = solver._to_host(Vw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.run_steps(f0, WINDOW_STEPS, num_iterations=ITERATIONS)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    require(np.isfinite(model.positions).all(), "non-finite window state")
    require(solver._last_fast_steps == WINDOW_STEPS,
            "tier 1 did not certify the entry point's window")
    log(f"[4] run_steps entry point over {WINDOW_STEPS} steps on tier 1 "
        f"(certified): {WINDOW_STEPS / entry_s:.0f} steps/s")
    log(f"[4] bench scene times {time.perf_counter() - t_main:.1f} s")

    # ---- 5. kernel list and result -------------------------------------
    def entry(name, source, replaces, err, ms, plain_ms, bound, by, **extra):
        return {"name": name, "route": "cuda",
                "source": f"animsnapbases_tpu_torch/csrc/{source}",
                "replaces": f"animsnapbases_tpu/ops/{replaces}",
                "launches": paths[LAUNCH_PATH[name]][name],
                "launches_path": LAUNCH_PATH[name],
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": None, **extra}

    return [
        entry("fused_reduced_iterations", "fused_reduced.cu",
              "pallas_reduced.py:393", k1_abs, k1_ms, k1_plain_ms, k1_bound,
              k1_by, device_ms=k1_dev[ITERATIONS],
              device_us_per_iteration=k1_slope,
              device_intercept_us=1e3 * k1_dev[0],
              staging_plan=plans["fused_reduced_iterations"]),
        entry("resident_multistep", "resident.cu", "pallas_resident.py:415",
              k2_err["bfloat16"], k2_ms, k2_plain_ms, k2_bound, k2_by,
              steps_per_call=SCENE_STEPS,
              library_part_ms_per_step=part_ms,
              window_steps_per_s=WINDOW_STEPS / (window_ms / 1e3),
              contact_scene_ms=k2c_ms,
              staging_plan=plans["resident_multistep"]),
        entry("resident_affine", "affine.cu", "pallas_resident.py:558",
              affine_err["kernel 3"], k3_ms, k3_plain_ms, k3_bound, k3_by,
              steps_per_call=SCENE_STEPS, contact_scene_ms=k3c_ms,
              contact_scene_clamped_steps=n_contact,
              contact_scene_bound_ms=k3c_bound,
              staging_plan=plans["resident_affine"]),
        entry("resident_affine_exit", "affine.cu", "pallas_resident.py:980",
              affine_err["kernel 4"], k4_ms, k4_plain_ms, k3_bound, k3_by,
              steps_per_call=SCENE_STEPS,
              staging_plan=plans["resident_affine"]),
        entry("affine_chunked", "affine_chunked.cu",
              "pallas_resident.py:1145", affine_err["kernel 5"], k5_ms,
              k5_plain_ms, k5_bound, k5_by, steps_per_call=SCENE_STEPS,
              window_steps_per_s=WINDOW_STEPS / (k5_window_ms / 1e3),
              us_per_iteration=slope,
              intercept_us_per_step=1e3 * k5_at[0] / SCENE_STEPS,
              window_us_per_iteration=w_slope,
              window_intercept_us_per_step=w_intercept,
              staging_plan=plans["affine_chunked"],
              outer_loop_ms_per_chunk=outer_ms,
              exact_check_us=exact_us,
              entry_steps_per_s=WINDOW_STEPS / entry_s),
        entry("resident_affine_contact", "affine.cu",
              "pallas_resident.py:558", affine_err["kernel 3 (contact mode)"],
              k3m_ms, k3m_plain_ms, k3m_bound, k3m_by,
              steps_per_call=SCENE_STEPS, scene="contact scene",
              contact_mode_steps=m_contact, free_steps_ms=k3m_free_ms,
              staging_plan=plans["resident_affine"],
              recursion_drift={f"{n} steps, {who} {key}": v for (
                  n, who, key), v in drift.items()}),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    from animsnapbases_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    torch.manual_seed(0)
    counted = port_counters()
    smi = build_phase(torch)
    b = bench_phase(torch, counted, dev)
    battery = start_battery()
    try:
        return run_phases(torch, counted, dev, smi, b, battery)
    finally:
        if battery.proc.poll() is None:
            battery.proc.kill()
            battery.proc.wait()


def run_phases(torch, counted, dev, smi, b, battery) -> int:
    """Phases [2]-[12] and the two JSON lines, from phase [2]'s main path
    ``b``; ``battery`` the smoke battery, running since before phase [3]
    and waited for before phase [4]."""
    tiers_phase(torch, counted, b)
    held = holds_phase(torch, b)
    t0 = time.perf_counter()
    battery = battery_result(battery)
    log(f"[3] the smoke battery ended within {battery[3]:.1f} s of its "
        f"start (waited {time.perf_counter() - t0:.1f} s before phase [4])")
    kernels = times_phase(torch, b, held)
    solver, model, f, paths = b.solver, b.model, b.f, b.paths
    main_state, rest = b.main_state, b.rest
    # ---- ensemble serving: paths, holds and times ----------------------
    t0 = time.perf_counter()
    kernels += ensemble(torch, counted, solver, model, f, main_state, paths)
    log(f"[2-4] ensemble serving {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    options, exact_us_bench = chunk_options(torch, counted, paths, solver,
                                            model, f, rest, main_state)
    log(f"[2-4] kernel 5's other builds {time.perf_counter() - t0:.1f} s")
    anim = animated(torch, counted, paths, main_state, dev)
    for k in kernels:
        k["animated"] = anim.get(k["name"], {})
    t0 = time.perf_counter()
    per_scene = tet_bending(torch, counted, paths)
    for k in kernels:
        k["scenes"] = per_scene.get(k["name"], {})
    log(f"[2-4] tet, bending and block-form scenes "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mega = scale_phase(torch, counted, paths, dev)
    log(f"[2-4] scale: the megacloth {time.perf_counter() - t0:.1f} s")
    # phase [6]'s files, for phases [7] and [9]-[11]
    shared = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    real = pipeline_phase(torch, counted, paths, dev, work=shared.name)
    log(f"[6] pipeline: record, bases, reduced solve on real bases "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    per_group = per_group_phase(torch, counted, paths, dev, smi,
                                shared.name)
    log(f"[7] per-group workflow: record, bases, reduced solves "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    collide = self_collision_phase(torch, counted, paths, dev, smi)
    log(f"[8] self-collision: the clear tier, the proximity path, the FOM "
        f"passes {time.perf_counter() - t0:.1f} s")
    with shared:
        diff = diff_phase(torch, dev, smi, os.path.join(shared.name, "card",
                                                        "bases"),
                          os.path.join(shared.name, "card", "pos_basis.npz"))
        log(f"[9] differentiable rollouts: holds, the --bench fit, the twin "
            f"{diff['seconds']:.1f} s")
        t0 = time.perf_counter()
        posb = position_phase(torch, counted, paths, dev, smi, shared.name,
                              real["affine_chunked"]["vs_fom"])
        log(f"[10] position bases: record, align, PCA, SPLOCS, serving "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        scen = scenarios_phase(torch, counted, paths, dev, smi, shared.name)
        log(f"[11] scenarios, command lines and analysis "
            f"{time.perf_counter() - t0:.1f} s")
        multi = multichip_phase(torch, dev, smi, shared.name, solver,
                                main_state, battery)
        log(f"[12] sharded paths, battery, sweep and native I/O "
            f"{multi['seconds']:.1f} s")
    kernels += options
    for k in kernels:
        if k["name"] in mega:
            k["megacloth"] = mega[k["name"]]
        if k["name"] in real:
            k["real_bases"] = real[k["name"]]
        if k["name"] in per_group:
            k["per_group"] = per_group[k["name"]]
        if k["name"] in collide:
            k["self_collision"] = collide[k["name"]]
        if k["name"] in posb:
            k["position_bases"] = posb[k["name"]]
        if k["name"] in scen:
            k["scenarios"] = scen[k["name"]]
        if k["name"] in MC_KERNELS:
            k["multichip"] = multi["sharded"]["serving"][MC_KERNELS[
                k["name"]]]
    k5 = next(k for k in kernels if k["name"] == "affine_chunked")
    k5.update(exact_check_us_bound_off=exact_us_bench,
              megacloth_exact_check_us=mega["exact_check_us"],
              megacloth_staging_plan=mega["staging_plan"],
              megacloth_empty_chunk_us=mega["empty_chunk_us"],
              megacloth_prepare_s=mega["prepare_s"])
    log(f"[5] launches per path (the kernels that launched): " + json.dumps(
        {p_: {k: v for k, v in c.items() if v} for p_, c in paths.items()}))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
