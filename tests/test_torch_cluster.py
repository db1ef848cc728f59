"""The cluster loop of kernels 1-5 on the CPU, where no kernel runs: the
staging plan's Python mirror (``animsnapbases_tpu_torch.ops.cluster``) at
the widths of the scenes ``chip_smoke.py`` runs, the batched launch's
choice of plan, the projection order (``ops/fused_reduced.py``
``warp_runs``), and the arguments the wrappers hand the cluster launches
(``fused_args``, ``resident_args``, ``affine_args``, ``chunk_args``),
checked against their C entry points' argument types."""

import dataclasses

import pytest
import torch

import chip_smoke as cs
from animsnapbases_tpu_torch.geometry.procedural import cloth_model
from animsnapbases_tpu_torch.ops import affine as k3
from animsnapbases_tpu_torch.ops import affine_chunked as k5
from animsnapbases_tpu_torch.ops import fused_reduced as k1
from animsnapbases_tpu_torch.ops import resident as k2
from animsnapbases_tpu_torch.ops.cluster import (
    SMEM_MAX,
    STAGE_BITS,
    buffer_elems,
    launch_plan,
    pad4,
    staging_plan,
)
from animsnapbases_tpu_torch.ops.fused_reduced import gather_vc, warp_runs
from animsnapbases_tpu_torch.ops.resident import force_term, project
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.utils.synthetic import synthetic_reduced_solver

# (r, g_total, m_total, n_sel) of the scenes chip_smoke.py runs, as their
# solvers prepare them: the bench scene (40 DEIM rows per group); the
# megacloth (r = 48, 6 rows per group: 18 tri and 12 spring columns, n_sel
# at most g); the reference's tet bar with tets_deformation_gradient in row
# and block form (93 selected tets, 279 block rows), with tets_strain and
# verts_bending; the bench cloth with bending in row and block form
WIDTHS = {
    "bench": (64, 200, 80, 199),
    "megacloth": (48, 30, 12, 30),
    "bar, row form": (64, 372, 93, 293),
    "bar, block form": (64, 372, 279, 289),
    "bar, strain and bending": (64, 405, 126, 434),
    "bending cloth": (64, 233, 113, 421),
    "bending cloth, block form": (64, 233, 153, 421),
}
K5 = ("C", "WT", "inv3", "M_utac", "UG")
# what kernel 5's default build (fold_vc) stages at each: on the bar the
# per-step UG_d (95 KB, 104 KB) no longer fits beside the loop's operands
K5_STAGED = {scene: K5 for scene in WIDTHS}
K5_STAGED["bar, row form"] = K5[:4]
K5_STAGED["bar, block form"] = K5[:4]
K5_STAGED["bar, strain and bending"] = K5[:4]
K3 = ("C", "WT", "inv3", "M_utac", "U_selT")
# what kernels 3 and 4 stage at each: on the bar and the bending cloth
# U_selT_d (75-112 KB) no longer fits beside the rest
K3_STAGED = {scene: K3[:4] for scene in WIDTHS}
K3_STAGED["bench"] = K3
K3_STAGED["megacloth"] = K3


def _elems(name, r, g, m, n_sel):
    return {"C": r * pad4(g), "WT": m * pad4(r), "inv3": r * pad4(r),
            "M_utac": r * pad4(r), "UG": r * pad4(g),
            "U_selT": r * pad4(n_sel)}[name]


def _held(plan, kernel, widths, fold_vc=True):
    """The plan's rules: its bytes are the block's buffers and what
    stages, within a block's shared memory; each operand left in L2 would
    not have fitted beside what staged before it (staging order)."""
    r, g, m, n_sel = widths
    total = 4 * buffer_elems(kernel, r, g, m, n_sel, fold_vc)
    for name, _ in plan.operand_bytes:
        nbytes = 4 * _elems(name, *widths)
        if name in plan.staged:
            total += nbytes
        else:
            assert name in plan.from_l2
            assert total + nbytes > SMEM_MAX, name
    assert plan.smem_bytes == total <= SMEM_MAX
    assert plan.bits == sum(STAGE_BITS[n] for n in plan.staged)
    order = [n for n, _ in plan.operand_bytes]
    assert list(plan.staged) == [n for n in order if n in plan.staged]


@pytest.mark.parametrize("scene", sorted(WIDTHS))
def test_staging_plan_at_scene_widths(scene):
    widths = WIDTHS[scene]
    p1 = staging_plan("fused_reduced", *widths)
    assert p1.staged == ("C", "WT", "inv3") and p1.from_l2 == ()
    _held(p1, "fused_reduced", widths)
    p5 = staging_plan("affine_chunked", *widths)
    assert p5.staged == K5_STAGED[scene]
    assert p5.from_l2 == tuple(n for n in K5 if n not in p5.staged)
    _held(p5, "affine_chunked", widths)
    p5s = staging_plan("affine_chunked", *widths, fold_vc=False)
    assert [n for n, _ in p5s.operand_bytes][-1] == "U_selT"
    _held(p5s, "affine_chunked", widths, fold_vc=False)


@pytest.mark.parametrize("scene", sorted(WIDTHS))
def test_staging_plan_of_kernels_2_to_4_at_scene_widths(scene):
    """Kernel 2 stages what kernel 1 does, in the same bytes (its block
    holds the loop's buffers only); kernels 3 and 4 stage C, WT, inv3,
    M_utac and U_selT in that order while they fit, U_selT whatever
    fold_vc says."""
    widths = WIDTHS[scene]
    p2 = staging_plan("resident", *widths)
    assert p2.staged == ("C", "WT", "inv3") and p2.from_l2 == ()
    assert p2.smem_bytes == staging_plan("fused_reduced", *widths).smem_bytes
    _held(p2, "resident", widths)
    p3 = staging_plan("affine", *widths)
    assert [n for n, _ in p3.operand_bytes] == list(K3)
    assert p3.staged == K3_STAGED[scene]
    assert p3.from_l2 == tuple(n for n in K3 if n not in p3.staged)
    _held(p3, "affine", widths)
    assert staging_plan("affine", *widths, fold_vc=False) == p3


def test_staging_plan_bench_bytes_and_refusals():
    """At the bench widths kernels 1 and 2 keep 94,560 B a block (two
    blocks fit on an SM), kernels 3 and 4 164,288 B and kernel 5 167,520 B
    (one; 512 B of it the interval bound's constants); without fold_vc kernel 5 stages U_selT; a kernel without a
    cluster loop, a block whose own buffers do not fit, or another element
    size, is refused."""
    bench = WIDTHS["bench"]
    assert staging_plan("fused_reduced", *bench).smem_bytes == 94_560
    assert staging_plan("resident", *bench).smem_bytes == 94_560
    assert staging_plan("affine", *bench).smem_bytes == 164_288
    assert staging_plan("affine_chunked", *bench).smem_bytes == 167_520
    assert staging_plan("affine_chunked", *bench,
                        fold_vc=False).staged[-1] == "U_selT"
    with pytest.raises(ValueError, match="buffers"):
        staging_plan("fused_reduced", 64, 9000, 80)
    with pytest.raises(ValueError, match="4-byte"):
        staging_plan("fused_reduced", *bench[:3], itemsize=8)
    with pytest.raises(ValueError, match="no cluster loop"):
        staging_plan("predict_project", *bench[:3])
    d = staging_plan("affine_chunked", *bench).as_dict()
    assert d["cluster"] == [3, 1, 1] and d["threads"] == 256
    assert sum(d["operand_bytes"].values()) == 155_648


def test_warp_runs_give_each_kind_whole_warps():
    """Each segment of the element table starts at a multiple of 32
    threads; every column appears once; the padding is -1."""
    segs = [("tris_strain", 0, 40, 0.9, 1.1), ("edge_spring", 40, 40, None,
                                                None),
            ("verts_bending", 80, 33, None, None)]
    lanes = warp_runs(segs).tolist()
    assert lanes[:40] == list(range(40)) and lanes[40:64] == [-1] * 24
    assert lanes[64:104] == list(range(40, 80))
    assert lanes[128:] == list(range(80, 113))
    assert sorted(c for c in lanes if c >= 0) == list(range(113))
    assert warp_runs([("tets_strain", 0, 93, 0.9, 1.1)]).tolist() == list(
        range(93))


@pytest.fixture(scope="module")
def small():
    """The small cloth of chip_smoke.py on the CPU in float32 (r = 8, 6
    DEIM rows per group)."""
    model = cs.small_scene(DeformableModel, cloth_model)
    s = cs.scene_solver(synthetic_reduced_solver, model, K=6, r=8,
                        damping=0.07, device="cpu", dtype=torch.float32)
    return model, s


def test_fused_args_contract(small):
    """Kernel 1's launch arguments match its C entry point's types: one
    cluster per sim (nb), the projection order, the plan's bits and bytes;
    the operands' type is checked; a CPU tensor never reaches a launch."""
    model, s = small
    fo = s._resident.fused
    assert torch.equal(fo.lane_cols, torch.as_tensor(
        warp_runs(fo.segments)))
    n_sel, r = s._resident.n_sel, fo.r
    g = torch.Generator().manual_seed(0)
    for lead in ((), (3,)):
        snT = torch.randn(lead + (3, n_sel), generator=g)
        rb = torch.randn(lead + (3, r), generator=g)
        u = torch.empty_like(rb)
        args = k1.fused_args(fo, snT, rb, u, 10)
        plan = k1.fused_plan(fo)
        assert len(args) == len(k1._ARGTYPES)
        assert plan == staging_plan("fused_reduced", r, fo.g_total,
                                    fo.m_total)
        assert args[14:19] == (r, fo.g_total, fo.m_total, 10,
                               lead[0] if lead else 1)
        assert args[19].value == fo.lane_cols.data_ptr()
        assert args[20:23] == (fo.lane_cols.numel(), plan.bits,
                               plan.smem_bytes)
        assert args[2] == (snT.stride(0) if lead else 0)
    fo64 = dataclasses.replace(fo, C_allT=fo.C_allT.double())
    with pytest.raises(TypeError, match="float32"):
        k1.fused_args(fo64, snT, rb, u, 10)
    with pytest.raises(ValueError, match="device"):
        k1._launch_fused(fo, snT, rb, 10)


def test_chunk_args_contract(small):
    """Kernel 5's launch arguments match its C entry point's types for
    every build, solo and batched: one cluster per sim (nb), the
    projection order, the plan of the build's fold_vc; the exact-free
    build passes no lift, and only the exact builds with the bound pass
    the interval bound's constants."""
    model, s = small
    ro, ao = s._resident, s._affine
    fo = ao.fused
    P = s._to_device(model.positions)
    V = s._to_device(model.velocities)
    fa = force_term(ro, s._to_device(cs.gravity(model)))
    rb = s._rb_extra()
    for B in (None, 2):
        def sims(x):
            return x if B is None else torch.stack([x] * B).contiguous()

        Pb, Vb, fab = sims(P), sims(V), sims(fa)
        bu0, bu1, b0s, b1s = k5.chunk_anchors(ao, Pb, Vb)
        lead = () if B is None else (B,)
        ymm = torch.zeros(lead + (6,))
        out = torch.empty(lead + (18 + 6 * fo.r,))
        k = torch.zeros(lead, dtype=torch.int32)
        for o in k5.BUILDS:
            args = k5.chunk_args(ao, Pb, Vb, fab, ymm, True, b0s, b1s,
                                 gather_vc(fo, fab), bu0, bu1,
                                 project(ro, fab), rb, 16, 10, 0.0, out, k,
                                 o)
            plan = k5.chunk_plan(ao, o)
            assert plan == staging_plan("affine_chunked", fo.r, fo.g_total,
                                        fo.m_total, ro.n_sel,
                                        fold_vc=o.fold_vc)
            assert len(args) == len(k5._ARGTYPES)
            assert args[35] == (B or 1)
            assert (args[11] is None) == (not o.floor_exact)
            assert (args[12] is None) == (not (o.floor_exact
                                               and o.floor_bound_skip))
            assert args[44].value == fo.lane_cols.data_ptr()
            assert args[45:48] == (fo.lane_cols.numel(), plan.bits,
                                   plan.smem_bytes)
    with pytest.raises(ValueError, match="gathered columns"):
        k5.chunk_args(ao, P, V, fa, torch.zeros(6), True, None, None, None,
                      *k5.chunk_anchors(ao, P, V)[:2], project(ro, fa), rb,
                      16, 10, 0.0, out[0], k[0])


def _h100ish(lib, plan):
    """Clusters resident at once as a card might hold them: one block a SM
    above 114,000 B a block, two above 20,000 B, more below."""
    b = plan.smem_bytes
    return 39 if b > 114_000 else 79 if b > 20_000 else 120


# nb -> how many operands of the staging order the batched plans of
# kernels 3 and 4, and of kernel 2, stage at the bench widths under
# _h100ish: the full plan while one wave holds the sims; then for kernels 3
# and 4 the plan without U_selT (113,088 B, two blocks a SM); past 79 sims
# nothing staged where that saves a wave, and on a tie the plan that
# stages more
CHOICE = {1: (5, 3), 8: (5, 3), 39: (5, 3), 40: (4, 3), 64: (4, 3),
          79: (4, 3), 80: (0, 0), 128: (4, 3), 158: (4, 3), 160: (0, 0)}


@pytest.mark.parametrize("nb", sorted(CHOICE))
def test_batched_plan_choice_as_nb_grows(nb):
    """launch_plan: one sim runs on the full plan without asking the card;
    a batch on the prefix of the staging order that needs the fewest waves
    of clusters, the one that stages more on a tie."""
    bench = WIDTHS["bench"]
    asked = []

    def clusters(lib, plan):
        asked.append(lib)
        return _h100ish(lib, plan)

    k3_most, k2_most = CHOICE[nb]
    plan = launch_plan("affine", "affine", nb, *bench, clusters=clusters)
    assert plan == staging_plan("affine", *bench, most=k3_most)
    assert plan.staged == K3[:k3_most]
    assert (asked == []) == (nb == 1) and set(asked) <= {"affine"}
    k2 = launch_plan("resident", "resident", nb, *bench[:3],
                     clusters=_h100ish)
    assert k2.staged == K3[:k2_most]


def test_batched_plan_skips_plans_the_card_cannot_place():
    """A plan whose cluster the card cannot place (-1) is not chosen; when
    none can be placed the launch raises, with no fallback."""
    bench = WIDTHS["bench"]
    plan = launch_plan("affine", "affine", 8, *bench, clusters=lambda lib, p:
                       -1 if p.smem_bytes > 100_000 else 40)
    assert plan.staged == K3[:3]
    with pytest.raises(RuntimeError, match="no cluster"):
        launch_plan("resident", "resident", 8, *bench[:3],
                    clusters=lambda lib, p: -1)


@pytest.mark.parametrize("B", [None, 2])
def test_resident_args_contract(small, B):
    """Kernel 2's launch arguments match its C entry point's types: one
    cluster per sim in its iteration launch (nb), the projection order,
    the plan's bits and bytes (the full plan for one sim)."""
    model, s = small
    ro = s._resident
    fo = ro.fused
    P = s._to_device(model.positions)
    if B is not None:
        P = torch.stack([P] * B).contiguous()
    V, fa, sn = torch.zeros_like(P), torch.zeros_like(P), torch.empty_like(P)
    lead = P.shape[:-2]
    partial = torch.empty(lead + (3, 3, fo.r), dtype=torch.float64)
    u = torch.empty(lead + (3, fo.r))
    plan = k2.resident_plan(ro, B or 1, clusters=_h100ish)
    args = k2.resident_args(ro, P, V, fa, s._rb_extra(), sn, partial, u, 16,
                            10, plan)
    assert len(args) == len(k2._ARGTYPES)
    assert plan == staging_plan("resident", fo.r, fo.g_total, fo.m_total)
    assert args[18:25] == (ro.n, fo.r, fo.g_total, fo.m_total, 16, 10,
                           B or 1)
    assert args[31].value == fo.lane_cols.data_ptr()
    assert args[32:35] == (fo.lane_cols.numel(), plan.bits,
                           plan.smem_bytes)


@pytest.mark.parametrize("variant, B", [("lean", None), ("lean", 2),
                                        ("contact", None), ("contact", 2),
                                        ("exit", None), ("exit", 2)])
def test_affine_args_contract(small, variant, B):
    """Kernels 3 (lean, contact mode) and 4's launch arguments match their
    C entry point's types, solo and batched: the mode of the variant, one
    cluster per sim (nb), a flag slot per step, the projection order, the
    plan's bits and bytes; contact mode's y state only in contact mode;
    kernel 4's batched wrapper takes (B, 3, N) states only."""
    model, s = small
    ao = s._affine
    ro, fo = ao.res, ao.fused
    P = s._to_device(model.positions)
    if B is not None:
        P = torch.stack([P] * B).contiguous()
    bufs = k3.affine_buffers(ao, P, torch.zeros_like(P), torch.zeros_like(P),
                             16, variant, 128)
    nb = B or 1
    assert bufs["flags"].shape == (nb, k3.FLAG_SLOTS + 16)
    assert bufs["ys"].shape[0] == (nb if variant == "contact" else 0)
    plan = k3.affine_plan(ao, nb, clusters=_h100ish)
    args = k3.affine_args(ao, bufs, s._rb_extra(), 16, 10, 256, variant,
                          plan)
    assert len(args) == len(k3._ARGTYPES)
    assert args[27:41] == (ro.n, fo.r, ro.n_sel, fo.g_total, fo.m_total, 16,
                           10, 256, {"lean": 2, "contact": 3, "exit": 1}[
                               variant], nb, k3.FLAG_SLOTS + 16, ro.dt,
                           ro.eta, ao.floor_level)
    assert args[43].value == fo.lane_cols.data_ptr()
    assert args[44:47] == (fo.lane_cols.numel(), plan.bits,
                           plan.smem_bytes)
    if variant == "exit" and B is None:
        with pytest.raises(ValueError, match="B, 3, N"):
            k3.resident_affine_exit_batched(ao, P, torch.zeros_like(P),
                                            torch.zeros_like(P),
                                            s._rb_extra(), 16, 10)
