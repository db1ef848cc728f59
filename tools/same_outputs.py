"""Kernels 1-5 of one source tree on fixed inputs, saved for a bit for bit
comparison with another tree's: a redesign that keeps the arithmetic's
order gives the same bits.

    python3 tools/same_outputs.py <tree> <file.pt>
    python3 tools/same_outputs.py --compare <a.pt> <b.pt>

The inputs, from the bench scene of ``chip_smoke.py`` at rest under
gravity: kernel 1 (10 iterations) solo and on 8 jittered sims; kernel 5
over 64 steps in four builds (the default, exact-free, ``fold_vc`` off,
the bound off), over 300 steps with a rebase every 16, on the contact scene
(tier 1 exits) and batched on 4 sims, each with its steps done; over 64
steps, kernel 2 and kernel 3 in both builds on the contact scene (kernel
3 with a rebase every 16 steps and every 256, so that contact mode is
entered, carried and left), kernel 4 on free steps (the rest state moving
at 0.05 sin(x) in y, no force: the tier-1 window's kind) and on the
contact scene (it stops), each with its steps done; the batched kernel 3
in both builds on the first 8 sims of the crumpling ensemble and on a
ring-down ensemble of 8 from the free state, kernel 2 on the 8 crumpling
sims.  To compare with the parent commit in one call on the card::

    git archive <parent> | tar -x -C build/parent
    python3 tools/same_outputs.py build/parent build/outputs_parent.pt
    python3 tools/same_outputs.py . build/outputs_this.pt
    python3 tools/same_outputs.py --compare build/outputs_parent.pt \\
        build/outputs_this.pt
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def compare(a_path, b_path):
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    for k in a:
        print(f"{k}: " + ("bit for bit equal" if k not in differ else
                          "differs, max abs "
                          f"{float((a[k].double() - b[k].double()).abs().max()):.3e}"))
    print(f"every output equal bit for bit: {not differ}", flush=True)
    return 1 if differ else 0


def outputs(tree, path):
    sys.path[0] = tree
    import numpy as np
    import torch

    from animsnapbases_tpu_torch.device import resolve_device
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        ChunkOptions,
        affine_chunked,
        affine_chunked_batched,
    )
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
        fused_reduced_iterations_batched,
    )
    from animsnapbases_tpu_torch.ops.affine import (
        resident_affine,
        resident_affine_batched,
        resident_affine_contact,
        resident_affine_contact_batched,
        resident_affine_exit,
    )
    from animsnapbases_tpu_torch.ops.resident import (
        force_term,
        predict,
        resident_multistep,
        resident_multistep_batched,
    )

    dev = resolve_device("cuda")
    model, s = cs.bench_solver(torch, dev)
    ro, ao = s._resident, s._affine
    fo = ro.fused
    f = cs.gravity(model)
    P, V, Fx = (s._to_device(x) for x in (model.positions, model.velocities,
                                          f))
    rb = s._rb_extra()
    sn, rbc = predict(ro, P, V, force_term(ro, Fx), rb)
    snT = sn[:, :ro.n_sel]
    out = {"kernel 1": fused_reduced_iterations(fo, snT, rbc, 10)}
    g = torch.Generator().manual_seed(0)
    jit = 1e-3 * torch.randn(8, 1, 1, generator=g).to(dev)
    out["kernel 1, 8 sims"] = fused_reduced_iterations_batched(
        fo, (snT[None] * (1 + jit)).contiguous(),
        (rbc[None] * (1 + jit)).contiguous(), 10)

    def k5(key, *a, **kw):
        Pk, Vk, k = affine_chunked(ao, *a, **kw)
        out[key] = torch.stack([Pk, Vk])
        out[key + ", steps done"] = torch.tensor(k)

    for key, o in (("default", ChunkOptions()),
                   ("exact-free", ChunkOptions(floor_exact=False)),
                   ("fold_vc off", ChunkOptions(fold_vc=False)),
                   ("bound off", ChunkOptions(floor_bound_skip=False))):
        k5(f"kernel 5 {key}", P, V, Fx, rb, 64, 10, options=o)
    k5("kernel 5, 300 steps, rebase every 16", P, V, Fx, rb, 300, 10,
       rebase_every=16)
    Pc, Vc = (s._to_device(x) for x in cs.contact_state(model))
    k5("kernel 5, contact scene", Pc, Vc, Fx, rb, 64, 10, rebase_every=16)
    Pb = torch.stack([P] * 4).contiguous()
    Vb = torch.stack([(1 + 0.01 * b) * V for b in range(4)]).contiguous()
    Pk, Vk, _ = affine_chunked_batched(ao, Pb, Vb, torch.stack(
        [Fx] * 4).contiguous(), rb, 64, 10)
    out["kernel 5, 4 sims"] = torch.stack([Pk, Vk])

    def run(key, fn, *a, **kw):
        o = fn(*a, **kw)
        out[key] = torch.stack([o[0], o[1]])
        if len(o) > 2:
            out[key + ", steps done"] = torch.tensor(o[2])

    steps = cs.SCENE_STEPS
    run("kernel 2, contact scene", resident_multistep, ro, Pc, Vc, Fx, rb,
        steps, 10)
    for every in (16, 256):
        run(f"kernel 3 lean, contact scene, rebase every {every}",
            resident_affine, ao, Pc, Vc, Fx, rb, steps, 10, every)
        run(f"kernel 3 contact mode, contact scene, rebase every {every}",
            resident_affine_contact, ao, Pc, Vc, Fx, rb, steps, 10, every)
    v = np.zeros_like(model.positions)
    v[:, 1] = 0.05 * np.sin(np.linspace(0, 6.28, len(v)))
    Vf, F0 = s._to_device(v), torch.zeros_like(P)
    run("kernel 3 lean, free steps", resident_affine, ao, P, Vf, F0, rb,
        steps, 10)
    run("kernel 3 contact mode, free steps", resident_affine_contact, ao, P,
        Vf, F0, rb, steps, 10)
    run("kernel 4, free steps", resident_affine_exit, ao, P, Vf, F0, rb,
        steps, 10)
    run("kernel 4, contact scene", resident_affine_exit, ao, Pc, Vc, Fx, rb,
        steps, 10)
    B = 8
    crumple = [s._pack(x[:B]) for x in cs.crumple_state(model, f)]
    ring = [s._pack(x) for x in cs.ensemble_state((model.positions, v), B)]
    for name, batch in (("crumpling", crumple), ("ring-down", ring)):
        run(f"kernel 3 lean, {B} {name} sims", resident_affine_batched, ao,
            *batch, rb, steps, 10)
        run(f"kernel 3 contact mode, {B} {name} sims",
            resident_affine_contact_batched, ao, *batch, rb, steps, 10)
    run(f"kernel 2, {B} crumpling sims", resident_multistep_batched, ro,
        *crumple, rb, steps, 10)
    torch.save({k: v.cpu() for k, v in out.items()}, path)
    print(f"{tree}: {len(out)} outputs saved to {path}", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    sys.exit(outputs(sys.argv[1], sys.argv[2]))
