"""Kernels 1 and 5 of one source tree on fixed inputs, saved for a bit for
bit comparison with another tree's: a redesign that keeps the arithmetic's
order gives the same bits.

    python3 tools/same_outputs.py <tree> <file.pt>
    python3 tools/same_outputs.py --compare <a.pt> <b.pt>

The inputs, from the bench scene of ``chip_smoke.py`` at rest under
gravity: kernel 1 (10 iterations) solo and on 8 jittered sims; kernel 5
over 64 steps in four builds (the default, exact-free, ``fold_vc`` off,
the bound off), over 300 steps with a rebase every 16, on the contact scene
(tier 1 exits) and batched on 4 sims, each with its steps done.  To compare
with the parent commit in one call on the card::

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
    from animsnapbases_tpu_torch.ops.resident import force_term, predict

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
    torch.save({k: v.cpu() for k, v in out.items()}, path)
    print(f"{tree}: {len(out)} outputs saved to {path}", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    sys.exit(outputs(sys.argv[1], sys.argv[2]))
