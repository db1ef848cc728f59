"""What the benchmark builds from a configuration is the same, bit for bit,
as it was before constraint and scene kinds became files of their own: at
test sizes, sha256 fingerprints of the parts that no LAPACK routine of the
bases maker decides (each scene's arrays and pins, each group's S^T, block
and rest data, and the cost counts on seeded bases), and a float64
reference rollout on seeded random bases.  The constants were taken with
the same functions on the commit before that change."""

import hashlib
import json

import numpy as np
import pytest

from portbench import core
from portbench.reference.reduced import ReducedReference
from portbench.reference.scene import build_scene
from portbench.tests.tiny import tiny_root

CONFIGS = ("cloth120_strain_spring", "bar40x5x5_defgrad")


def _update(h, x):
    if isinstance(x, np.ndarray):
        h.update(f"{x.dtype.str}{x.shape}".encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif hasattr(x, "tocsr"):
        x = x.tocsr()
        h.update(repr(x.shape).encode())
        for a in (x.data, x.indices, x.indptr):
            _update(h, a)
    else:
        h.update(repr(x).encode())


def digest(*parts) -> str:
    h = hashlib.sha256()
    for x in parts:
        _update(h, x)
    return h.hexdigest()


def random_bases(scene, cfg, out, seed=5):
    """Seeded bases files of every group and of the positions, in the
    maker's layout, for ``modes`` of 4/3 x the served modes a group."""
    rng = np.random.default_rng(seed)
    served = cfg["served"]
    for name, g in scene.groups.items():
        k = int(round(int(served["modes"]) * float(served["oversample"])))
        comps = rng.standard_normal((k, g.num * g.p, 3))
        Pt = rng.choice(g.num * g.p, size=k, replace=False)
        gdir = out / "bases" / name
        gdir.mkdir(parents=True)
        np.savez(gdir / "basis.npz", components=comps,
                 interpol_alphas=Pt // g.p, Pt=Pt,
                 interpol_verts=np.empty(0, dtype=np.int64),
                 interpol_alpha_ranges=np.arange(1, k + 1))
    r = int(served["position_modes"])
    pos = np.linalg.qr(rng.standard_normal((3, scene.n, r)))[0]
    np.savez(out / "pos_basis.npz", components=pos.transpose(2, 1, 0))
    return {"dir": str(out / "bases"), "pos": str(out / "pos_basis.npz")}


def fingerprints(root, out) -> dict:
    fp = {}
    for name in CONFIGS:
        cfg = json.loads((root / "portbench/configs" / f"{name}.json")
                         .read_text())
        scene = build_scene(cfg, root)
        fp[name + ".scene"] = digest(scene.positions, scene.faces,
                                     scene.tets, scene.mass, scene.floor)
        fp[name + ".pins"] = digest(scene.pinned)
        for g, grp in scene.groups.items():
            fp[f"{name}.{g}.ST"] = digest(grp.p, grp.num, grp.ST)
            fp[f"{name}.{g}.block"] = digest(grp.block)
            fp[f"{name}.{g}.data"] = digest(
                *[(k, grp.data[k]) for k in sorted(grp.data)])
        made = random_bases(scene, cfg, out / name)
        fp[name + ".cost_shape"] = digest(json.dumps(
            core.cost_shape(scene, cfg, made), sort_keys=True))
    return fp


def rollout(root, out, name) -> dict:
    cfg = json.loads((root / "portbench/configs" / f"{name}.json")
                     .read_text())
    scene = build_scene(cfg, root)
    made = random_bases(scene, cfg, out / name)
    rng = np.random.default_rng(11)
    V0 = 0.05 * rng.standard_normal(scene.positions.shape)
    V0[scene.pinned] = 0.0
    F = np.zeros_like(V0)
    F[:, 1] = -9.81 * scene.mass
    ref = ReducedReference(scene, cfg, made["dir"], made["pos"]).rollout(
        scene.positions[None], V0[None], F[None], 6)
    free = np.flatnonzero(~scene.pinned)
    pick = free[np.linspace(0, len(free) - 1, 6).astype(int)]
    return {"P": ref["P"][0][pick].tolist(), "V": ref["V"][0][pick].tolist(),
            "P_sq": float((ref["P"] ** 2).sum()),
            "V_sq": float((ref["V"] ** 2).sum()),
            "disp": float(ref["disp"][0]), "speed": float(ref["speed"][0])}


PARENT = {
    'cloth120_strain_spring.scene':
        '071ea47b41335557c6e81c6628613ba92f8c30018f162c401ab77d92aa550e7b',
    'cloth120_strain_spring.pins':
        '8e399f51fc0d2439ec4908cf242b785cad85a8a116f8700d4be7bec0218fd122',
    'cloth120_strain_spring.tris_strain.ST':
        'c7bec9de263f1d49d3503a9d65ec0e09a00381d7e0203dcbc0658e31d4c47698',
    'cloth120_strain_spring.tris_strain.block':
        'df0f80f906bf28e3d8cbe71c8d1c37e390fd2b405c355f3930980ce14c2372ff',
    'cloth120_strain_spring.tris_strain.data':
        '783eb2e048357fff67ea4ca67270a6c47891378a9674a15bada4174b5f413ab9',
    'cloth120_strain_spring.edge_spring.ST':
        'dfe06994428ee6379c4741ea137c7e12e07b6bf08acecff2c3636460d7a116af',
    'cloth120_strain_spring.edge_spring.block':
        'a307987c432508bee7aa0102b8271c40c620c45dffd6b9ee876fb668f7ab5f59',
    'cloth120_strain_spring.edge_spring.data':
        'a2c5ebb66c3e0229178bf5a2d416f121f0f972da3c94b80a08aa5791cd6dfa1a',
    'cloth120_strain_spring.cost_shape':
        'ae44f3ee2a4df03b99d4d8e65afc569231a6790d4cc5ad0a1374dbd065a2a1a8',
    'bar40x5x5_defgrad.scene':
        '61b45ada34e1c76acbca782997fe4e180933e7046f2f97668ec741fb0943727f',
    'bar40x5x5_defgrad.pins':
        '57f60dae41ffedc24d64565dcfa2c2cef9c5e2bef8b307c423e8e56fac1703e6',
    'bar40x5x5_defgrad.tets_deformation_gradient.ST':
        '64873c568bbb362f65af9510e22841467dd433eb40d0e60325c58993203c909e',
    'bar40x5x5_defgrad.tets_deformation_gradient.block':
        'c6a9bb1461d0fb3d93e47aff985b15480bf2bf5d54fca1f70fabb222e8a4c1b9',
    'bar40x5x5_defgrad.tets_deformation_gradient.data':
        'e136fca0ce0495f91ca6ea37b49badfae52c986916a5c6ad89d2977fd553accb',
    'bar40x5x5_defgrad.cost_shape':
        '4978915924cdeaa29c89d39f141a5a3ae7750f8016b7a670a4b87fef964dc8ef',
}
PARENT_ROLLOUT = {
    'cloth120_strain_spring': {
        'P': [
            [-0.9531387773363533, 19.044357784012607, -0.04092350354596818],
            [-0.7331083344136343, 20.527203845875075, -0.03430748542033163],
            [-0.3679309021998639, 20.578629620422717, -0.015585239469734934],
            [0.13877789401457727, 20.434967461196695, 0.0023501945452393622],
            [0.5002601773111451, 20.46518340966212, 0.036781329502041146],
            [0.962581303342978, 20.58773681128215, 0.04932981191530596],
        ],
        'V': [
            [-0.34030551913180607, -1.836711874628083, 0.008213623431130041],
            [-0.14248233292076667, -0.34025747202748313, 0.02091715702208334],
            [0.44256620208314723, -0.623267939426686, -0.029398550648368407],
            [0.05631202610765877, -0.6256825659713972, 0.022433617294218486],
            [0.6658316045684565, -0.3329860109428928, 0.08780729513365673],
            [0.39514841179186244, -1.4337552562779798, 0.04029556492310231],
        ],
        'P_sq': 39965.44934222143,
        'V_sq': 105.62472982214055,
        'disp': 0.24437094441608664,
        'speed': 6.204106286465727,
    },
    'bar40x5x5_defgrad': {
        'P': [
            [-0.36287067184195826, 6.440100023694543, -0.499814964980279],
            [-0.2113947805120931, 6.438776686320725, -0.35547447273142924],
            [-0.06171955245863395, 6.581577224079029, -0.5027558210124006],
            [0.07428847941677318, 6.586133107270907, -0.35844535358967816],
            [0.21119761070913337, 6.729500991894868, -0.4903551875781916],
            [0.3561956466142223, 6.730270444558263, -0.21288890571844366],
        ],
        'V': [
            [-0.05966826043452694, -1.0163398526935041, 0.001995717642776229],
            [0.030095558165110434, -1.0301394547653775, 0.017398393146884905],
            [0.10110461026977338, -1.030779844073293, -0.02867698743062863],
            [0.029776785671927278, -0.9832735292581996, -0.013596179559444838],
            [-0.032159632352840584, -0.9779583122322966, 0.10042175184040228],
            [-0.009862992322501318, -0.9699460489212552, 0.014545357777100837],
        ],
        'P_sq': 3157.5297778221548,
        'V_sq': 49.412597778969456,
        'disp': 0.06299388973206987,
        'speed': 1.0485277202206267,
    },
}


def test_scenes_groups_and_costs_are_the_parents(tmp_path):
    root = tiny_root(tmp_path / "root")
    assert fingerprints(root, tmp_path / "bases") == PARENT


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_rollout_is_the_parents(tmp_path, name):
    root = tiny_root(tmp_path / "root")
    got, want = rollout(root, tmp_path / "bases", name), PARENT_ROLLOUT[name]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
