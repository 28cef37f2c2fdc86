"""``models/moe.py::moe_ffn(mesh=)`` on a ``(2, 2)`` mesh of four gloo
ranks on the CPU (expert parallelism over ``data``: two experts a rank and
a tiled ``all_to_all``; the experts' contraction over ``model``) against the
reference's ``moe_ffn`` on a ``(2, 2)`` mesh in one ``mesh_cpu(4)`` child,
dbrx smoke (4 experts, top-2) at float32: dense experts at capacity
factors 1.25 (claims dropped, counted per source shard) and 4.0, and
factorized experts at 4.0 (batched ``(E / 2, r / 2, F)`` ``wd`` leaves
beside dictionaries cut over their rank ``r``:
``core/factorized.py::parallel_linear`` all-reduces each product's
partial sums over the rank, and gathers the down projection's ``d_ff``
slices first).
The same numpy params and tokens go to both sides; each rank of the port
takes its batch block of ``data`` and its slice of the params
(``launch.sharding.shard_params``). Limits: y within 1e-5 x max(1, max
|ref|) (the same f32 products summed in another order across ranks), aux
within 1e-6, and the two ranks of one data block bitwise equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

D_MODEL, F, E, R = 64, 128, 4, 32
CASES = [("dense", 1.25), ("dense", 4.0), ("factorized", 4.0)]


def _case(fmt: str, cf: float) -> dict:
    """Params and tokens from a seed: (4, 6, 64) tokens leaning towards
    expert 0 so that capacity 1.25 binds."""
    rng = np.random.default_rng(7)
    router = (0.02 * rng.standard_normal((D_MODEL, E))).astype(np.float32)
    u = router[:, 0] / np.linalg.norm(router[:, 0])
    x = (rng.standard_normal((4, 6, D_MODEL)) + 4.0 * u).astype(np.float32)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    if fmt == "dense":
        moe = {"router": router, "w_gate": {"w": w(E, D_MODEL, F)},
               "w_up": {"w": w(E, D_MODEL, F)},
               "w_down": {"w": w(E, F, D_MODEL)}}
        dicts = {}
    else:
        moe = {"router": router, "w_gate": {"wd": w(E, R, F)},
               "w_up": {"wd": w(E, R, F)}, "w_down": {"wd": w(E, R, D_MODEL)}}
        dicts = {"moe_gate": w(D_MODEL, R), "moe_up": w(D_MODEL, R),
                 "moe_down": w(F, R)}
    return {"moe": moe, "dicts": dicts, "x": x, "cf": cf}


_REF = """
import dataclasses as dc, pickle, sys
from repro.configs import get_config
from repro.core.factorized import FactorizationConfig
from repro.launch.mesh import make_local_mesh
from repro.models.moe import moe_ffn
cases = pickle.load(open({path!r}, "rb"))
mesh = make_local_mesh(2, 2)
out = []
for c in cases:
    cfg = get_config("dbrx-132b", "smoke", dtype="float32")
    if c["dicts"]:
        cfg = dc.replace(cfg, factorization=FactorizationConfig(**{fcfg!r}))
    cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, capacity_factor=c["cf"]))
    p = jax.tree.map(jnp.asarray, c["moe"])
    d = jax.tree.map(jnp.asarray, c["dicts"])
    y, aux = moe_ffn(p, jnp.asarray(c["x"]), cfg=cfg, dicts=d, mesh=mesh)
    out.append([np.asarray(y).tolist(), float(aux)])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, every rank's outputs) of every case."""
    import pickle
    from repro_torch.launch.mesh import run_ranks
    cases = [_case(*c) for c in CASES]
    path = tmp_path_factory.mktemp("moe") / "cases.pkl"
    path.write_bytes(pickle.dumps(cases))
    port = run_ranks(4, tp.rank_moe, cases, device="cpu", backend="gloo")
    return path, port


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{f}-cf{c}" for f, c in CASES])
def test_moe_ffn_sharded_matches_reference(i, runs, mesh_cpu):
    path, port = runs
    ref = _ref(path, mesh_cpu)
    y_ref, aux_ref = np.asarray(ref[i][0], np.float32), ref[i][1]
    blocks = {}
    for rank in port:
        d, y, aux, _ = rank[i]
        if d in blocks:
            assert np.array_equal(blocks[d][0], y)
        blocks[d] = (y, aux)
    y = np.concatenate([blocks[d][0] for d in sorted(blocks)], 0)
    tol = 1e-5 * max(1.0, float(np.abs(y_ref).max()))
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=tol)
    for d in blocks:
        assert abs(blocks[d][1] - aux_ref) <= 1e-6


_REF_OUT: dict = {}


def _ref(path, mesh_cpu):
    """The reference's outputs of every case, from one child."""
    if "out" not in _REF_OUT:
        _REF_OUT["out"] = mesh_cpu(4, _REF.format(path=str(path),
                                                  fcfg=tp.MOE_FCFG))
    return _REF_OUT["out"]


def test_moe_ffn_sharded_drops_claims(runs):
    """Capacity 1.25 binds (claims dropped, on every rank's source shard)
    and 4.0 does not, by the port's own ``router_counts`` on each rank."""
    _, port = runs
    for rank in port:
        drops = [rank[i][3]["dropped"] for i in range(len(CASES))]
        assert [d > 0 for d in drops] == [cf < 4 for _, cf in CASES]
