"""The port's Engine on a ``(1, N)`` mesh of gloo ranks on the CPU
(``launch.mesh.run_ranks`` running ``launch.tp_serve.serve_rank``) against
the reference Engine with ``mesh=None``, at float32 with the reference's
params bridged over: tokens and statuses of every request equal, and every
rank's outputs equal to every other rank's (the reference's contract:
sharding is a placement, never a change of semantics). One spawn serves
every scenario of a rank count:

* N = 2: qwen1.5-4b (MHA, QKV bias), GQA qwen2.5, starcoder2's ring lanes
  (prompts past the window of 32), seeded sampling, the phase-serialized
  engine over int8 contiguous lanes, factorized and compressed qwen2.5
  (compressed streams replicated, DMM/SMM's plain versions on every rank)
  and dbrx smoke at the published capacity factor 1.25;
* N = 4: qwen1.5-4b (one kv head a rank), seeded sampling, and prefix
  sharing with copy-on-write plus forced preemptions under ``audit=True``
  (the pool audited in every rank's view at every step).

N = 1 (a mesh of one rank: no process group) runs in this process. Host
counters are held to the reference's where the scenario is about them
(sharing, preemption), and ``kv_bytes_per_token_per_rank`` to ``1 / N``
of ``kv_bytes_per_token``. The refusals (indivisible heads, a fleet on a
mesh, compressed MoE on a mesh, ``data > 1``) raise at construction. The
``gpu`` twin serves qwen2.5 smoke on two ranks sharing the card through
gloo against the same card's unsharded run."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

KW = dict(tp.ENGINE_KW)
FCFG = tp.MOE_FCFG
_PAIRS: dict = {}


def _pair(name: str):
    """(reference Model, its params, port ModelConfig, bridged params) of
    scenario ``name``'s model, made once per process."""
    import jax
    from repro.configs import get_config as jget
    from repro.core import factorized as rf
    from repro.models.transformer import Model as JM
    from repro_torch.configs import get_config as tget
    from repro_torch.core import factorized as tf
    from repro_torch.models.bridge import params_from_numpy
    arch, fmt, over = {
        "qwen1.5": ("qwen1.5-4b", "dense", {}),
        "qwen2.5": ("qwen2.5-32b", "dense", {}),
        "starcoder2": ("starcoder2-15b", "dense", {}),
        "int8": ("qwen2.5-32b", "dense", {"kv_quant": True}),
        "factorized": ("qwen2.5-32b", "factorized", {}),
        "compressed": ("qwen2.5-32b", "compressed", {}),
    }.get(name, (name, "dense", {}))
    if name == "dbrx-132b":
        jm, jp, tm, tparams = tp.moe_pair(name)
        return jm, jp, tm.cfg, tparams
    if name in _PAIRS:
        return _PAIRS[name]
    jo, to = dict(over), dict(over)
    if fmt != "dense":
        jo["factorization"] = rf.FactorizationConfig(**FCFG)
        to["factorization"] = tf.FactorizationConfig(**FCFG)
    jcfg = jget(arch, "smoke", dtype="float32", **jo)
    tcfg = tget(arch, "smoke", dtype="float32", **to)
    jm = JM(jcfg)
    jp = jm.init(jax.random.key(0))
    if fmt == "compressed":
        jm, jp, _ = jm.compress_params(rf.project_wd_leaves(
            jp, jcfg.factorization))
        tcfg = dataclasses.replace(tcfg, weight_format="compressed")
    _PAIRS[name] = (jm, jp, tcfg, params_from_numpy(
        tp.to_numpy_tree(jp), tp.CPU))
    return _PAIRS[name]


LENGTHS, BUDGETS = tp.LENGTHS, tp.BUDGETS
SHARED_PREFIX = 12


def _shared_rounds():
    """Prompts behind one 12-token prefix (the reference's own sharded
    preemption test's workload), on two slots: a 16-token prompt A and a
    one-token request up front, an exact duplicate of A at tick 2 (it maps
    A's pages while A decodes and recomputes its last token inside a shared
    page: copy-on-write), four more at tick 4 (the pool preempts)."""
    rng = np.random.default_rng(5)
    common = rng.integers(0, 256, size=SHARED_PREFIX).astype(np.int32)
    p = [np.concatenate([common, rng.integers(0, 256, size=3 + i).astype(
        np.int32)]) for i in range(6)]
    return [[(0, 0, p[1], 6), (0, 1, p[0], 1), (2, 2, p[1].copy(), 6)]
            + [(4, 3 + j, p[2 + j], 6) for j in range(4)]]


def _scenarios():
    """name -> (model key, rounds, EngineConfig kwargs, FaultPlan kwargs or
    None, rank counts)."""
    base = tp.tp_rounds(LENGTHS, BUDGETS)
    ring = tp.tp_rounds([33, 45, 12, 38], [12, 10, 12, 8])
    sampled = dict(KW, temperature=0.8, top_k=8, seed=7)
    shared = dict(max_len=24, max_new_tokens=6, num_slots=2, page_size=4,
                  pool_frac=0.55, prefix_share=True, audit=True)
    return {
        "qwen1.5": ("qwen1.5", base, KW, None, (2, 4)),
        "gqa": ("qwen2.5", base, KW, None, (2,)),
        "ring": ("starcoder2", ring, dict(KW, max_new_tokens=12,
                                          max_prompt_len=48, page_size=8),
                 None, (2,)),
        "sampled": ("qwen1.5", base, sampled, None, (2, 4)),
        "serialized_int8": ("int8", base, dict(KW, mixed=False, paged=False),
                            None, (2,)),
        "factorized": ("factorized", base, KW, None, (2,)),
        "compressed": ("compressed", base, dict(KW, prefix_share=False),
                       None, (2,)),
        "dbrx": ("dbrx-132b", base, KW, None, (2,)),
        "shared_preempt_audit": ("qwen1.5", _shared_rounds(), shared,
                                 dict(seed=0, preempt_at=(3, 7)), (4,)),
    }


_RUNS: dict = {}


def _ranks(n: int):
    """{scenario: [each rank's result]} of rank count ``n``, from one
    spawn (N = 1: in this process)."""
    if n in _RUNS:
        return _RUNS[n]
    from repro_torch.launch.mesh import make_local_mesh, run_ranks
    from repro_torch.launch.tp_serve import serve_rank, serve_scenario
    from repro_torch.serve import FaultPlan
    names = ["qwen1.5"] if n == 1 else [
        k for k, s in _scenarios().items() if n in s[4]]
    scs = []
    for name in names:
        key, rounds, kw, faults, _ = _scenarios()[name]
        scs.append(dict(cfg=_pair(key)[2], params=_pair(key)[3], engine=kw,
                        rounds=rounds, device="cpu",
                        faults=FaultPlan(**faults) if faults else None))
    if n == 1:
        res = [[serve_scenario(sc, make_local_mesh(1, 1, device="cpu"))
                for sc in scs]]
    else:
        res = run_ranks(n, serve_rank, (1, n), scs, device="cpu",
                        backend="gloo")
    _RUNS[n] = {name: [r[i] for r in res] for i, name in enumerate(names)}
    return _RUNS[n]


_REF: dict = {}


def _ref(name: str):
    if name not in _REF:
        from repro.serve import FaultPlan
        key, rounds, kw, faults, _ = _scenarios()[name]
        jm, jp = _pair(key)[:2]
        _REF[name] = tp.ref_serve(jm, jp, rounds,
                                  faults=FaultPlan(**faults) if faults
                                  else None, **kw)
    return _REF[name]


CASES = [(name, n) for name, s in _scenarios().items() for n in s[4]] \
    + [("qwen1.5", 1)]


@pytest.mark.parametrize("name,n", CASES,
                         ids=[f"{a}-n{b}" for a, b in CASES])
def test_tp_engine_matches_reference(name, n):
    """Tokens and statuses equal to the reference Engine with
    ``mesh=None``; every rank's outputs equal; ``tp_ranks`` is N and each
    rank's K/V bytes per token are 1 / N of the whole."""
    want, wst = _ref(name)
    runs = _ranks(n)[name]
    for r in runs:
        assert r["out"] == runs[0]["out"]
        assert _untimed(r["stats"]) == _untimed(runs[0]["stats"])
    got = {rid: tuple(v) for rid, v in runs[0]["out"].items()}
    assert got == {rid: tuple(v) for rid, v in want.items()}
    st = runs[0]["stats"]
    assert st["tp_ranks"] == n
    assert st["kv_bytes_per_token_per_rank"] == pytest.approx(
        st["kv_bytes_per_token"] / n, rel=1e-12)
    assert st["kv_bytes_per_token"] == pytest.approx(
        wst["kv_bytes_per_token"], rel=1e-12)
    if name == "shared_preempt_audit":
        for k in tp.SHARE_STATS:
            assert st[k] == wst[k], k
        assert st["audit_violations"] == 0
        assert st["preemptions"] > 0 and st["pages_shared"] > 0
        assert st["prefix_hit_ratio"] > 0
        assert runs[0]["pages_copied"] > 0


def _untimed(st):
    return {k: v for k, v in st.items() if k not in ("step_ms", "ttft")}


@pytest.mark.parametrize("what", ["indivisible_heads", "fleet",
                                  "compressed_moe", "data_axis"])
def test_tp_refusals(what):
    """The reference's refusals at construction: kv_heads = 2 on a 4-way
    model axis (the message names the counts), a fleet index on a mesh,
    compressed MoE experts on two ranks, and a data axis above 1."""
    from repro_torch.configs import get_config
    from repro_torch.core.errors import UnsupportedConfigError
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve.pages import FleetPrefixIndex

    def mesh(d, m):
        return Mesh({"data": d, "model": m}, {"data": 0, "model": 0}, {},
                    torch.device("cpu"))

    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    kw = {}
    if what == "indivisible_heads":
        kw, match = {"mesh": mesh(1, 4)}, "4-way.*kv_heads=2"
    elif what == "fleet":
        eng = Engine(Model(cfg, device="cpu"), None,
                     config=EngineConfig(max_len=16), mesh=mesh(1, 2))
        with pytest.raises(UnsupportedConfigError, match="single-rank"):
            eng.attach_fleet(FleetPrefixIndex())
        return
    elif what == "compressed_moe":
        cfg = get_config("dbrx-132b", "smoke", dtype="float32",
                         weight_format="compressed")
        kw, match = {"mesh": mesh(1, 2)}, "compressed MoE"
    else:
        kw, match = {"mesh": mesh(2, 1)}, "data=2"
    with pytest.raises(UnsupportedConfigError, match=match):
        Engine(Model(cfg, device="cpu"), None,
               config=EngineConfig(max_len=16), **kw)


def test_tp_audit_compares_ranks():
    """On a mesh the audit checks each rank's own view of the pool once,
    naming the rank, and compares the ranks' host state by one all-reduce
    of a digest: a free list reversed on rank 1 alone (its own checks
    pass) raises ``rank-drift`` on both ranks; a refcount broken on rank 1
    raises its own check there and ``rank-failed`` on rank 0, so no rank
    goes on alone."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.transformer import Model
    cfg = get_config("qwen1.5-4b", "smoke", dtype="float32")
    params = Model(cfg, device="cpu").init(seed=0)
    (a0, v0), (a1, v1) = run_ranks(2, tp.rank_audit_ranks, cfg, params,
                                   device="cpu", backend="gloo")
    assert a0[0] is None and a1[0] is None
    assert a0[1][0] == a1[1][0] == "rank-drift"
    assert a0[2][0] == "rank-failed" and "[rank 0/2 view]" in a0[2][1]
    assert a1[2][0] == "refcount-drift" and "[rank 1/2 view]" in a1[2][1]
    assert v0 == v1 == 2


@pytest.mark.gpu
def test_cuda_tp_serve_matches_unsharded():
    """On the card: qwen2.5 smoke at float32 (TF32 off) served by two ranks
    sharing it through gloo gives the tokens, statuses and host counters of
    the same card's unsharded Engine under audits (the ranks' digests
    all-reduced on the card every step), and each rank launched the paged
    decode and mixed kernels on its heads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ranks serve on the card")
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.tp_serve import serve_rank, serve_scenario
    from repro_torch.models.transformer import Model
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    sc = dict(cfg=cfg, params=Model(cfg, device="cpu").init(seed=0),
              engine=dict(KW, audit=True),
              rounds=tp.tp_rounds(LENGTHS, BUDGETS))
    base = serve_scenario(dict(sc, device="cuda"), None)
    runs = run_ranks(2, serve_rank, (1, 2), [sc], backend="gloo")
    for r in runs:
        assert r[0]["out"] == base["out"]
        for k in tp.SHARE_STATS:
            assert r[0]["stats"][k] == base["stats"][k], k
        assert r[0]["launches"]["tda_paged_decode_attention"] > 0
        assert r[0]["launches"]["tda_mixed_attention"] > 0
