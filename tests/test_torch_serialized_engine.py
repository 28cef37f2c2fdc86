"""The phase-serialized engine as a whole: the torch Engine against the
JAX Engine (``mixed=False``) over contiguous and paged lanes, fp and int8
KV, with requests arriving mid-run and prompts both packed into shared
prefill rows and chunked alone; and its tokens against the mixed-step
engine's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

STAT_KEYS = ("steps", "decoded_tokens", "slot_utilization",
             "kv_blocks_visited", "kv_blocks_dense", "kv_bytes_per_token",
             "device_time", "paged", "mixed", "kv_pages_total",
             "kv_memory_ratio")
CASES = [(paged, kv_quant) for paged in (False, True)
         for kv_quant in (False, True)]
# In the 16-token rows, prompts of 9-16 tokens ride alone, <= 8 pair up
# and <= 4 go four to a row; 25 and 18 are chunked alone; budget 1
# finishes at prefill. The first sweep packs 3 rows (padded to 4).
LENGTHS = [5, 3, 25, 2, 12, 10, 7, 4, 18, 6, 3]
BUDGETS = [6, 1, 5, 4, 6, 3, 5, 4, 5, 4, 3]
TICKS = [1, 1, 1, 1, 1, 1, 2, 3, 6, 9, 9]
ENGINE_KW = dict(tp.ENGINE_KW, num_slots=6)


@pytest.fixture(scope="module")
def qwen():
    cfg, m, params = tp.jax_qwen_smoke()
    tm, tparams = tp.torch_qwen_smoke(params)
    return cfg, m, params, tm, tparams


def _requests(req_cls, vocab):
    return [req_cls(rid=i, prompt=p, max_new_tokens=b)
            for i, (p, b) in enumerate(zip(tp.prompts(vocab, LENGTHS),
                                           BUDGETS))]


def _serve(engine, reqs):
    done = engine.run(arrivals=list(zip(TICKS, reqs)))
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    assert all(r.status == "ok" for r in done)
    return {r.rid: list(r.output) for r in done}, engine.decode_stats, \
        engine.stats


_JAX_RUNS = {}


def _jax_run(qwen, paged, kv_quant):
    key = (paged, kv_quant)
    if key not in _JAX_RUNS:
        from repro.serve import Engine, EngineConfig, Request
        cfg, m, params, _, _ = qwen
        if kv_quant:
            m = type(m)(dataclasses.replace(m.cfg, kv_quant=True))
        eng = Engine(m, params, config=EngineConfig(
            mixed=False, paged=paged, prefix_share=False, **ENGINE_KW))
        _JAX_RUNS[key] = _serve(eng, _requests(Request, cfg.vocab_size))
    return _JAX_RUNS[key]


def _torch_engine(qwen, paged, kv_quant, **kw):
    from repro_torch.serve import Engine, EngineConfig
    _, _, _, tm, tparams = qwen
    if kv_quant:
        tm = type(tm)(dataclasses.replace(tm.cfg, kv_quant=True),
                      device="cpu")
    return Engine(tm, tparams, config=EngineConfig(
        paged=paged, prefix_share=False, **kw, **ENGINE_KW))


@pytest.mark.parametrize("decode_attn", ["dense", "tda"])
@pytest.mark.parametrize("paged,kv_quant", CASES)
def test_serialized_engine_matches_jax_engine(qwen, paged, kv_quant,
                                              decode_attn):
    """Same tokens, step / block / byte / device-time counters, TTFT clocks
    and per-sweep packing stats as the reference Engine; ``mixed=None``
    resolves to the serialized engine for contiguous or int8 lanes."""
    from repro_torch.serve import Request
    cfg = qwen[0]
    ref_out, ref_st, ref_stats = _jax_run(qwen, paged, kv_quant)
    mixed = None if (kv_quant or not paged) else False
    eng = _torch_engine(qwen, paged, kv_quant, mixed=mixed,
                        decode_attn=decode_attn)
    out, st, stats = _serve(eng, _requests(Request, cfg.vocab_size))
    assert out == ref_out
    for key in STAT_KEYS:
        assert st[key] == ref_st[key], key
    assert st["mixed_steps"] == 0
    for field in ("clock", "device_tokens", "first_token_clock"):
        assert {r: v[field] for r, v in st["ttft"].items()} == \
            {r: v[field] for r, v in ref_st["ttft"].items()}, field
    assert stats == ref_stats
    assert len(st["step_ms"]["prefill"]) == len(stats)
    # both admission layouts ran: rows shared by several prompts, and
    # chunked prompts alone
    assert max(s["n_requests"] for s in stats) >= 3
    assert max(s["rows"] for s in stats) == 3
    assert sum(s["n_requests"] == 1 and s["rows"] == 1 for s in stats) >= 2
    if paged:
        eng.slots.pool.check_invariants()
        assert eng.slots.pool.pages_in_use() == 0


def test_kv_bytes_follow_int8_lanes(qwen):
    """The port's int8 lanes price a visited token at 2 * Hkv * (D + 4)
    bytes against 2 * Hkv * D * 4 for f32 lanes (the smoke runs at
    float32)."""
    from repro_torch.serve import Request
    cfg = qwen[0]
    fp, q8 = (_serve(_torch_engine(qwen, False, quant),
                     _requests(Request, cfg.vocab_size))[1]
              for quant in (False, True))
    assert fp["kv_blocks_visited"] == q8["kv_blocks_visited"] > 0
    ratio = q8["kv_bytes_per_token"] / fp["kv_bytes_per_token"]
    assert ratio == pytest.approx((cfg.head_dim + 4) / (cfg.head_dim * 4))


@pytest.mark.parametrize("paged", [False, True])
def test_serialized_tokens_equal_mixed_tokens(qwen, paged):
    """At fp the serialized engine (contiguous or paged) emits the mixed
    engine's tokens on the same requests."""
    from repro_torch.serve import Request
    cfg = qwen[0]
    outs = []
    for p, mixed in ((paged, False), (True, True)):
        eng = _torch_engine(qwen, p, False, mixed=mixed)
        outs.append(_serve(eng, _requests(Request, cfg.vocab_size))[0])
    assert outs[0] == outs[1]
