"""The port's serving slice as a whole: the torch Engine against the JAX
Engine on the mixed-step workload of ``tests/test_mixed_step.py``, the
import boundary of the port, the device rule, and every refused setting."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

STAT_KEYS = ("steps", "mixed_steps", "decoded_tokens",
             "prefill_chunk_tokens", "kv_blocks_visited", "kv_blocks_dense",
             "slot_utilization")


@pytest.fixture(scope="module")
def qwen():
    cfg, m, params = tp.jax_qwen_smoke()
    tm, tparams = tp.torch_qwen_smoke(params)
    return cfg, m, params, tm, tparams


def _requests(req_cls, vocab):
    return [req_cls(rid=i, prompt=p, max_new_tokens=b)
            for i, (p, b) in enumerate(zip(tp.prompts(vocab, tp.LENGTHS),
                                           tp.BUDGETS))]


def _serve(engine, reqs):
    done = engine.run(arrivals=list(zip(tp.TICKS, reqs)))
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    assert all(r.status == "ok" for r in done)
    return {r.rid: list(r.output) for r in done}, engine.decode_stats


_JAX_RUNS = {}


def _jax_run(qwen, budget):
    if budget not in _JAX_RUNS:
        from repro.serve import Engine, EngineConfig, Request
        cfg, m, params, _, _ = qwen
        eng = Engine(m, params, config=EngineConfig(
            mixed=True, prefill_budget=budget, prefix_share=False,
            **tp.ENGINE_KW))
        _JAX_RUNS[budget] = _serve(eng, _requests(Request, cfg.vocab_size))
    return _JAX_RUNS[budget]


@pytest.mark.parametrize("decode_attn", ["dense", "tda"])
@pytest.mark.parametrize("prefill_budget", [4, 16, None])
def test_engine_matches_jax_engine(qwen, prefill_budget, decode_attn):
    """Same tokens and the same step / block / utilization counters as the
    reference Engine, with requests arriving mid-decode, on the dense path
    and on the TDA path (the kernels' plain versions on the CPU)."""
    from repro_torch.serve import Engine, EngineConfig, Request
    cfg, _, _, tm, tparams = qwen
    ref_out, ref_st = _jax_run(qwen, prefill_budget)
    eng = Engine(tm, tparams, config=EngineConfig(
        mixed=True, prefill_budget=prefill_budget, prefix_share=False,
        decode_attn=decode_attn, **tp.ENGINE_KW))
    out, st = _serve(eng, _requests(Request, cfg.vocab_size))
    assert out == ref_out
    for key in STAT_KEYS:
        assert st[key] == ref_st[key], key
    assert st["prefill_chunk_tokens"] == sum(tp.LENGTHS)
    assert sorted(st["ttft"]) == sorted(ref_st["ttft"])
    assert {r: v["clock"] for r, v in st["ttft"].items()} == \
        {r: v["clock"] for r, v in ref_st["ttft"].items()}
    eng.slots.pool.check_invariants()
    assert eng.slots.pool.pages_in_use() == 0


def test_engine_fragmented_pool_same_tokens(qwen):
    """Physical page order is irrelevant: a scrambled free list serves the
    same tokens."""
    from repro_torch.serve import Engine, EngineConfig, Request
    cfg, _, _, tm, tparams = qwen
    eng = Engine(tm, tparams, config=EngineConfig(
        prefill_budget=16, prefix_share=False, **tp.ENGINE_KW))
    eng.slots.pool.shuffle_free(np.random.default_rng(3))
    out, _ = _serve(eng, _requests(Request, cfg.vocab_size))
    assert out == _jax_run(qwen, 16)[0]


def test_port_imports_no_jax_or_reference():
    """The port and its launcher import neither ``jax`` nor ``repro``."""
    code = ("import sys\n"
            "import repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.models.bridge, repro_torch.kernels.build, "
            "repro_torch.core.compression, repro_torch.core.sparsity, "
            "repro_torch.kernels.dmm.ops, repro_torch.kernels.smm.ops, "
            "repro_torch.launch.profile_serve, repro_torch.core.packing, "
            "repro_torch.serve.kv_slots, repro_torch.serve.scheduler\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_entry_points_need_cuda_unless_cpu_is_asked():
    """No CUDA device and no ``device=`` -> raise; never a silent CPU run."""
    from repro_torch.configs import get_config
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.transformer import Model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = get_config("qwen2.5-32b", "smoke")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "qwen2.5-32b", "--requests", "1"])
    assert Model(cfg, device="cpu").device.type == "cpu"


def _refusals():
    from repro_torch.serve import EngineConfig
    base = dict(prefix_share=False)
    return {
        # the reference's own refusals: an explicit mixed=True needs paged,
        # unquantized lanes (both serve through the serialized engine)
        "kv_quant": (EngineConfig(mixed=True, **base), {},
                     {"kv_quant": True}),
        "paged=False": (EngineConfig(mixed=True, paged=False, **base), {},
                        {}),
        "temperature": (EngineConfig(temperature=0.7, **base), {}, {}),
        "top_k": (EngineConfig(top_k=4, **base), {}, {}),
        "audit": (EngineConfig(audit=True, **base), {}, {}),
        "faults": (EngineConfig(**base), {"faults": object()}, {}),
        "mesh": (EngineConfig(**base), {"mesh": object()}, {}),
        "fleet": (EngineConfig(**base), {"fleet": object()}, {}),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_refused_engine_settings(name):
    """Every setting outside the port so far, and every setting the
    reference refuses, raises UnsupportedConfigError."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.errors import UnsupportedConfigError
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine
    config, kw, model_over = _refusals()[name]
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    with pytest.raises(UnsupportedConfigError):
        model = Model(dataclasses.replace(cfg, **model_over), device="cpu")
        Engine(model, None, config=config, **kw)


@pytest.mark.parametrize("arch,over", [
    ("mamba2-370m", {}), ("recurrentgemma-2b", {}), ("dbrx-132b", {}),
    ("starcoder2-15b", {}), ("llava-next-mistral-7b", {}),
    ("dbrx-132b", {"factorized": True}),
    ("qwen2.5-32b", {"weight_format": "int3"})])
def test_refused_models(arch, over):
    """Families outside the slice (compressed MoE among them) are refused
    by Model; an unknown weight format is a ValueError, as in the
    reference."""
    from repro_torch.configs import get_config
    from repro_torch.core.errors import UnsupportedConfigError
    from repro_torch.models.transformer import Model
    exc = ValueError if "weight_format" in over else UnsupportedConfigError
    with pytest.raises(exc):
        Model(get_config(arch, "smoke", **over), device="cpu")


def test_per_request_sampling_and_dry_pool_refused(qwen):
    """Per-request sampling is refused (ROADMAP Queue 1 item 7c). The dry
    pool is no longer refused: 7 pages of 8 tokens cannot hold two
    30-token prompts growing at once, so the engine preempts and requeues
    (as the reference does) and serves every request with the tokens of
    an uncut pool."""
    from repro_torch.core.errors import UnsupportedConfigError
    from repro_torch.serve import (Engine, EngineConfig, Request,
                                   SamplingParams)
    cfg, _, _, tm, tparams = qwen
    eng = Engine(tm, tparams, config=EngineConfig(**tp.ENGINE_KW))
    with pytest.raises(UnsupportedConfigError, match="7c"):
        eng.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                           sampling=SamplingParams(temperature=0.5)))
    outs = []
    for frac in (0.34, 1.0):
        small = Engine(tm, tparams, config=EngineConfig(
            page_size=8, pool_frac=frac, **tp.ENGINE_KW))
        for i, p in enumerate(tp.prompts(cfg.vocab_size, [30, 30, 30])):
            small.submit(Request(rid=i, prompt=p, max_new_tokens=4))
        outs.append({r.rid: (list(r.output), r.status) for r in small.run()})
        outs.append(small.decode_stats["preemptions"])
    assert outs[0] == outs[2] and outs[1] > 0 and outs[3] == 0
