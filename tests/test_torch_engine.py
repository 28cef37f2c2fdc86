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
    """name -> (EngineConfig, Engine kwargs, model overrides, what the
    reference does: the exception it raises, or None when it accepts)."""
    from repro_torch.core.errors import UnsupportedConfigError as U
    from repro_torch.serve import EngineConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serve.pages import FleetPrefixIndex
    base = dict(prefix_share=False)
    return {
        # the reference's own refusals: an explicit mixed=True needs paged,
        # unquantized lanes (both serve through the serialized engine)
        "kv_quant": (EngineConfig(mixed=True, **base), {},
                     {"kv_quant": True}, U),
        "paged=False": (EngineConfig(mixed=True, paged=False, **base), {},
                        {}, U),
        # sampling and audits are served
        "temperature": (EngineConfig(temperature=0.7, **base), {}, {}, None),
        "top_k": (EngineConfig(top_k=4, **base), {}, {}, None),
        "audit": (EngineConfig(audit=True, **base), {}, {}, None),
        # faults must be a FaultPlan or an injector; a fleet needs sharing
        "faults": (EngineConfig(**base), {"faults": object()}, {},
                   TypeError),
        "fleet": (EngineConfig(**base), {"fleet": FleetPrefixIndex()}, {},
                  U),
        # a mesh is served on (1, N) only, the reference's serving mesh:
        # a data axis above 1 is refused at construction
        "mesh": (EngineConfig(**base), {"mesh": Mesh(
            {"data": 2, "model": 1}, {"data": 0, "model": 0}, {},
            torch.device("cpu"))}, {}, U),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_refused_engine_settings(name):
    """Each setting does what the reference does with it: the reference's
    refusals raise as there (an explicit mixed step on int8 or contiguous
    lanes, ``faults`` of an unknown type, a fleet without prefix sharing),
    sampling and audits are accepted, and a ``mesh`` whose ``data`` axis
    is above 1 (the Engine serves the reference's ``(1, N)`` serving
    mesh) raises UnsupportedConfigError."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, FaultPlan
    config, kw, model_over, exc = _refusals()[name]
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    model = Model(dataclasses.replace(cfg, **model_over), device="cpu")
    if exc is not None:
        with pytest.raises(exc):
            Engine(model, None, config=config, **kw)
        return
    eng = Engine(model, None, config=config, **kw)
    assert (eng.temperature, eng.top_k, eng.audit) == (
        config.temperature, config.top_k, bool(config.audit))
    Engine(model, None, config=config, faults=FaultPlan(seed=1))


@pytest.mark.parametrize("arch,over", [
    ("mamba2-370m", {}), ("recurrentgemma-2b", {}), ("musicgen-large", {}),
    ("starcoder2-15b", {"n_encoder_layers": 2}),
    ("llava-next-mistral-7b", {}),
    ("mamba2-370m", {"factorized": True}),
    ("qwen2.5-32b", {"weight_format": "int3"})])
def test_refused_models(arch, over):
    """What each configuration meets at construction: an encoder-decoder
    is refused by Model (it runs through ``EncDecModel``, item 12c) and
    an unknown weight format is a ValueError, as in the reference; the
    recurrent stacks (factorized or
    not) construct, and their Engine refuses ``mixed=True`` with the
    reference's message; the models fed external embeddings (llava,
    musicgen) construct, and the Engine refuses them (it feeds token ids
    only, as the reference's does)."""
    from repro_torch.configs import get_config
    from repro_torch.core.errors import UnsupportedConfigError
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig
    cfg = get_config(arch, "smoke", **over)
    if "weight_format" in over or cfg.n_encoder_layers:
        exc = ValueError if "weight_format" in over \
            else UnsupportedConfigError
        with pytest.raises(exc):
            Model(cfg, device="cpu")
        return
    model = Model(cfg, device="cpu")
    if cfg.external_embeddings:
        with pytest.raises(UnsupportedConfigError, match="token ids only"):
            Engine(model, None, config=EngineConfig(max_len=16))
        return
    with pytest.raises(UnsupportedConfigError, match="mixed-step serving"):
        Engine(model, None, config=EngineConfig(max_len=16, mixed=True))
    assert not Engine(model, None, config=EngineConfig(max_len=16)).mixed


def test_per_request_sampling_and_dry_pool_refused(qwen):
    """Per-request sampling runs (it was refused before the port had the
    sampler): a request with its own ``SamplingParams`` on a greedy engine
    draws the reference Engine's tokens. The dry pool is not refused
    either: 7 pages of 8 tokens cannot hold two 30-token prompts growing
    at once, so the engine preempts and requeues (as the reference does)
    and serves every request with the tokens of an uncut pool."""
    from repro.serve import (Engine as JEngine, EngineConfig as JConfig,
                             Request as JRequest,
                             SamplingParams as JSampling)
    from repro_torch.serve import (Engine, EngineConfig, Request,
                                   SamplingParams)
    cfg, jm, jp, tm, tparams = qwen
    prompt = tp.prompts(cfg.vocab_size, [9], seed=4)[0]
    sampled = []
    for eng_cls, cfg_cls, req_cls, sp_cls, model, params in (
            (Engine, EngineConfig, Request, SamplingParams, tm, tparams),
            (JEngine, JConfig, JRequest, JSampling, jm, jp)):
        eng = eng_cls(model, params, config=cfg_cls(**tp.ENGINE_KW))
        eng.submit(req_cls(rid=0, prompt=prompt, max_new_tokens=6,
                           sampling=sp_cls(temperature=0.5, seed=11)))
        (r,) = eng.run()
        sampled.append((r.status, list(r.output)))
    assert sampled[0] == sampled[1] and sampled[0][0] == "ok"
    outs = []
    for frac in (0.34, 1.0):
        small = Engine(tm, tparams, config=EngineConfig(
            page_size=8, pool_frac=frac, **tp.ENGINE_KW))
        for i, p in enumerate(tp.prompts(cfg.vocab_size, [30, 30, 30])):
            small.submit(Request(rid=i, prompt=p, max_new_tokens=4))
        outs.append({r.rid: (list(r.output), r.status) for r in small.run()})
        outs.append(small.decode_stats["preemptions"])
    assert outs[0] == outs[2] and outs[1] > 0 and outs[3] == 0
