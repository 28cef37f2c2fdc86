"""The check fails what it should: a whole run of the harness on the CPU
(the look for a chip skipped), at a size a test run holds, comes out
correct; with a served token altered where the engine picks it, it comes
out not correct; and the control (the reference in float8) reads a widest
gap several times the program's."""
import pytest

pytest.importorskip("torch")

import time  # noqa: E402

import numpy as np  # noqa: E402

from bench import run as bench_run  # noqa: E402
from bench.lib import program  # noqa: E402
from bench.lib.modelspec import spec_from_dict  # noqa: E402
from bench.lib.traffic import mix_from_dict  # noqa: E402

program._import_path()

CONF = {"name": "t", "hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "num_hidden_layers": 2, "vocab_size": 256, "hidden_act": "silu",
        "norm_type": "rms_norm", "norm_epsilon": 1e-6, "qkv_bias": True,
        "rope_theta": 1e4, "param_dtype": "float32",
        "factorization": {"enabled": True, "min_dim": 32}}
MIX = {"name": "t", "loop": "closed", "clients": 3,
       "prompt": {"min": 20, "max": 60}, "output": {"min": 4, "max": 12},
       "per_client": 400, "size_seed": 1,
       "engine": {"num_slots": 3, "max_len": 16, "max_prompt_len": 64,
                  "max_new_tokens": 12, "page_size": 8, "prefill_budget": 32,
                  "prefix_share": False}}
LIMIT = {"widest_gap": {"limit": 1e-3}}
SEEDS = (2**31 + 5, 17)


def run(dtype, seed, readings=False):
    spec = spec_from_dict(dict(CONF, torch_dtype=dtype))
    return bench_run.run_cell(spec, mix_from_dict(MIX), "t", seed, 2.0,
                              False, "cpu", LIMIT, ["output_tok_s"],
                              time.perf_counter(), readings=readings)


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(seed):
    out = run("float32", seed)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["metrics"]["output_tok_s"]["value"] > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_token_altered_where_produced_is_not_correct(seed, monkeypatch):
    from repro_torch.serve.engine import Engine
    choose = Engine._choose
    calls = {"n": 0}

    def altered(logits, nan_mask, sampling):
        tok = choose(logits, nan_mask, sampling)
        calls["n"] += 1
        if calls["n"] % 3 == 0:  # every third step, one row's token
            tok = tok.clone()
            tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok

    monkeypatch.setattr(Engine, "_choose", staticmethod(altered))
    out = run("float32", seed)
    assert calls["n"] > 0
    assert not out["correct"], out["checks"]
    assert out["checks"]["widest_gap"]["value"] > LIMIT["widest_gap"][
        "limit"]


def test_control_reads_far_above_the_program():
    """bf16 compute, as the cells run: the control's first choices fall
    further below the reference's best than the served tokens do."""
    out = run("bfloat16", SEEDS[0], readings=True)
    r = out["readings"]
    assert r["served_tokens_checked"] > 0
    assert r["control_widest_gap"] >= 3 * max(r["widest_gap"], 1e-3), r
    assert np.isfinite(r["widest_gap"])
