"""The yardstick's operation and byte counts against hand counts at one
small shape, and the readers that divide them by time."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from bench.lib import counts  # noqa: E402
from bench.lib.drive import StepRec, Window  # noqa: E402
from bench.lib.modelspec import spec_from_dict  # noqa: E402
from bench.lib.readers import Run, load_reader  # noqa: E402
from bench.lib.traffic import mix_from_dict  # noqa: E402

# d 64, 4 q / 2 kv heads of 16, d_ff 128, 2 layers, vocab 256
BASE = {"name": "t", "hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "num_hidden_layers": 2, "vocab_size": 256, "hidden_act": "silu",
        "norm_type": "rms_norm", "norm_epsilon": 1e-6, "qkv_bias": True,
        "rope_theta": 1e4, "torch_dtype": "bfloat16",
        "param_dtype": "float32"}


def spec(**over):
    return spec_from_dict(dict(BASE, **over))


def test_dense_linear_counts():
    s = spec()
    lins = {lin.name: lin for lin in s.linears()}
    assert set(lins) == {"wq", "wk", "wv", "wo", "w_up", "w_down", "w_gate"}
    q = lins["wq"]
    assert counts.linear_flops(q, 3) == 2 * 3 * 64 * 64
    # x in, weights, y out (bf16), bias
    assert counts.linear_bytes(q, s, 3) == 64 * 64 * 2 + 3 * 128 * 2 + 64 * 2
    # per token: q, o 64x64; k, v 64x32; up, gate 64x128; down 128x64
    per_token = 2 * (2 * 64 * 64 + 2 * 64 * 32 + 3 * 64 * 128)
    assert sum(counts.linear_flops(lin, 1) for lin in lins.values()) == \
        per_token


def test_factorized_counts_use_nonzeros():
    s = spec(factorization={"enabled": True, "min_dim": 32})
    up = {lin.name: lin for lin in s.linears()}["w_up"]
    # rank: 0.625 x 64 = 40 -> 128 (at least 128); nnz 0.125 x 128 = 16
    assert (up.r, up.nnz) == (128, 16)
    assert counts.linear_flops(up, 5) == 2 * 5 * (64 * 128 + 16 * 128)
    codes = 64 * 128 // 2 + 64
    wd = 128 * (4 + 15 + 16) + 8
    assert counts.linear_bytes(up, s, 5) == codes + wd + 5 * (64 + 128) * 2


def test_decode_attention_counts():
    s = spec()
    flops, byts = counts.decode_attn(s, np.array([10, 3]))
    keys = 10 + 3
    assert flops == 2 * 4 * (4 * 16) * keys
    kv = 2 * 2 * 16 * 2  # K and V of one token, bf16
    assert byts == 2 * (kv * keys + 2 * 2 * (4 * 16) * 2)


def test_window_caps_keys():
    s = spec(use_sliding_window=True, sliding_window=8)
    assert counts.keys_for(s, np.array([0, 7, 8, 100])).tolist() == \
        [1, 8, 8, 8]
    flops, byts = counts.decode_attn(s, np.array([50]))
    assert flops == 2 * 4 * 64 * 8


def test_mixed_attention_counts():
    s = spec(use_sliding_window=True, sliding_window=8)
    # one row: 3 fresh tokens at positions 6, 7, 8 (keys 7, 8, 8); 6
    # resident; one decode row at position 20 (keys 8, 8 resident)
    flops, byts = counts.mixed_attn(s, np.array([6, 20]), np.array([3, 1]))
    assert flops == 2 * 4 * 64 * (7 + 8 + 8 + 8)
    kv = 2 * 2 * 16 * 2
    chunk = (2 * 64 + 2 * 32) * 2
    assert byts == 2 * (kv * 6 + 3 * chunk + kv * 8 + 1 * chunk)


def test_step_work_counts_only_live_rows():
    s = spec()
    w = counts.step_work(s, "mixed", np.array([0, 9, 4]),
                         np.array([5, 1, 0]))
    assert (w["m"], w["rows"]) == (6, 2)
    assert w["head_flops"] == 2 * 2 * 64 * 256
    assert w["flops"] == w["linear_flops"] + w["attn_flops"] + \
        w["head_flops"]


def _run(steps, trace=None, **over):
    s = spec(**over)
    w = Window(t0=0.0, t_close=1.0, t_last=2.0, steps=steps)
    mix = mix_from_dict({"name": "m", "loop": "closed", "clients": 2,
                         "prompt": {"min": 1, "max": 2},
                         "output": {"min": 1, "max": 2}, "per_client": 2,
                         "size_seed": 0, "engine": {}})
    return Run(workload="w", spec=s, mix=mix, window=w, setup_s=1.0,
               trace=trace)


def _step(kind, lengths, n_new, t0, t1, traced=True):
    return StepRec(kind=kind, lengths=np.array(lengths),
                   n_new=np.array(n_new), slots=4, pages_in_use=3,
                   pages_total=12, run_ms=(t1 - t0) * 1e3, t_start=t0,
                   t_end=t1, emitted=len(lengths), traced=traced)


def test_mfu_and_rooflines_against_hand_counts():
    steps = [_step("decode", [10, 3], [1, 1], 0.0, 0.5),
             _step("mixed", [6, 20], [3, 1], 0.5, 1.5)]
    trace = {"kernels": [("void mixed_tc_kernel<x>", 0.0, 2e-6),
                         ("pagedaddr_decode", 0.0, 1e-6),
                         ("gemm", 0.0, 1.0)],
             "busy_s": 0.5, "window_s": 2.0}
    run = _run(steps, trace)
    s = run.spec
    flops = sum(counts.step_work(s, st.kind, st.lengths, st.n_new)["flops"]
                for st in steps)
    mfu = load_reader("metrics", "step_mfu").read(run)
    assert mfu == pytest.approx(100 * flops / (2.0 * 989e12))
    fd, bd = counts.decode_attn(s, np.array([11, 4]))
    got = load_reader("metrics", "tda_paged_decode_roofline").read(run)
    assert got == pytest.approx(100 * max(fd / 989e12, bd / 3.35e12) / 1e-6)
    fm, bm = counts.mixed_attn(s, np.array([6, 20]), np.array([3, 1]))
    got = load_reader("metrics", "tda_mixed_roofline").read(run)
    assert got == pytest.approx(100 * max(fm / 989e12, bm / 3.35e12) / 2e-6)
    assert load_reader("metrics", "idle_share").read(run) == 75.0
    assert load_reader("metrics", "kv_memory_ratio").read(run) == 25.0
    assert load_reader("metrics", "batch_occupancy").read(run) == 50.0
    assert load_reader("metrics", "mixed_step_ms").read(run) == \
        pytest.approx(1000.0)
    # no DMM/SMM on a dense model, no trace in an untraced run
    assert load_reader("metrics", "dmm_smm_roofline").read(run) is None
    assert load_reader("metrics", "tda_mixed_roofline").read(
        _run(steps)) is None


def test_linear_roofline_counts_each_linear():
    steps = [_step("decode", [10, 3], [1, 1], 0.0, 0.5)]
    trace = {"kernels": [("dmm_small_kernel", 0.0, 1e-3),
                         ("smm_small_kernel", 0.0, 1e-3)],
             "busy_s": 0.5, "window_s": 1.0}
    run = _run(steps, trace, factorization={"enabled": True, "min_dim": 32})
    s = run.spec
    bound = s.layers * sum(
        max(counts.linear_flops(lin, 2) / 989e12,
            counts.linear_bytes(lin, s, 2) / 3.35e12)
        for lin in s.linears())
    got = load_reader("metrics", "dmm_smm_roofline").read(run)
    assert got == pytest.approx(100 * bound / 2e-3)
