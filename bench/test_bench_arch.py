"""A configuration brings its own architecture (``bench/lib/arch.py``).

A toy that the dense spec cannot express, routed experts over a stack of
windowed and full attention layers (``bench/toy/``), is served, counted
and checked through the harness as it stands: a sound run is correct, a
token altered where the engine picks it is not, the control reads far
above the program, and the model FLOP utilization and the attention
rooflines read the toy's own counts. The modules that configurations name
import nothing of the program. The dense configurations give, at a test
size, the weights, counts, reference logits and program configuration
that the harness gave before configurations named their modules."""
import pytest

pytest.importorskip("torch")

import ast  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import run as bench_run  # noqa: E402
from bench.lib import arch, check, counts, program  # noqa: E402
from bench.lib.drive import StepRec, Window  # noqa: E402
from bench.lib.readers import Run, load_reader, window_steps  # noqa: E402
from bench.lib.traffic import mix_from_dict  # noqa: E402
from bench.lib.weights import make_tree  # noqa: E402

program._import_path()

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
B = json.loads((ROOT / "BENCHMARK.json").read_text())

TOY = {"name": "toy", "arch": "bench/toy/arch.py",
       "reference": "bench/toy/reference.py", "hidden_size": 64,
       "num_hidden_layers": 2, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256,
       "num_local_experts": 4, "num_experts_per_tok": 2,
       "moe_intermediate_size": 32, "capacity_factor": 2.0,
       "layer_types": ["sliding_attention", "full_attention"],
       "sliding_window": 8, "rms_norm_eps": 1e-6, "rope_theta": 1e4,
       "param_dtype": "float32"}
MIX = {"name": "t", "loop": "closed", "clients": 3,
       "prompt": {"min": 20, "max": 60}, "output": {"min": 4, "max": 12},
       "per_client": 400, "size_seed": 1,
       "engine": {"num_slots": 3, "max_len": 16, "max_prompt_len": 64,
                  "max_new_tokens": 12, "page_size": 8, "prefill_budget": 32,
                  "prefix_share": False}}
LIMIT = {"widest_gap": {"limit": 1e-3}}
SEED = 2**31 + 5
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return request.param


def toy(dtype="float32"):
    return arch.spec_from_dict(dict(TOY, torch_dtype=dtype))


def run_toy(device, dtype="float32", traced=False, metrics=("output_tok_s",),
            readings=False, seed=SEED):
    return bench_run.run_cell(toy(dtype), mix_from_dict(MIX), "t", seed, 2.0,
                              traced, device, LIMIT, list(metrics),
                              time.perf_counter(), readings=readings,
                              reference=TOY["reference"])


def test_a_spec_names_its_module():
    from bench.lib.modelspec import load_spec
    assert arch.module_of(toy()).__name__ == "bench.toy.arch"
    for c in B["configs"]:
        assert arch.module_of(load_spec(ROOT / c["file"])).__name__ == \
            "bench.arch.dense"
    with pytest.raises(ValueError):
        arch.load_module("../outside.py")


def test_toy_program_config_and_layout():
    """The toy's dict becomes the program's config with its nested
    ``MoEConfig`` and its pattern as a tuple; the tree has the program's
    layout: each layer's leaves apart, the experts stacked."""
    from repro_torch.models.common import ModelConfig, MoEConfig
    from repro_torch.models.transformer import Model
    cfg = program.model_config(toy())
    assert isinstance(cfg, ModelConfig)
    assert cfg.moe == MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                                capacity_factor=2.0)
    assert cfg.layer_pattern == ("local", "attn") and cfg.local_window == 8

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), tuple(v.shape), v.dtype

    got = sorted(flat(make_tree(toy(), SEED, "cpu")))
    assert got == sorted(flat(Model(cfg, device="cpu").param_shapes()))
    assert (("layers", "layer_01", "moe", "w_down", "w"), (4, 32, 64),
            torch.float32) in got


def test_toy_reference_gives_the_programs_forward():
    from repro_torch.models.transformer import Model
    spec = toy()
    model = Model(program.model_config(spec), device="cpu")
    toks = torch.randint(0, spec.vocab, (1, 30),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, _ = model.apply(model.prepare(make_tree(spec, SEED, "cpu")),
                              {"inputs": toks})
    ref = arch.load_module(TOY["reference"])
    got = ref.logits_at(spec, ref.Weights(spec, SEED, "cpu"),
                        [(toks[0], torch.arange(30))], [lambda t: t])[0][0]
    assert torch.allclose(got, want[0], atol=2e-4, rtol=1e-4), \
        float((got - want[0]).abs().max())


def test_toy_sound_run_is_correct(device):
    out = run_toy(device)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["metrics"]["output_tok_s"]["value"] > 0


def test_toy_token_altered_where_produced_is_not_correct(device,
                                                         monkeypatch):
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
    out = run_toy(device)
    assert calls["n"] > 0
    assert not out["correct"], out["checks"]
    assert out["checks"]["widest_gap"]["value"] > LIMIT["widest_gap"][
        "limit"]


def test_toy_control_reads_far_above_the_program(device):
    """The toy's reference in float8 (every product's operands, the
    router's too) puts first tokens further below its best than the
    program's served tokens lie. At float32 compute, as the toy states:
    in bf16 the router's near ties flip between the program and the
    reference, and the served tokens' gaps come near the control's."""
    out = run_toy(device, readings=True)
    r = out["readings"]
    assert r["served_tokens_checked"] > 0
    assert r["control_widest_gap"] >= 3 * max(r["widest_gap"], 1e-3), r


def test_toy_mfu_reads_the_toys_step_work(device, monkeypatch):
    """A traced toy run reads every per-layer metric of the benchmark
    without failing, ``step_mfu`` from the toy's own ``step_work`` over
    the window's steps; an untraced one every end-to-end metric."""
    kept = {}
    serve = bench_run.serve

    def keep(*a, **k):
        out = serve(*a, **k)
        kept["window"] = out[0]
        return out

    monkeypatch.setattr(bench_run, "serve", keep)
    names = [m["name"] for m in B["per_layer"]]
    out = run_toy(device, traced=True, metrics=names)
    assert out["correct"], out["checks"]
    run = Run(workload="t", spec=toy(), mix=mix_from_dict(MIX),
              window=kept["window"], setup_s=0.0)
    from bench.toy import arch as toy_arch
    flops = sum(toy_arch.step_work(run.spec, s.kind, s.lengths,
                                   s.n_new)["flops"]
                for s in window_steps(run))
    span = run.window.t_last - run.window.t0
    assert out["metrics"]["step_mfu"]["value"] == pytest.approx(
        100.0 * flops / (span * counts.PEAKS["bf16_flops"]))
    out = run_toy(device, metrics=[m["name"] for m in B["end_to_end"]])
    assert set(out["metrics"]) >= {"output_tok_s", "itl_p95_ms", "setup_s"}


def _step(kind, lengths, n_new, t0, t1):
    return StepRec(kind=kind, lengths=np.array(lengths),
                   n_new=np.array(n_new), slots=4, pages_in_use=3,
                   pages_total=12, run_ms=(t1 - t0) * 1e3, t_start=t0,
                   t_end=t1, emitted=len(lengths), traced=True)


def test_rooflines_and_mfu_read_the_toys_counts():
    """Against the toy's own counts by hand: the local layer's keys capped
    at its window, the full layer's not, each token's two experts."""
    steps = [_step("decode", [10, 3], [1, 1], 0.0, 0.5),
             _step("mixed", [6, 20], [3, 1], 0.5, 1.5)]
    trace = {"kernels": [("void mixed_tc_kernel<x>", 0.0, 2e-6),
                         ("pagedaddr_decode", 0.0, 1e-6)],
             "busy_s": 0.5, "window_s": 2.0}
    mix = mix_from_dict(dict(MIX, engine={}))
    run = Run(workload="w", spec=toy("bfloat16"), mix=mix,
              window=Window(t0=0.0, t_close=1.0, t_last=2.0, steps=steps),
              setup_s=1.0, trace=trace)
    hq, kv = 4 * 16, 2 * 2 * 16 * 2  # q width; K and V of a token, bf16
    # decode: rows at positions 10 and 3; the local layer sees 8 and 4
    # keys, the full one 11 and 4; q read and o written, a row a layer
    assert load_reader("metrics", "tda_paged_decode_roofline").read(run) \
        == pytest.approx(100 * max(4 * hq * 27 / 989e12,
                                   (kv * 27 + 2 * 2 * 2 * hq * 2) / 3.35e12)
                         / 1e-6)
    # mixed: 3 tokens at 6..8 (local keys 7, 8, 8; full 7, 8, 9) over 6
    # resident, one at 20 (8; 21) over 20 (8 in the local ring); each
    # token's q, k, v read and o written
    chunk = (2 * hq + 2 * 32) * 2
    assert load_reader("metrics", "tda_mixed_roofline").read(run) == \
        pytest.approx(100 * max(4 * hq * 76 / 989e12,
                                (kv * (14 + 26) + 8 * chunk) / 3.35e12)
                      / 2e-6)
    # linears a token: q, o 64x64, k, v 64x32, router 64x4, two experts'
    # gate, up 64x32 and down 32x64, in each of 2 layers; the head 64x256
    # a row; 2 + 4 tokens, 2 + 2 rows
    per_token = 2 * 2 * (2 * 64 * 64 + 2 * 64 * 32 + 64 * 4
                         + 2 * 3 * 64 * 32)
    flops = 6 * per_token + 4 * hq * (27 + 76) + 4 * 2 * 64 * 256
    assert load_reader("metrics", "step_mfu").read(run) == pytest.approx(
        100 * flops / (2.0 * 989e12))


# --- the modules that configurations name import nothing of the program


def _named_modules():
    names = {p.relative_to(ROOT).as_posix()
             for p in (BENCH / "arch").glob("*.py")}
    for c in B["configs"]:
        raw = json.loads((ROOT / c["file"]).read_text())
        names |= {raw.get("arch", arch.DENSE), raw["reference"]}
    return sorted(names | {TOY["arch"], TOY["reference"]})


@pytest.mark.parametrize("rel", _named_modules())
def test_named_module_imports_nothing_of_the_program(rel):
    tree = ast.parse((ROOT / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("repro_torch", "repro", "jax"), n
            assert not n.startswith("bench.lib.program"), n


def test_named_modules_load_nothing_of_the_program():
    """Imported in a fresh process, with what they import in turn."""
    mods = [".".join(Path(r).with_suffix("").parts)
            for r in _named_modules()]
    code = ("import sys; sys.path.insert(0, %r); import importlib; "
            "[importlib.import_module(m) for m in %r]; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax') or m == 'bench.lib.program'))"
            % (str(ROOT), mods))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# --- the dense configurations, bit for bit as before

# At a test size (d 64, 4 q / 2 kv heads of 16, d_ff 128, 2 layers, vocab
# 256; qwen's factorization from 32 wide, starcoder2's window 8), seed
# 2**31 + 77: sha256 prefixes of each leaf of make_tree, of the step_work
# dicts of STEPS (JSON, sorted keys), of the reference's float32 logits of
# one sequence (itself, then under check.fp8) and of the program's
# ModelConfig repr, as the harness gave them before configurations named
# their modules (modelspec.spec_from_dict, weights.make_tree,
# counts.step_work, decoder.logits_at over trex.Weights).
IDENTITY = {
    "qwen2.5-32b-trex": {
        "leaves": {
            "embed/tok": "c172fcaac654882e",
            "layers/norm1/scale": "c241eb0dd4598286",
            "layers/norm2/scale": "b259fa462fb9e782",
            "layers/attn/wq/wd": "d2b6823125e72e5b",
            "layers/attn/wq/b": "c0c4eeb8535941db",
            "layers/attn/wk/wd": "1a98bd3112105bf8",
            "layers/attn/wk/b": "78082bb898b4274a",
            "layers/attn/wv/wd": "14b680b34855cd2c",
            "layers/attn/wv/b": "e923474ee050fc48",
            "layers/attn/wo/wd": "69a0314bf1107f67",
            "layers/ffn/w_up/wd": "15cddd71fbe3284b",
            "layers/ffn/w_down/wd": "71dbd60885b8c298",
            "layers/ffn/w_gate/wd": "e207d82f548f175d",
            "final_norm/scale": "4ffbc677c7b21e55",
            "lm_head/w": "73ad6afe75010338",
            "dicts/attn_q": "5afdeb8e93d6cea6",
            "dicts/attn_k": "0820bbbe1731cd3c",
            "dicts/attn_v": "0476a0209789c067",
            "dicts/attn_o": "4bff48c425f77706",
            "dicts/ffn_up": "6c17bb8d43faa2de",
            "dicts/ffn_down": "364010fc93e42f75",
            "dicts/ffn_gate": "2b163465302b8048"},
        "step_work": "bfe27a7e061d609b",
        "logits": ["f47751bda14f298b", "486cf0a74a1919a7"],
        "model_config": "a9f796e678b0c8a8"},
    "starcoder2-15b-ring": {
        "leaves": {
            "embed/tok": "c11765525a043b38",
            "layers/norm1/scale": "046ccc412889336b",
            "layers/norm1/bias": "56c2c72782b94ef3",
            "layers/norm2/scale": "13e5c0a32df03f1d",
            "layers/norm2/bias": "cb3d7f64eb8c95e7",
            "layers/attn/wq/w": "bca97dcb5d330dee",
            "layers/attn/wq/b": "08ed52e2faf80f6e",
            "layers/attn/wk/w": "6d3c1efe2b841e30",
            "layers/attn/wk/b": "2fdb68e7f1b0c82d",
            "layers/attn/wv/w": "1551fd7156c50584",
            "layers/attn/wv/b": "d9c137d328d65f03",
            "layers/attn/wo/w": "88f37685dabc40dc",
            "layers/ffn/w_up/w": "ff026f2281cc3ab2",
            "layers/ffn/w_down/w": "11941dc66114c556",
            "final_norm/scale": "7730d917341b2f15",
            "final_norm/bias": "b2c252a04229f80e",
            "lm_head/w": "7001c29c4bd44f30"},
        "step_work": "9d1ec0f515c2ef9f",
        "logits": ["e4d797a039e42c83", "63952de539400f46"],
        "model_config": "2029fae84bdea012"},
}
SMALL = {"hidden_size": 64, "intermediate_size": 128,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "num_hidden_layers": 2, "vocab_size": 256}
STEPS = [("decode", [3, 9, 30], [1, 1, 1]), ("mixed", [0, 6, 20], [12, 1, 5])]
ID_SEED = 2**31 + 77


def _small(name):
    raw = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c = dict(raw, **SMALL)
    if c["factorization"]:
        c["factorization"] = dict(c["factorization"], min_dim=32)
    if c.get("use_sliding_window", True):
        c["sliding_window"] = 8
    return c


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()[:16]


def _tensor_sha(t) -> str:
    return _sha(t.contiguous().view(torch.uint8).numpy().tobytes())


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.mark.parametrize("name", sorted(IDENTITY))
def test_dense_leaves_as_before(name):
    spec = arch.spec_from_dict(_small(name))
    got = {p: _tensor_sha(v) for p, v in _flat(make_tree(spec, ID_SEED,
                                                         "cpu"))}
    assert got == IDENTITY[name]["leaves"]


@pytest.mark.parametrize("name", sorted(IDENTITY))
def test_dense_step_work_and_program_config_as_before(name):
    spec = arch.spec_from_dict(_small(name))
    run = Run(workload="w", spec=spec, mix=None,
              window=Window(steps=[_step(k, n, w, 0.0, 1.0)
                                   for k, n, w in STEPS]), setup_s=0.0)
    from bench.lib.readers import step_work
    work = [step_work(run, s) for s in run.window.steps]
    assert _sha(json.dumps(work, sort_keys=True).encode()) == \
        IDENTITY[name]["step_work"], work
    assert _sha(repr(program.model_config(spec)).encode()) == \
        IDENTITY[name]["model_config"]


@pytest.mark.parametrize("name", sorted(IDENTITY))
def test_dense_reference_logits_as_before(name):
    """Through the module the configuration's ``reference`` key names, as
    ``check.gaps`` takes it."""
    conf = _small(name)
    spec = arch.spec_from_dict(conf)
    ref = arch.load_module(conf["reference"])
    toks = torch.randint(0, 256, (21,),
                         generator=torch.Generator().manual_seed(5))
    res = ref.logits_at(spec, ref.Weights(spec, ID_SEED, "cpu"),
                        [(toks, torch.arange(3, 21))],
                        [lambda t: t, check.fp8])
    assert [_tensor_sha(r[0]) for r in res] == IDENTITY[name]["logits"]


def test_an_architecture_module_is_checked_when_loaded():
    """A module without the interface is refused when the configuration
    is read."""
    for mod in ("bench/lib/counts.py", "bench/lib/modelspec.py"):
        with pytest.raises(ValueError):
            arch.spec_from_dict(dict(_small("starcoder2-15b-ring"), arch=mod))
