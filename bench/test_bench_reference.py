"""The harness's weights have the program's layout; the plain reference,
with the compressed values it works out again itself, gives the program's
logits at float32 on the CPU (a full-sequence forward, a windowed stack
past its window)."""
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from bench.lib import program  # noqa: E402
from bench.lib.modelspec import spec_from_dict  # noqa: E402
from bench.lib.weights import layer_leaf, leaf_specs, make_leaf, \
    make_tree  # noqa: E402
from bench.reference import decoder, trex  # noqa: E402

program._import_path()

BASE = {"name": "t", "hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "num_hidden_layers": 2, "vocab_size": 256, "norm_epsilon": 1e-6,
        "qkv_bias": True, "rope_theta": 1e4, "torch_dtype": "float32",
        "param_dtype": "float32"}
QWEN = dict(BASE, hidden_act="silu", norm_type="rms_norm",
            factorization={"enabled": True, "min_dim": 32})
STARCODER = dict(BASE, hidden_act="gelu_pytorch_tanh",
                 norm_type="layer_norm", use_sliding_window=True,
                 sliding_window=8)
SEED = 2**31 + 99


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape), v.dtype


@pytest.mark.parametrize("conf", [QWEN, STARCODER], ids=["qwen", "sc2"])
def test_tree_has_the_programs_layout(conf):
    from repro_torch.models.transformer import Model
    spec = spec_from_dict(conf)
    model = Model(program.model_config(spec), device="cpu")
    want = sorted(flat(model.param_shapes()))
    got = sorted(flat(make_tree(spec, SEED, "cpu")))
    assert got == want


def test_one_layer_made_again_is_the_same():
    spec = spec_from_dict(QWEN)
    for leaf in leaf_specs(spec):
        if leaf[2]:
            whole = make_leaf(spec, SEED, leaf, "cpu")
            assert torch.equal(whole[1], layer_leaf(spec, SEED, leaf, 1,
                                                    "cpu"))


def test_compression_worked_out_again_matches_the_programs():
    from repro_torch.core import compression as comp
    from repro_torch.core import sparsity
    spec = spec_from_dict(QWEN)
    leaves = {"/".join(lf[0]): lf for lf in leaf_specs(spec)}
    ws = make_leaf(spec, SEED, leaves["dicts/ffn_up"], "cpu")
    codes, lut = trex.kmeans_lut(ws)
    mine = comp.compress_ws(ws)
    assert torch.equal(lut, mine.lut)
    assert torch.equal(codes.to(torch.uint8), mine.codes)
    wd = layer_leaf(spec, SEED, leaves["layers/ffn/w_up/wd"], 0, "cpu")
    nnz = {lin.name: lin for lin in spec.linears()}["w_up"].nnz
    prog = comp.decompress_wd_dense(comp.compress_wd(
        sparsity.project_topk_columns(wd, nnz), nnz, value_bits=6))
    assert torch.allclose(trex.served_wd(wd, nnz, 6), prog, atol=1e-7)


@pytest.mark.parametrize("conf", [QWEN, STARCODER], ids=["qwen", "sc2"])
def test_reference_logits_match_the_programs_forward(conf):
    from repro_torch.core.factorized import project_wd_leaves
    from repro_torch.models.transformer import Model
    spec = spec_from_dict(conf)
    model = Model(program.model_config(spec), device="cpu")
    params = make_tree(spec, SEED, "cpu")
    if spec.factorized:
        model, params, _ = model.compress_params(
            project_wd_leaves(params, model.cfg.factorization))
    toks = torch.randint(0, spec.vocab, (1, 21),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, _ = model.apply(model.prepare(params), {"inputs": toks})
    rows = torch.arange(21)
    got = decoder.logits_at(spec, trex.Weights(spec, SEED, "cpu"),
                            [(toks[0], rows)], [lambda t: t])[0][0]
    assert torch.allclose(got, want[0], atol=2e-4, rtol=1e-4), \
        float((got - want[0]).abs().max())
