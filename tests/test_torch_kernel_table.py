"""The port's kernel tables (``repro_torch.launch.kernel_table``) on the
CPU: the reference's row names in order, its weight-byte and blocks
figures from the same seeded inputs, and no file written into the working
directory."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROWS = ["kernels/dmm_lut_matmul", "kernels/smm_compressed_matmul",
        "kernels/afu_softmax_lut", "decode_attn/fused", "decode_attn/dense",
        "decode_attn/blocks"]


def _table(capsys, argv):
    from repro_torch.launch import kernel_table
    assert kernel_table.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    return [ln.split(",", 2) for ln in lines[1:]]


def test_kernel_table_matches_reference_rows(capsys, tmp_path, monkeypatch):
    from repro.core import compression as rc
    from repro.kernels.tda import block_stats as jstats
    monkeypatch.chdir(tmp_path)
    rows = _table(capsys, ["kernels", "decode_attn", "--device", "cpu"])
    assert [r[0] for r in rows] == ROWS
    assert all(np.isfinite(float(r[1])) for r in rows)
    assert list(tmp_path.iterdir()) == []  # nothing in the working dir
    derived = {r[0]: r[2] for r in rows}
    # the reference's inputs, drawn in its order, and its byte formulas
    rng = np.random.default_rng(0)
    M, K, r, N, nnz = 128, 512, 320, 512, 40
    rng.normal(size=(K, r))
    rng.normal(size=(M, K))
    cwd = rc.compress_wd(rng.normal(size=(r, N)).astype(np.float32), nnz)
    dense, comp = K * r * 2, K * r // 2 + 64
    assert derived["kernels/dmm_lut_matmul"] == \
        f"weight_bytes {dense}->{comp} ({dense / comp:.1f}x less HBM)"
    dense, stream = r * N * 2, (rc.wd_compressed_bits(cwd) + 7) // 8
    assert derived["kernels/smm_compressed_matmul"] == \
        f"weight_bytes {dense}->{stream} ({dense / stream:.1f}x less HBM)"
    err = float(derived["kernels/afu_softmax_lut"].split("=")[1])
    assert 0 < err < 5e-3  # the reference test's bound for the 64-entry LUT
    lengths = np.random.default_rng(0).integers(4, 128 - 8, size=8)
    bs = jstats(lengths, 128, 32)
    assert derived["decode_attn/blocks"] == (
        f"visited={bs['visited']}/{bs['dense']} ratio={bs['ratio']:.2f} "
        f"(target <0.7: work follows occupancy)")


def test_kernel_table_sidecar_only_with_out(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = _table(capsys, ["decode_attn", "--device", "cpu", "--out",
                           str(tmp_path / "out")])
    assert [r[0] for r in rows] == ROWS[3:]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out"]
    side = json.loads((tmp_path / "out" / "BENCH_decode_attn.json")
                      .read_text())
    assert [r["name"] for r in side["rows"]] == ROWS[3:]
    assert side["kv_blocks_visited"] < side["kv_blocks_dense"]
    from repro_torch.launch import kernel_table
    with pytest.raises(SystemExit):
        kernel_table.main(["nonesuch", "--device", "cpu"])


def test_kernel_table_returns_kernel_and_plain_outputs():
    """``run`` returns each kernel row's output beside its plain version's
    on the same inputs; on the CPU the wrappers run plain versions, so the
    two agree up to summation order."""
    from repro_torch.launch import kernel_table
    results = kernel_table.run(kernel_table.TABLES, torch.device("cpu"))
    outs = {n: o for t in results.values() for n, o in t.outputs.items()}
    assert sorted(outs) == sorted(ROWS[:4])
    for name, (got, plain) in outs.items():
        assert got.shape == plain.shape and got.dtype == torch.float32
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
