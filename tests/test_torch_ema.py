"""The port's T-REX chip model (``repro_torch.core.ema``) and the paper
tables launcher (``repro_torch.launch.paper_tables``) against the
reference's ``repro.core.ema`` and ``benchmarks/tables.py``: every report
of every ``PAPER_WORKLOADS`` entry, within ``RTOL_EMA`` (1e-12: the same
float64 arithmetic in the same order over the same integer bit counts),
and the paper's claims E1-E5 asserted on the port's module with the
bands of ``tests/test_ema_paper_claims.py``."""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

RTOL_EMA = 1e-12


def _fcfgs():
    from repro.core.factorized import FactorizationConfig as JF
    from repro_torch.core.factorized import FactorizationConfig as TF
    return JF(enabled=True), TF(enabled=True)


def _close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (int, np.integer)) and not isinstance(w, bool):
            assert g == w, k
        elif math.isinf(w):
            assert g == w, k
        else:
            assert abs(g - w) <= RTOL_EMA * abs(w), (k, g, w)


@pytest.mark.parametrize("name", ["vit", "mt", "s2t", "bert", "bert_large"])
def test_reports_match_reference(name):
    """Every report, both dynamic-batching modes, both corners, and the
    workload specs themselves."""
    from repro.core import ema as J
    from repro_torch.core import ema as T
    jf, tf = _fcfgs()
    jw, tw = J.PAPER_WORKLOADS[name], T.PAPER_WORKLOADS[name]
    assert [tuple(vars(m).values()) for m in tw.matrices] == \
        [tuple(vars(m).values()) for m in jw.matrices]
    assert (tw.d_model, tw.max_len, tw.avg_len, tuple(tw.len_hist),
            tw.emb_rows, tw.act_bits) == (jw.d_model, jw.max_len, jw.avg_len,
                                          tuple(jw.len_hist), jw.emb_rows,
                                          jw.act_bits)
    assert T.dense_weight_bits(tw) == J.dense_weight_bits(jw)
    for compressed in (True, False):
        assert T.trex_weight_bits(tw, tf, compressed) == \
            J.trex_weight_bits(jw, jf, compressed)
        assert T.stream_bits_per_inference(tw, tf, compressed) == \
            J.stream_bits_per_inference(jw, jf, compressed)
    for fc in (None, "fact"):
        _close({"m": T.macs_per_token(tw, fc and tf)},
               {"m": J.macs_per_token(jw, fc and jf)})
    for dyn in (True, False):
        _close(T.ema_report(tw, tf, dynamic_batching=dyn),
               J.ema_report(jw, jf, dynamic_batching=dyn))
        _close(T.utilization_report(tw, dynamic_batching=dyn),
               J.utilization_report(jw, dynamic_batching=dyn))
        for corner in ("fast", "slow"):
            _close(T.latency_energy_report(tw, tf, corner=corner,
                                           dynamic_batching=dyn),
                   J.latency_energy_report(jw, jf, corner=corner,
                                           dynamic_batching=dyn))
    _close(T.utilization_report(tw, trf=False),
           J.utilization_report(jw, trf=False))
    assert vars(T.ChipSpec()) == vars(J.ChipSpec())


def _claims():
    """The checks of ``tests/test_ema_paper_claims.py``, on the port's
    module: ``{claim: check()}``."""
    from repro_torch.core import ema
    _, FCFG = _fcfgs()
    W = ema.PAPER_WORKLOADS
    chip = ["vit", "mt", "s2t", "bert"]

    def reports(key):
        return [ema.ema_report(w, FCFG)[key] for w in W.values()]

    def e2_factorize():
        vals = reports("reduction_factorize")
        assert min(vals) > 8.5 * 0.75 and max(vals) < 10.7 * 1.25

    def e2_compress():
        vals = reports("reduction_compress")
        assert min(vals) > 2.0 and max(vals) < 2.9 * 1.1

    def e2_total():
        vals = sorted(reports("reduction_total"))
        assert vals[-1] > 40 and vals[0] < 66 and all(v > 15 for v in vals)

    def e1_params():
        vals = [ema.dense_weight_bits(w) / ema.trex_weight_bits(
            w, FCFG)["total"] for w in W.values()]
        assert min(vals) > 15.9 * 0.7 and max(vals) < 25.5 * 1.1

    def e3_macs():
        vals = [ema.macs_per_token(w, None) / ema.macs_per_token(w, FCFG)
                for w in W.values()]
        assert min(vals) >= 1.0 and max(vals) <= 2.14

    def e4_utilization():
        vals = [ema.utilization_report(w)["improvement"] for w in W.values()]
        assert min(vals) >= 1.15 and max(vals) <= 3.4

    def e4_trf():
        g = ema.utilization_report(W["vit"])["trf_gain"]
        assert 1.12 <= g <= 1.25

    def e5_latency_energy():
        rep = [ema.latency_energy_report(W[n], FCFG, corner="slow")
               for n in chip]
        lat = [r["us_per_token"] for r in rep]
        en = [r["uJ_per_token"] for r in rep]
        assert min(lat) < 567 * 2 and max(lat) > 68
        assert min(en) < 3.95 * 2 and max(en) > 0.41
        order = np.argsort([ema.macs_per_token(W[n], FCFG) for n in chip])
        assert np.argsort(lat).tolist() == order.tolist()

    def decomposition():
        r = ema.ema_report(W["bert"], FCFG)
        total = (r["reduction_factorize"] * r["reduction_compress"]
                 * r["reduction_batching"])
        assert abs(total / r["reduction_total"] - 1) < 0.15

    def no_batching():
        r = ema.ema_report(W["bert"], FCFG, dynamic_batching=False)
        assert r["reduction_batching"] == pytest.approx(1.0)

    return {f.__name__: f for f in (
        e2_factorize, e2_compress, e2_total, e1_params, e3_macs,
        e4_utilization, e4_trf, e5_latency_energy, decomposition,
        no_batching)}


@pytest.mark.parametrize("claim", list(_claims()))
def test_paper_claims_bands(claim):
    """E1-E5 (and the decomposition checks) on the port's chip model."""
    _claims()[claim]()


def test_paper_tables_match_reference(capsys):
    """``python -m repro_torch.launch.paper_tables``: the reference's row
    names and derived strings for every table (the measured packing row's
    time aside, a host time), in its CSV."""
    from benchmarks import tables as J
    from repro_torch.launch import paper_tables as T
    want = {"params": J.bench_params, "ema": J.bench_ema,
            "macs": J.bench_macs, "utilization": J.bench_utilization,
            "latency_energy": J.bench_latency_energy}
    got = T.run()
    assert list(got) == list(T.TABLES)
    for name, fn in want.items():
        assert [(r[0], r[2]) for r in got[name]] == \
            [(r[0], r[2]) for r in fn()], name
    assert T.main(["ema", "macs"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == \
        [r[0] for r in got["ema"] + got["macs"]]
