"""Dynamic batching (sequence packing) and serialized admission: the
port's ``core/packing.py`` and ``Scheduler.next_admissions`` against the
reference on many random length lists."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

POLICIES = [(16, 4), (32, 2), (128, 4), (24, 3)]  # (max_len, max_per_row)


def _lengths(rng, max_len, n):
    # mostly short (several share a row), some exactly at a bucket edge
    cand = rng.integers(1, max_len + 1, size=n)
    edges = np.array([max_len, max_len // 2, max_len // 4, 1])
    pick = rng.random(n) < 0.3
    return np.where(pick, rng.choice(edges, size=n), cand).tolist()


def _same_batch(a, b):
    for f in ("tokens", "segment_ids", "positions"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert [tuple(s) for s in a.request_slots] == \
        [tuple(s) for s in b.request_slots]


@pytest.mark.parametrize("max_len,per_row", POLICIES)
def test_pack_requests_matches_reference(max_len, per_row):
    from repro.core import packing as J
    from repro_torch.core import packing as T
    rng = np.random.default_rng(max_len + per_row)
    for trial in range(25):
        reqs = [rng.integers(0, 1000, size=n).astype(np.int32)
                for n in _lengths(rng, max_len, int(rng.integers(1, 14)))]
        jp = J.pack_requests(reqs, J.PackingPolicy(max_len, per_row))
        tpk = T.pack_requests(reqs, T.PackingPolicy(max_len, per_row))
        _same_batch(tpk, jp)
        assert T.packing_utilization(tpk) == J.packing_utilization(jp)
        for n in range(1, max_len + 1):
            assert T.PackingPolicy(max_len, per_row).bucket(n) == \
                J.PackingPolicy(max_len, per_row).bucket(n)
    with pytest.raises(ValueError):
        T.PackingPolicy(max_len, per_row).bucket(max_len + 1)


@pytest.mark.parametrize("causal", [True, False])
def test_segment_mask_matches_reference(causal):
    import jax.numpy as jnp
    from repro.core.packing import segment_mask as jmask
    from repro_torch.core.packing import segment_mask
    rng = np.random.default_rng(3)
    for sq, skv in ((8, 8), (5, 12)):
        seg_q = rng.integers(0, 3, size=(3, sq)).astype(np.int32)
        seg_kv = rng.integers(0, 3, size=(3, skv)).astype(np.int32)
        got = segment_mask(tp.t(seg_q), tp.t(seg_kv), causal=causal)
        want = jmask(jnp.asarray(seg_q), jnp.asarray(seg_kv), causal=causal)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _queue(req_cls, lengths, seed):
    rng = np.random.default_rng(seed)
    return [req_cls(rid=i, prompt=rng.integers(0, 100, size=n)
                    .astype(np.int32)) for i, n in enumerate(lengths)]


def _budget_reserve(budget):
    """A stateful page-style budget: each request consumes ceil((len+1) /
    8) units; refuses (head-blocks) once the budget would overcommit."""
    left = [budget]

    def reserve(req):
        need = -(-(len(req.prompt) + 1) // 8)
        if need > left[0]:
            return False
        left[0] -= need
        return True
    return reserve


def _summary(groups):
    out = []
    for g in groups:
        kind = "packed" if g.packed is not None else "chunks"
        body = ([tuple(s) for s in g.packed.request_slots]
                if g.packed is not None
                else [c.tolist() for c in g.chunks])
        out.append((kind, [r.rid for r in g.requests], body,
                    g.utilization))
    return out


@pytest.mark.parametrize("max_len,max_rows", [(16, 8), (16, 2), (32, 1)])
def test_next_admissions_matches_reference(max_len, max_rows):
    """Groups (packed rows, solo chunked prompts), the row limit handing
    requests back to the queue head, free-slot limits and a reserve
    callback that head-blocks: admission by admission, queue left over
    included."""
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.serve.scheduler import Request, Scheduler
    rng = np.random.default_rng(max_len * 10 + max_rows)
    for trial in range(12):
        lengths = rng.integers(1, 3 * max_len, size=int(rng.integers(1, 16)))
        js = JScheduler(max_len=max_len, max_rows=max_rows,
                        max_prompt_len=3 * max_len)
        ts = Scheduler(max_len=max_len, max_rows=max_rows,
                       max_prompt_len=3 * max_len)
        for r in _queue(JRequest, lengths, trial):
            js.submit(r)
        for r in _queue(Request, lengths, trial):
            ts.submit(r)
        while js.pending():
            free = int(rng.integers(1, 7))
            budget = int(rng.integers(1, 3 * max_len // 4))
            budgeted = trial % 3 != 0
            jg = js.next_admissions(free, reserve=_budget_reserve(budget)
                                    if budgeted else None)
            tg = ts.next_admissions(free, reserve=_budget_reserve(budget)
                                    if budgeted else None)
            assert _summary(tg) == _summary(jg)
            assert [r.rid for r in ts.queue] == [r.rid for r in js.queue]
            if not jg:  # head-blocked by the budget: admit it unbudgeted
                jg = js.next_admissions(1)
                tg = ts.next_admissions(1)
                assert _summary(tg) == _summary(jg)


def test_scheduler_refuses_sharing_and_row_layout():
    """The row layout (``pack=False``, recurrent stacks) is served now:
    one row per request, no probe; sharing probes ride shared admissions;
    an over-long prompt is still refused."""
    from repro_torch.serve.scheduler import Request, Scheduler
    rows = Scheduler(max_len=8, pack=False)
    for rid, n in enumerate((3, 12)):
        rows.submit(Request(rid=rid, prompt=np.arange(n, dtype=np.int32)))
    (adm,) = rows.next_admissions(2, probe=lambda r: 8)
    assert [r.rid for r in adm.requests] == [0, 1]
    assert adm.row_width == 16 and adm.packed is None and not adm.chunks
    assert adm.utilization == 15 / 32
    # Sharing probes are served now: a hit rides a shared admission.
    s = Scheduler(max_len=8)
    s.submit(Request(rid=0, prompt=np.arange(3, dtype=np.int32)))
    s.submit(Request(rid=1, prompt=np.arange(12, dtype=np.int32)))
    (hit, packed) = s.next_admissions(2, probe=lambda r: 8 * r.rid)
    assert hit.shared_prefixes == [8] and hit.requests[0].rid == 1
    assert packed.packed is not None and packed.requests[0].rid == 0
    with pytest.raises(ValueError):
        Scheduler(max_len=8, max_prompt_len=4).submit(
            Request(rid=1, prompt=np.arange(5, dtype=np.int32)))


def test_dynamic_batcher_accepts_long_prompts():
    """The reference's ``test_dynamic_batcher_accepts_long_prompts``: the
    ``DynamicBatcher`` alias takes a prompt past ``max_len`` and drains it
    as one chunked batch, then None."""
    from repro_torch.serve import DynamicBatcher, Scheduler
    from repro_torch.serve.scheduler import Request
    assert DynamicBatcher is Scheduler
    b = DynamicBatcher(max_len=16)
    long_prompt = np.arange(40, dtype=np.int32)
    b.submit(Request(rid=0, prompt=long_prompt))
    batch = b.next_batch()
    assert batch["packed"] is None
    assert len(batch["chunks"]) == 3
    np.testing.assert_array_equal(np.concatenate(batch["chunks"]),
                                  long_prompt)
    assert b.next_batch() is None


@pytest.mark.parametrize("max_len,max_rows", [(16, 8), (16, 1), (32, 2)])
def test_next_batch_matches_reference(max_len, max_rows):
    """Drain-style batches of the reference's ``next_batch``: the head's
    run of short prompts packed (rows beyond ``max_rows`` handed back to
    the queue head), a long head prompt alone in chunks; batch by batch,
    with the queue left over."""
    from repro.serve import DynamicBatcher as JBatcher
    from repro.serve.scheduler import Request as JRequest
    from repro_torch.serve import DynamicBatcher
    from repro_torch.serve.scheduler import Request

    def summary(b):
        if b is None:
            return None
        body = ([tuple(s) for s in b["packed"].request_slots]
                if b["packed"] is not None
                else [c.tolist() for c in b["chunks"]])
        return [r.rid for r in b["requests"]], body, b["utilization"]

    rng = np.random.default_rng(max_len + max_rows)
    for trial in range(8):
        lengths = rng.integers(1, 3 * max_len, size=int(rng.integers(1, 20)))
        jb = JBatcher(max_len=max_len, max_rows=max_rows)
        tb = DynamicBatcher(max_len=max_len, max_rows=max_rows)
        for r in _queue(JRequest, lengths, trial):
            jb.submit(r)
        for r in _queue(Request, lengths, trial):
            tb.submit(r)
        while True:
            want, got = jb.next_batch(), tb.next_batch()
            assert summary(got) == summary(want)
            assert [r.rid for r in tb.queue] == [r.rid for r in jb.queue]
            if want is None:
                break
