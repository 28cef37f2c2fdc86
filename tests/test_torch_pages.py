"""The port's ``PagePool`` against ``repro.serve.pages.PagePool`` on seeded
schedules of ``alloc_prefix`` / ``ensure_write`` / ``make_range_writable``
/ ``release``: block tables, pages in use and the free budget must be
equal after every operation."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()


def _same(a, b):
    for w, c in b.classes.items():
        np.testing.assert_array_equal(a.classes[w].table, c.table)
        np.testing.assert_array_equal(a.classes[w].refcount, c.refcount)
        assert a.classes[w].free == c.free
    assert a.pages_in_use() == b.pages_in_use()
    assert a.free_page_budget() == b.free_page_budget()
    assert a.total_pages == b.total_pages
    assert a.memory_ratio() == b.memory_ratio()


@pytest.mark.parametrize("seed,pool_frac,page_cap", [
    (0, 1.0, None), (1, 0.5, None), (2, 1.0, 9), (3, 0.34, None)])
def test_pool_schedule_matches_reference(seed, pool_frac, page_cap):
    from repro.serve.pages import PagePool as JPool
    from repro_torch.serve.pages import PagePool
    num_slots, ps, width = 4, 8, 44
    a = PagePool([width], num_slots, ps, pool_frac=pool_frac,
                 page_cap=page_cap)
    b = JPool([width], num_slots, ps, pool_frac=pool_frac, page_cap=page_cap)
    _same(a, b)
    rng = np.random.default_rng(seed)
    lengths = np.zeros(num_slots, np.int64)
    for _ in range(120):
        slot = int(rng.integers(num_slots))
        op = rng.choice(["alloc", "write", "range", "release"],
                        p=[0.3, 0.35, 0.2, 0.15])
        if op == "alloc":
            n = int(rng.integers(1, width + 1))
            errs = []
            for pool in (a, b):
                try:
                    pool.alloc_prefix(slot, n)
                    errs.append(None)
                except RuntimeError as e:
                    errs.append(type(e))
            assert errs[0] == errs[1]
            if errs[0] is None:
                lengths[slot] = max(lengths[slot], min(n, width) - 1)
        elif op == "write":
            pos = int(lengths[slot])
            assert a.ensure_write(slot, pos) == b.ensure_write(slot, pos)
            lengths[slot] = min(pos + 1, width - 1)
        elif op == "range":
            lo = int(rng.integers(0, width))
            hi = int(rng.integers(lo, width + 1))
            errs = []
            for pool in (a, b):
                try:
                    pool.make_range_writable(slot, lo, hi)
                    errs.append(None)
                except RuntimeError as e:
                    errs.append(type(e))
            assert errs[0] == errs[1]
        else:
            a.release(slot)
            b.release(slot)
            lengths[slot] = 0
        _same(a, b)
        a.check_invariants()
        b.check_invariants()
    # The block tables reach the device as int32 with the sentinel row.
    dev = a.device_tables()[width]
    assert dev.dtype == torch.int32 and dev.shape == (num_slots + 1, 6)
    assert (dev[num_slots] == a.classes[width].FREE).all()


def test_pool_capacity_queries_match_reference():
    from repro.serve.pages import PagePool as JPool
    from repro_torch.serve.pages import PagePool
    a = PagePool([40], 3, 16, pool_frac=0.5)
    b = JPool([40], 3, 16, pool_frac=0.5)
    for n in (0, 1, 16, 17, 40, 99):
        assert a.class_needs(n) == b.class_needs(n)
        assert a.pages_needed(n) == b.pages_needed(n)
        assert a.can_alloc(n) == b.can_alloc(n)
    with pytest.raises(ValueError):
        PagePool([40], 3, 0)
    with pytest.raises(ValueError):
        PagePool([40], 3, 8, pool_frac=1.5)


def test_invariant_audit_trips():
    from repro_torch.core.errors import AuditError
    from repro_torch.serve.pages import PagePool
    pool = PagePool([32], 2, 8)
    pool.alloc_prefix(0, 20)
    pool.check_invariants()
    pool.classes[32].refcount[pool.classes[32].table[0, 0]] += 1
    with pytest.raises(AuditError, match="refcount-drift"):
        pool.check_invariants()


def test_scheduler_and_chunking_match_reference():
    from repro.core.packing import chunk_prompt as jchunk
    from repro.serve.scheduler import Request as JReq, Scheduler as JSched
    from repro_torch.core.packing import chunk_prompt
    from repro_torch.serve.scheduler import Request, Scheduler
    p = np.arange(37, dtype=np.int32)
    assert [c.tolist() for c in chunk_prompt(p, 16)] == \
        [c.tolist() for c in jchunk(p, 16)]
    a, b = Scheduler(max_prompt_len=40), JSched(max_len=16, max_prompt_len=40)
    for i, n in enumerate([5, 25, 12, 18, 3]):
        a.submit(Request(rid=i, prompt=np.ones(n, np.int32)))
        b.submit(JReq(rid=i, prompt=np.ones(n, np.int32)))
    with pytest.raises(ValueError):
        a.submit(Request(rid=9, prompt=np.ones(41, np.int32)))
    budget = {"a": 40, "b": 40}

    def reserve(key):
        def f(req):
            if len(req.prompt) > budget[key]:
                return False
            budget[key] -= len(req.prompt)
            return True
        return f

    got = [r.rid for r in a.next_mixed(4, reserve=reserve("a"))]
    ref = [r.rid for r, _ in b.next_mixed(4, reserve=reserve("b"))]
    assert got == ref
    assert [r.rid for r in a.drop_where(lambda r: r.rid == 4)] == \
        [r.rid for r in b.drop_where(lambda r: r.rid == 4)]
    assert a.pending() == b.pending()
