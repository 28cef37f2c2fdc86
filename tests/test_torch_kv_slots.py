"""The slot table's lane copies (``SlotKVCache.assign_many``): contiguous
lanes and page pools, fp and int8 (codes with their scale leaves), against
the reference's ``SlotKVCache`` on the same schedule — byte-equal caches
and the same block tables."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

NUM_SLOTS, CACHE_LEN, ROWS, WIDTH = 5, 40, 3, 32


@pytest.fixture(scope="module")
def models():
    from repro.configs import get_config as jcfg
    from repro.models.transformer import Model as JModel
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    return {q: (JModel(jcfg("qwen2.5-32b", "smoke", dtype="float32",
                            kv_quant=q)),
                Model(get_config("qwen2.5-32b", "smoke", dtype="float32",
                                 kv_quant=q), device="cpu"))
            for q in (False, True)}


def _source(rng, tmodel):
    """A prefill cache of ROWS x WIDTH with random contents, as numpy."""
    out = {}
    for name, leaf in tmodel.init_cache(ROWS, WIDTH).items():
        if leaf.dtype == torch.int8:
            out[name] = rng.integers(-127, 128, size=leaf.shape).astype(
                np.int8)
        else:
            out[name] = rng.standard_normal(leaf.shape).astype(np.float32)
    return out


# Two admission rounds: three lanes from packed rows (padded to a round of
# four), then — after slot 1 is released — a chunked prompt into slot 1
# (overwriting its lane) and a full-width segment.
ROUND1 = [(3, "a", 0, 0, 5), (1, "b", 0, 5, 9), (0, "c", 2, 4, 28)]
ROUND2 = [(1, "d", 1, 0, 32), (4, "e", 2, 30, 2)]


@pytest.mark.parametrize("page_size", [None, 8])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_assign_many_matches_reference(models, kv_quant, page_size):
    import jax.numpy as jnp
    from repro.serve.kv_slots import SlotKVCache as JSlots
    from repro_torch.serve.kv_slots import SlotKVCache
    jm, tm = models[kv_quant]
    js = JSlots(jm, NUM_SLOTS, CACHE_LEN, page_size=page_size)
    ts = SlotKVCache(tm, NUM_SLOTS, CACHE_LEN, page_size=page_size)
    assert set(ts.caches) == set(js.caches) == set(ts.specs)
    if page_size:
        js.pool.shuffle_free(np.random.default_rng(7))
        ts.pool.shuffle_free(np.random.default_rng(7))
    rng = np.random.default_rng(int(kv_quant) + 2 * bool(page_size))
    for rnd in (ROUND1, ROUND2):
        if rnd is ROUND2:
            js.release(1)
            ts.release(1)
        src = _source(rng, tm)
        js.assign_many(rnd, {k: jnp.asarray(v) for k, v in src.items()})
        ts.assign_many(rnd, {k: tp.t(v) for k, v in src.items()})
        for name in js.caches:
            got, want = ts.caches[name].numpy(), np.asarray(js.caches[name])
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(ts.lengths, js.lengths)
        np.testing.assert_array_equal(ts.active, js.active)
        assert ts.request == js.request
        if page_size:
            for w, c in js.pool.classes.items():
                np.testing.assert_array_equal(ts.pool.classes[w].table,
                                              c.table)
            ts.pool.check_invariants()


def test_assign_many_refusals_and_rollback(models):
    from repro_torch.core.errors import UnsupportedConfigError
    from repro_torch.serve.kv_slots import SlotKVCache
    _, tm = models[False]
    src = {k: tp.t(v) for k, v in _source(np.random.default_rng(0),
                                          tm).items()}
    ts = SlotKVCache(tm, NUM_SLOTS, CACHE_LEN)
    with pytest.raises(UnsupportedConfigError):
        ts.assign_many([(0, "a", 0, 0, 4, 2)], src)  # offset: sharing
    with pytest.raises(ValueError):
        ts.assign_many([(0, "a", 0, 0, 4), (0, "b", 1, 0, 4)], src)
    with pytest.raises(ValueError):
        ts.assign_many([(0, "a", 0, 0, CACHE_LEN + 1)], src)
    ts.assign(2, "a", src, 1, 3, 4)  # one lane: assign_many of one
    assert ts.active[2] and ts.lengths[2] == 4 and ts.request[2] == "a"
    for name, leaf in ts.caches.items():
        torch.testing.assert_close(leaf[:, 2, :4], src[name][:, 1, 3:7],
                                   rtol=0, atol=0)
        assert not leaf[:, 2, 4:].any()
    with pytest.raises(ValueError):
        ts.assign_many([(2, "b", 0, 0, 4)], src)
    # a pool too small for the round rolls every lane of it back
    small = SlotKVCache(tm, NUM_SLOTS, CACHE_LEN, page_size=8, page_cap=6)
    with pytest.raises(RuntimeError):
        small.assign_many([(0, "a", 0, 0, 20), (1, "b", 1, 0, 30)], src)
    assert small.pool.pages_in_use() == 0 and not small.active.any()
    small.pool.check_invariants()
