"""The port's steps on ``(data, model)`` meshes of four gloo ranks on the
CPU (one spawn, ``tests/_torch_parity.py::rank_mesh_infer``, a mesh of
its own for each case), against the reference's unsharded ``Model.loss``
(its gradients), ``Model.prefill`` and ``Model.decode_step`` on the same
bridged float32 smoke params: weights placed by ``param_specs`` (FSDP over
``data``, TP over ``model``), rows over ``data``, caches by
``cache_specs`` (positions over ``model``, every head).

* qwen2.5 on ``(2, 2)``: ``launch/steps.py``'s prefill, serve and
  slot-serve steps (the heads split over ``model``);
* qwen2.5 on ``(1, 4)``: 4 / 2 heads do not split four ways, so prefill
  and training attend every head on every rank (``layers.py``'s
  ``whole``); the loss, the gradients and the prefill; decode refused with
  the reference's message;
* mamba2 and recurrentgemma on ``(2, 2)``: the recurrent blocks run whole
  on every rank of ``model`` (``Model._recurrent_whole``); the loss, the
  gradients and the prefill, and mamba2's serve and slot-serve steps;
  recurrentgemma's local attention (4 / 1 heads) refuses decode on the
  mesh with the reference's message, as the reference's does.

Limits: losses, logits and every gradient leaf within 1e-5 of ``max(1,
max |ref|)`` (f32 products summed in another order: partial sums over
``model``, rows over ``data``; measured below 1e-6), the gathered caches
within 1e-5 (``ATOL_POOL``), the slot steps' greedy tokens equal."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

RTOL = 1e-5
B = 4
# name: (arch, layers, mesh, prompt length, decode steps, train, slot)
CASES = {
    "qwen_2x2": ("qwen2.5-32b", 2, (2, 2), 8, 2, False, True),
    "qwen_1x4": ("qwen2.5-32b", 2, (1, 4), 8, 1, True, False),
    "mamba2_2x2": ("mamba2-370m", 2, (2, 2), 16, 2, True, True),
    "rgemma_2x2": ("recurrentgemma-2b", 3, (2, 2), 16, 1, True, False),
}
REFUSED = {"qwen_1x4": (2, 4, 4), "rgemma_2x2": (1, 4, 2)}  # Hkv, Hq, tp
WIDTH_EXTRA = 4


def _job(name):
    arch, layers, mesh, S, steps, train, slot = CASES[name]
    cfg, m, params = tp.jax_smoke(arch, n_layers=layers)
    rng = np.random.default_rng(7)
    c = {"arch": arch, "n_layers": layers, "mesh": mesh,
         "params": tp.to_numpy_tree(params),
         "prompt": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "width": S + WIDTH_EXTRA,
         "decode": [rng.integers(0, cfg.vocab_size, B).astype(np.int32)
                    for _ in range(steps)],
         "train": tp.train_batch(cfg, rng, B=B, S=S) if train else None,
         "slot_mask": np.array([True, False, True, True]) if slot else None,
         "refused": name in REFUSED}
    return c, m, params


def _ref(c, m, params):
    """The reference's unsharded results of case ``c`` (jitted steps)."""
    import jax
    import jax.numpy as jnp
    out = {}
    if c["train"] is not None:
        b = {k: jnp.asarray(v) for k, v in c["train"].items()}
        (_, met), g = jax.jit(jax.value_and_grad(
            lambda p: m.loss(p, b), has_aux=True))(params)
        out["loss"] = float(met["loss"])
        out["grads"] = tp.to_numpy_tree(g)
    prefill = jax.jit(m.prefill, static_argnames="max_len")
    decode = jax.jit(m.decode_step)
    prompt = {"inputs": jnp.asarray(c["prompt"])}
    S = c["prompt"].shape[1]
    logits, caches = prefill(params, prompt)
    out["prefill_logits"] = np.asarray(logits[:, -1])
    out["prefill_caches"] = tp.to_numpy_tree(caches)
    if c["refused"]:
        return out
    _, caches = prefill(params, prompt, max_len=c["width"])
    for i, tok in enumerate(c["decode"]):
        logits, caches = decode(params, {"inputs": jnp.asarray(tok[:, None])},
                                caches, jnp.int32(S + i))
        out[f"decode_{i}"] = np.asarray(logits[:, 0])
    out["decode_caches"] = tp.to_numpy_tree(caches)
    if c["slot_mask"] is not None:
        n = len(c["decode"])
        logits, caches = decode(
            params, {"inputs": jnp.asarray(c["decode"][-1][:, None])},
            caches, jnp.full((B,), S + n, jnp.int32),
            slot_mask=jnp.asarray(c["slot_mask"]))
        out["slot_tokens"] = np.asarray(jnp.argmax(logits[:, 0], -1))
        out["slot_caches"] = tp.to_numpy_tree(caches)
    return out


@functools.lru_cache(maxsize=None)
def _runs():
    """Every case: ``(reference, every rank's results)``, from one spawn,
    which runs while this process computes the reference's."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.launch.mesh import run_ranks
    jobs = {name: _job(name) for name in CASES}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, 4, tp.rank_mesh_infer,
                            {n: j[0] for n, j in jobs.items()},
                            device="cpu", backend="gloo")
        want = {name: _ref(*jobs[name]) for name in CASES}
        ranks = ranks.result()
    return {name: (want[name], [r[name] for r in ranks]) for name in CASES}


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    lim = RTOL * max(1.0, float(np.abs(want).max()))
    gap = float(np.abs(got - want).max())
    assert gap <= lim, f"{what}: {gap} > {lim}"


def _check(name):
    want, ranks = _runs()[name]
    for got in ranks:  # every rank holds the whole result
        assert sorted(got) == sorted(want) + (["refused"] if name in REFUSED
                                              else [])
        for key in want:
            if key in ("prefill_caches", "decode_caches", "slot_caches"):
                tp.assert_tree_close(got[key], want[key], tp.ATOL_POOL)
            elif key == "grads":
                g, w = tp.flat_tree(got[key]), tp.flat_tree(want[key])
                assert sorted(g) == sorted(w)
                for leaf in w:
                    _close(g[leaf], w[leaf], f"grad {leaf}")
            elif key == "slot_tokens":
                np.testing.assert_array_equal(got[key], want[key])
            else:
                _close(got[key], want[key], key)
    return ranks


def _reference_refusal(kv_heads, n_heads, n):
    from repro.kernels.tda.sharded import sharded_decode_attention
    from repro_torch.launch.mesh import AXES, MeshShape
    q = np.zeros((2, 1, n_heads, 16), np.float32)
    kv = np.zeros((2, 8, kv_heads, 16), np.float32)
    with pytest.raises(ValueError) as e:
        sharded_decode_attention(q, kv, kv, 3, mesh=MeshShape(
            {"data": 1, "model": n}, AXES))
    return str(e.value)


def test_mesh_steps_match_unsharded_reference():
    _check("qwen_2x2")


def test_unsplit_heads_attend_whole_on_mesh():
    """qwen2.5's 4 / 2 heads on a ``model`` axis of 4: every rank attends
    every head in training and prefill; decode refuses."""
    for got in _check("qwen_1x4"):
        assert got["refused"] == _reference_refusal(*REFUSED["qwen_1x4"])


@pytest.mark.parametrize("name", ["mamba2_2x2", "rgemma_2x2"])
def test_recurrent_blocks_on_mesh_match_reference(name):
    for got in _check(name):
        if name in REFUSED:
            assert got["refused"] == _reference_refusal(*REFUSED[name])
