"""The composable model (``repro.models.transformer``): embeds -> block
stack -> norm -> logits, for every architecture of the registry and the
paper's encoders (bert, vit: ``causal=False``, learned positions); the
paper's encoder-decoders are ``models/paper_models.py``'s ``EncDecModel``:

* attention stacks (RMSNorm or LayerNorm; full or sliding-window
  attention) whose FFN is dense (SwiGLU, GeGLU or GELU) or routed (the MoE
  family, dbrx-132b and arctic-480b, with arctic's parallel dense FFN,
  ``models/moe.py``);
* recurrent stacks: mamba2-370m (SSD blocks, ``models/ssd.py``, no
  attention) and recurrentgemma-2b (``rglru, rglru, local`` blocks:
  ``models/rglru.py`` and local attention of ``local_window``);
* external embeddings (``batch["embeds"]`` instead of token ids: llava,
  musicgen) and musicgen's multi-codebook head ``(B, S, C, V)``.

The reference's ``lax.scan`` over layers is a Python loop here. Parameters
are nested dicts of tensors in the reference's layout: a uniform stack
(every layer of one block kind) carries a leading L axis on
``params["layers"]`` and on its caches; a heterogeneous one
(recurrentgemma) keeps ``params["layers"]["layer_XX"]`` and caches ``{
"layer_XX": {...}}`` per layer, and its paged ``pages`` argument is
``{layer_name: entry-or-None}`` (``None`` on recurrent layers).
Factorized models add the shared ``params["dicts"]``. So
``models/bridge.py`` can hand over a reference ``Model.init`` or
``compress_params`` tree unchanged. ``Model.init`` draws its own weights
from a ``torch.Generator``; they cannot match the reference's numbers, so
every parity test uses bridged parameters.

**Tensor parallelism.** Every step (:meth:`Model.hidden`,
:meth:`Model.prefill`, :meth:`Model.decode_step`, :meth:`Model.mixed_step`,
:meth:`Model.logits`) takes ``mesh=``, one rank's
:class:`~repro_torch.launch.mesh.Mesh`; :meth:`Model.prepare` cuts that
rank's slice of the weights (``launch/sharding.py``) and
:meth:`Model.init_cache` gives lanes of its ``Hkv / N`` kv heads. The
attention stacks serve on a ``(1, N)`` mesh; a recurrent block refuses one
(its head counts do not split).

**On a ``(data, model)`` or ``(pod, data, model)`` mesh** (the train
step's and the steps of ``launch/steps.py``) :meth:`Model.loss`,
:meth:`Model.hidden`, :meth:`Model.prefill` and :meth:`Model.decode_step`
take ``specs=``, the placement of the whole tree
(``launch.sharding.param_specs``): ``params`` are the rank's slices and
``batch`` its rows; each layer gathers its FSDP-cut leaves inside its body.
Prefill and decode caches are then placed as the reference places them
(``launch.sharding.cache_specs``: rows over the data-parallel axes,
positions over ``model``, every head; :meth:`Model.init_cache` with
``specs=``). A recurrent block there runs whole on every rank of the
``model`` axis: the leaves ``model`` cuts (and its cut cache leaves) are
gathered for it, and the rank keeps its block of the new state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.checkpoint import checkpoint

from repro_torch.core import sparsity
from repro_torch.core.errors import UnsupportedConfigError
from repro_torch.core.factorized import (DictionaryBank, FactorizationConfig,
                                        compress_model_params)
from repro_torch.core.tree import (tree_at, tree_leaves, tree_map,
                                   tree_map_paths)
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import (fsdp_gather, gather_from, reduce_from,
                                     tensor_parallel_size)
from repro_torch.launch.sharding import (dp_axes, fsdp_dim, full_shape,
                                         grad_reduce_axes, param_specs,
                                         shard_params, spec_axes)
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssd as SSD
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import init_moe, moe_ffn

__all__ = ["Model", "check_supported", "factorization_regularizer",
           "gather_fsdp"]

BLOCK_KINDS = ("attn", "local", "ssd", "rglru")


def check_supported(cfg: ModelConfig) -> None:
    """Refuse what this model does not run: an encoder-decoder (the
    paper's mt and s2t run through ``models/paper_models.py``'s
    ``EncDecModel``) and blocks it does not know."""
    if cfg.n_encoder_layers:
        raise UnsupportedConfigError(
            f"{cfg.name}: an encoder-decoder (n_encoder_layers="
            f"{cfg.n_encoder_layers}) runs through "
            "repro_torch.models.paper_models.EncDecModel, not Model "
            "(ROADMAP Queue 1 item 12c)")
    kinds = {cfg.block_kind(i) for i in range(cfg.n_layers)}
    if kinds - set(BLOCK_KINDS) or cfg.act not in ("swiglu", "geglu", "gelu") \
            or cfg.norm not in ("rmsnorm", "layernorm") \
            or ("ssd" in kinds and cfg.ssm is None) \
            or ("rglru" in kinds and cfg.rglru is None):
        raise UnsupportedConfigError(
            f"{cfg.name}: unknown block (kinds={sorted(kinds)}, "
            f"act={cfg.act!r}, norm={cfg.norm!r})")


def factorization_regularizer(params: Dict, fcfg: FactorizationConfig,
                              mesh=None, specs=None) -> torch.Tensor:
    """Sum of :func:`~repro_torch.core.sparsity.out_of_support_l1` over
    every matrix of every W_D leaf (any leading dims: layers, experts).

    On a mesh (``params`` this rank's slices, ``specs`` their placement)
    each rank sums the out-of-support mass of the entries it holds, each
    column's support taken over the whole column (its rows gathered over
    ``model`` when that axis cut the rank axis ``r``), over the whole
    matrix's entry count. The sum over the mesh goes through ``g``: over
    ``model`` for a leaf it cuts, over every data-parallel axis for every
    leaf, a leaf's share divided by the number of data-parallel copies of
    it (whose gradients the train step adds up). Every rank holds the
    whole sum."""
    if mesh is not None and mesh.size > 1:
        return _sharded_regularizer(params, fcfg, mesh, specs)
    total = 0.0
    for path, leaf in tree_leaves(params):
        if path[-1] != "wd":
            continue
        r, d_out = leaf.shape[-2], leaf.shape[-1]
        nnz = fcfg.nnz_for(r)
        per = torch.stack([sparsity.out_of_support_l1(w, nnz)
                           for w in leaf.reshape(-1, r, d_out)])
        total = total + per.sum()
    return total if torch.is_tensor(total) else torch.zeros(())


def _sharded_regularizer(params: Dict, fcfg: FactorizationConfig, mesh,
                         specs) -> torch.Tensor:
    dev = mesh.device
    by_model = torch.zeros((), device=dev)
    rest = torch.zeros((), device=dev)
    for path, leaf in tree_leaves(params):
        if path[-1] != "wd":
            continue
        spec = tree_at(specs, path)
        full = full_shape(leaf.shape, spec, mesh)
        r, d_out = full[-2], full[-1]
        nnz = fcfg.nnz_for(r)
        cut_r = "model" in spec_axes(spec[-2])
        mats = leaf.reshape(-1, leaf.shape[-2], leaf.shape[-1])
        whole = mesh.gather(mats.detach(), -2, "model") if cut_r \
            else mats.detach()
        keep = torch.stack([sparsity.topk_column_mask(w, nnz)
                            for w in whole])
        if cut_r:
            keep = mesh.block(keep, -2)
        share = torch.where(keep, 0.0, mats).abs().sum() / (r * d_out)
        copies = math.prod(mesh.n(a) for a in grad_reduce_axes(spec, mesh))
        if cut_r:
            by_model = by_model + share / copies
        else:
            rest = rest + share / copies
    total = rest + reduce_from(by_model, mesh, "model")
    for a in dp_axes(mesh):
        total = reduce_from(total, mesh, a)
    return total


def shape_mode():
    """A context in which new tensors are fake (shapes, dtypes and
    devices, no storage): the active ``FakeTensorMode``, or a new one."""
    if detect_fake_mode() is not None:
        return contextlib.nullcontext()
    return FakeTensorMode()


def _gather_model(tree: Dict, specs: Dict, mesh) -> Dict:
    """``tree`` with every dim that ``specs`` cuts over ``model`` gathered
    (``gather_from``: all-gather forward, the rank's block backward)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _gather_model(v, specs[k], mesh)
            continue
        for dim, e in enumerate(specs[k]):
            if "model" in spec_axes(e):
                v = gather_from(v, mesh, dim, "model")
        out[k] = v
    return out


def gather_fsdp(tree: Dict, specs: Dict, mesh, path=()) -> Dict:
    """``tree`` with every leaf that ``specs`` cuts over ``data`` (FSDP;
    not an expert leaf, :func:`~repro_torch.launch.sharding.fsdp_dim`)
    gathered over it through ``fsdp_gather`` (all-gather forward,
    reduce-scatter backward); other leaves as they are."""
    if mesh is None or mesh.n("data") == 1:
        return tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = gather_fsdp(v, specs[k], mesh, path + (k,))
            continue
        dim = fsdp_dim(path + (k,), specs[k])
        out[k] = v if dim is None else fsdp_gather(v, mesh, dim, "data")
    return out


_CAST_KEYS = ("w", "wd", "b")  # linear leaves used in the compute dtype


class Model:
    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None):
        if cfg.weight_format not in ("dense", "compressed"):
            raise ValueError(
                f"weight_format must be 'dense' or 'compressed', "
                f"got {cfg.weight_format!r}")
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def with_weight_format(self, fmt: str) -> "Model":
        """Same model, another weight representation (``dense`` /
        ``compressed``). The forward pass dispatches per leaf, so this is
        metadata the engine reports in ``decode_stats``."""
        if fmt == self.cfg.weight_format:
            return self
        return Model(dataclasses.replace(self.cfg, weight_format=fmt),
                     self.device)

    def compress_params(self, params: Dict, value_bits: int = 6):
        """Factorized params -> the T-REX streaming format, on the params'
        device. Returns ``(model, cparams, stats)``: a
        ``weight_format="compressed"`` model, the compressed tree and the
        stream-bits accounting of
        :func:`repro_torch.core.factorized.compress_model_params` (feed
        ``stats["weight_stream_bits"]`` to the engine's
        ``weight_stream_bits``)."""
        cparams, stats = compress_model_params(
            params, self.cfg.factorization, value_bits=value_bits)
        return self.with_weight_format("compressed"), cparams, stats

    def with_decode_attn(self, mode: str,
                         block_k: Optional[int] = None) -> "Model":
        """Same model, another decode-attention impl (``dense``/``tda``/
        ``auto``) and optional predication-block size."""
        block_k = block_k or self.cfg.decode_block_k
        if mode == self.cfg.decode_attn and block_k == self.cfg.decode_block_k:
            return self
        return Model(dataclasses.replace(self.cfg, decode_attn=mode,
                                         decode_block_k=block_k),
                     self.device)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------

    def _init_block(self, g: torch.Generator, kind: str,
                     bank: Optional[DictionaryBank], lead=()) -> Dict:
        """One block's params (``lead``: the L axis of a uniform stack):
        ``norm1`` and the mixer; ``norm2`` and the FFN (dense, or routed
        experts plus arctic's dense FFN) after attention and RG-LRU
        mixers; an SSD block has neither ``norm2`` nor FFN."""
        cfg = self.cfg
        p: Dict[str, Any] = {"norm1": L.init_norm(cfg, lead, self.device)}
        if kind in ("attn", "local"):
            p["attn"] = L.init_attention(g, cfg, bank, lead=lead)
        elif kind == "ssd":
            p["ssd"] = SSD.init_ssd(g, cfg, bank, lead=lead)
            return p
        else:
            p["rglru"] = R.init_rglru(g, cfg, bank, lead=lead)
        p["norm2"] = L.init_norm(cfg, lead, self.device)
        if cfg.moe is None or kind == "rglru":
            p["ffn"] = L.init_ffn(g, cfg, bank, lead=lead)
        else:
            p["moe"] = init_moe(g, cfg, bank, lead=lead)
            if cfg.moe.dense_residual:
                p["dense_ffn"] = L.init_ffn(
                    g, cfg, bank, lead=lead, prefix="densefn",
                    d_ff=cfg.moe.d_ff_dense)
        return p

    def init(self, seed: int = 0) -> Dict:
        """Random parameters in the reference's layout and distributions
        (``w ~ N(0, 1/d_in)``; factorized: dictionaries ``N(0, 1/d_in)``
        under ``params["dicts"]`` and per-layer ``wd ~ N(0, 1/r)``; zero
        biases, unit norm scales (LayerNorm: zero norm biases), embeddings
        ``N(0, 0.02^2)`` (none with external embeddings), head ``N(0,
        1/d)``; the recurrent blocks' own draws in ``models/ssd.py`` and
        ``models/rglru.py``), drawn on ``self.device`` from a
        ``torch.Generator`` seeded with ``seed``. A uniform stack's layers
        share a leading L axis; a heterogeneous one has
        ``params["layers"]["layer_XX"]``."""
        cfg = self.cfg
        g = torch.Generator(device=self.device).manual_seed(seed)
        bank = DictionaryBank(cfg.factorization, cfg.params_dtype) \
            if cfg.factorization.enabled else None
        if cfg.uniform_layers:
            layers = self._init_block(g, cfg.block_kind(0), bank,
                                      lead=(cfg.n_layers,))
        else:
            layers = {f"layer_{i:02d}": self._init_block(
                g, cfg.block_kind(i), bank) for i in range(cfg.n_layers)}
        params: Dict[str, Any] = {
            "embed": L.init_embedding(g, cfg),
            "layers": layers,
            "final_norm": L.init_norm(cfg, (), self.device),
            "lm_head": L.init_lm_head(g, cfg),
        }
        if bank is not None:
            params["dicts"] = bank.dicts
        return params

    def param_shapes(self, seed: int = 0) -> Dict:
        """:meth:`init`'s tree as fake tensors (``FakeTensorMode``): each
        leaf's shape, dtype and device, no storage (the reference's
        ``jax.eval_shape`` of ``init``). Under an active fake mode the
        leaves are that mode's."""
        with shape_mode():
            return self.init(seed)

    def prepare(self, params: Dict, mesh=None) -> Dict:
        """Serving copy of ``params`` on the model's device — on a
        tensor-parallel ``mesh``, of this rank's slice of them
        (:func:`~repro_torch.launch.sharding.shard_params` over
        :func:`~repro_torch.launch.sharding.param_specs`, cut before it is
        moved: a tree on the host, even memory-mapped, sends only the
        slice to the card). The layers' dense ``w``, factorized
        ``wd`` and biases, the raw dictionaries and the token embedding in
        the compute dtype, made once here instead of on every step.
        Compressed streams, nibble-packed codes and LUTs stay as they are.
        At float32 this changes nothing. At bf16 compute over f32 params
        the port then multiplies in bf16, where the reference's dense and
        factorized ``apply_linear`` multiplies the bf16 activation by the
        f32 weight as an f32 product (and casts the result to bf16): those
        outputs differ from the reference's by that rounding (the MoE
        experts' ``einsum`` casts its weights to the compute dtype, as
        here). Norm scales, the MoE router, the recurrent blocks' own
        leaves (conv taps, decays, gates: the reference computes them in
        f32) and the LM head stay as they are: the reference computes
        norms, routing, recurrences and logits in f32."""
        dt = self.cfg.compute_dtype
        if tensor_parallel_size(mesh) > 1:
            params = shard_params(params, param_specs(params, mesh), mesh)
        params = tree_map(
            lambda t: t.to(self.device).contiguous(), params)

        def cast(node):
            return {k: (cast(v) if isinstance(v, dict)
                        else v.to(dt) if k in _CAST_KEYS else v)
                    for k, v in node.items()}

        out = dict(params)
        out["layers"] = cast(params["layers"])
        if "dicts" in params:
            out["dicts"] = {f: (e if isinstance(e, dict) else e.to(dt))
                            for f, e in params["dicts"].items()}
        if not self.cfg.tie_embeddings and "tok" in params["embed"]:
            out["embed"] = dict(params["embed"],
                                tok=params["embed"]["tok"].to(dt))
        return out

    # ------------------------------------------------------------------
    # caches / steps
    # ------------------------------------------------------------------

    def _block_ring(self, kind: str, max_len: int, ring: bool = True) -> int:
        """Sequence capacity of one attention lane: the window (the
        ``local`` kind's ``local_window``, else ``sliding_window``) clamps
        it to a ring of ``min(window, max_len)`` positions unless
        ``ring=False`` (full-length caches: the engine's prefill, whose
        lane gather must address every row position)."""
        cfg = self.cfg
        window = cfg.local_window if kind == "local" else cfg.sliding_window
        if window is None or not ring:
            return max_len
        return min(window, max_len)

    def _window(self, kind: str) -> Optional[int]:
        return self.cfg.local_window if kind == "local" \
            else self.cfg.sliding_window

    def _block_cache(self, kind: str, batch: int, max_len: int, ring: bool,
                     lead=(), tp: int = 1) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if kind == "ssd":
            return SSD.init_ssd_cache(cfg, batch, lead, self.device)
        if kind == "rglru":
            return R.init_rglru_cache(cfg, batch, lead, self.device)
        shape = tuple(lead) + (batch, self._block_ring(kind, max_len, ring),
                               cfg.kv_heads // tp, cfg.head_dim)

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=self.device)

        if cfg.kv_quant:
            return {"k": zeros(shape, torch.int8),
                    "v": zeros(shape, torch.int8),
                    "k_scale": zeros(shape[:-1], torch.float32),
                    "v_scale": zeros(shape[:-1], torch.float32)}
        return {"k": zeros(shape, cfg.compute_dtype),
                "v": zeros(shape, cfg.compute_dtype)}

    def init_cache(self, batch: int, max_len: int, ring: bool = True,
                   mesh=None, specs: Optional[Dict] = None
                   ) -> Dict[str, Any]:
        """Zero caches for ``batch`` rows. Attention leaves are contiguous
        lanes ``(batch, width, Hkv, D)`` in the compute dtype, or, with
        ``kv_quant``, int8 codes plus f32 ``k_scale``/``v_scale`` ``(batch,
        width, Hkv)``; ``width`` is :meth:`_block_ring` of ``max_len`` (the
        ring of a windowed layer with ``ring=True``). Recurrent leaves are
        fixed-shape states (``models/ssd.py``, ``models/rglru.py``). A
        uniform stack's leaves carry a leading L axis; a heterogeneous
        stack's caches are ``{"layer_XX": {...}}``. (The page pools of the
        slot table are shaped from these leaves.) On a tensor-parallel
        ``mesh`` the attention leaves hold this rank's ``Hkv / N`` heads
        (``launch.sharding.slot_cache_specs``). With ``specs`` (the
        ``launch.sharding.cache_specs`` of the whole cache on ``mesh``,
        ``batch`` this rank's rows) every leaf holds every head and this
        rank's block of each dim that ``specs`` cuts over ``model``."""
        cfg = self.cfg
        if specs is not None:
            n = tensor_parallel_size(mesh)
            with shape_mode():
                whole = self.init_cache(batch, max_len, ring)

            def place(path, leaf):
                shape = tuple(d // n if "model" in spec_axes(e) else d
                              for d, e in zip(leaf.shape,
                                              tree_at(specs, path)))
                return torch.zeros(shape, dtype=leaf.dtype,
                                   device=self.device)

            return tree_map_paths(place, whole)
        tp = tensor_parallel_size(mesh)
        if cfg.uniform_layers:
            return self._block_cache(cfg.block_kind(0), batch, max_len, ring,
                                     lead=(cfg.n_layers,), tp=tp)
        return {f"layer_{i:02d}": self._block_cache(cfg.block_kind(i), batch,
                                                    max_len, ring, tp=tp)
                for i in range(cfg.n_layers)}

    def _layer_tree(self, fn) -> Dict[str, Any]:
        """``fn(kind)`` for a uniform stack, else ``{"layer_XX":
        fn(kind_i)}``: the structure of :meth:`init_cache`."""
        cfg = self.cfg
        if cfg.uniform_layers:
            return fn(cfg.block_kind(0))
        return {f"layer_{i:02d}": fn(cfg.block_kind(i))
                for i in range(cfg.n_layers)}

    def cache_lane_specs(self) -> Dict[str, Any]:
        """Per-leaf lane kinds of :meth:`init_cache`, in its structure:
        ``"kv"`` for a per-token attention lane (full, or a ring of the
        window), ``"state"`` for a fixed-shape recurrent state (SSD state,
        RG-LRU ``h``, conv taps: no sequence axis)."""
        quant = self.cfg.kv_quant

        def spec(kind):
            if kind == "ssd":
                return {"state": "state", "conv": "state"}
            if kind == "rglru":
                return {"h": "state", "conv": "state"}
            return {name: "kv" for name in (
                ("k", "v", "k_scale", "v_scale") if quant else ("k", "v"))}

        return self._layer_tree(spec)

    def cache_lane_widths(self, max_len: int) -> Dict[str, Any]:
        """:meth:`cache_lane_specs`' structure with each kv leaf's lane
        width (:meth:`_block_ring` of ``max_len``) and 0 for state
        leaves."""
        specs = self.cache_lane_specs()
        widths = self._layer_tree(lambda kind: self._block_ring(kind,
                                                                max_len))

        def fill(sp, w):
            if isinstance(sp, dict) and any(isinstance(v, dict)
                                            for v in sp.values()):
                return {k: fill(sp[k], w[k]) for k in sp}
            return {k: (w if v == "kv" else 0) for k, v in sp.items()}

        return fill(specs, widths)

    def _block(self, lp: Dict, x: torch.Tensor, *, kind: str, dicts,
               positions, cache_l, li, cache_index, pages_l, slot_mask,
               n_new, seg_ids, prefix_l, mesh, sparse_train, specs=None,
               lanes=None, cols=None):
        """One layer: ``(x, aux)``, ``aux`` the MoE load-balance loss (0.0
        for other blocks). With the layer's ``specs`` (a mesh step) its
        FSDP-cut leaves are gathered over ``data`` first, here inside the
        layer (under its checkpoint when remat is on); ``lanes``: the
        placement of its cache leaves (``launch.sharding.cache_specs``
        without the L axis); ``cols``: the mixed step's columns
        (:meth:`mixed_hidden`)."""
        cfg = self.cfg
        if specs is not None:
            lp = gather_fsdp(lp, specs, mesh)
        if kind in ("ssd", "rglru") and tensor_parallel_size(mesh) > 1:
            if specs is None:
                raise UnsupportedConfigError(
                    f"{cfg.name}: a {kind} block has no tensor-parallel "
                    "form (its head counts do not split); serve it "
                    "without a mesh")
            return self._recurrent_whole(
                _gather_model(lp, specs, mesh), x, kind=kind, dicts=dicts,
                cache_l=cache_l, li=li, slot_mask=slot_mask,
                seg_ids=seg_ids, mesh=mesh, sparse_train=sparse_train,
                lanes=lanes)
        h = L.apply_norm(lp["norm1"], x)
        if kind == "ssd":
            return x + SSD.ssd_block(lp["ssd"], h, cfg=cfg, dicts=dicts,
                                     cache=cache_l, layer_idx=li,
                                     seg_ids=seg_ids, slot_mask=slot_mask,
                                     sparse_train=sparse_train), 0.0
        if kind == "rglru":
            x = x + R.rglru_block(lp["rglru"], h, cfg=cfg, dicts=dicts,
                                  cache=cache_l, layer_idx=li,
                                  seg_ids=seg_ids, slot_mask=slot_mask,
                                  sparse_train=sparse_train)
        else:
            x = x + L.attention_block(
                lp["attn"], h, cfg=cfg, dicts=dicts, positions=positions,
                cache=cache_l, layer_idx=li, cache_index=cache_index,
                pages=pages_l, slot_mask=slot_mask, n_new=n_new, cols=cols,
                seg_ids=seg_ids, prefix_kv=prefix_l,
                window=self._window(kind), mesh=mesh,
                sparse_train=sparse_train, lanes=lanes)
        h2 = L.apply_norm(lp["norm2"], x)
        if "moe" not in lp:
            return x + L.ffn_block(lp["ffn"], h2, cfg=cfg, dicts=dicts,
                                   mesh=mesh, sparse_train=sparse_train), 0.0
        # The reference's order: the routed experts, then arctic's parallel
        # dense FFN on the same normed input.
        y, aux = moe_ffn(lp["moe"], h2, cfg=cfg, dicts=dicts, mesh=mesh,
                         sparse_train=sparse_train)
        x = x + y
        if cfg.moe.dense_residual:
            x = x + L.ffn_block(lp["dense_ffn"], h2, cfg=cfg, dicts=dicts,
                                prefix="densefn", d_ff=cfg.moe.d_ff_dense,
                                mesh=mesh, sparse_train=sparse_train)
        return x, aux

    def _recurrent_whole(self, lp, x, *, kind, dicts, cache_l, li,
                         slot_mask, seg_ids, mesh, sparse_train, lanes):
        """A recurrent block on a mesh, whole on every rank of ``model``
        (``lp`` gathered over it): the layer's cache leaves that ``lanes``
        cuts over ``model`` are gathered for it, and the rank keeps its
        block of the state the block writes."""
        one = None
        if cache_l is not None:
            def whole(name):
                t = cache_l[name] if li is None else cache_l[name][li]
                for dim, e in enumerate(lanes[name]):
                    if "model" in spec_axes(e):
                        t = mesh.gather(t, dim, "model")
                return t if li is None else t[None]

            one = {name: whole(name) for name in cache_l}
        y, aux = self._block(
            lp, x, kind=kind, dicts=dicts, positions=None, cache_l=one,
            li=None if li is None else 0, cache_index=None, pages_l=None,
            slot_mask=slot_mask, n_new=None, seg_ids=seg_ids, prefix_l=None,
            mesh=None, sparse_train=sparse_train)
        if one is not None:
            for name, t in one.items():
                t = t if li is None else t[0]
                for dim, e in enumerate(lanes[name]):
                    if "model" in spec_axes(e):
                        t = mesh.block(t, dim, "model")
                (cache_l[name] if li is None else cache_l[name][li]).copy_(t)
        return y, aux

    def _stack(self, params, x, *, positions, caches, cache_index=None,
               slot_mask=None, pages=None, n_new=None, cols=None,
               seg_ids=None, prefix_kv=None, mesh=None, sparse_train=False,
               specs=None, cache_specs=None):
        """The block stack and the final norm: ``(h, aux)``, ``aux`` the
        MoE load-balance loss summed over the layers (f32 0-d; ``0.0`` for
        a stack without routed experts). With
        ``cfg.remat != "none"``, a forward without caches under autograd
        runs each layer under ``torch.utils.checkpoint`` (its activations
        recomputed in the backward pass: memory, not values, as the
        reference's ``jax.checkpoint``). ``specs``: the placement of
        ``params["layers"]`` on a mesh; ``cache_specs``: the caches'."""
        cfg = self.cfg
        lay = params["layers"]
        if specs is not None and cfg.uniform_layers:
            specs = tree_map(lambda sp: sp[1:], specs)  # the L axis
        if cache_specs is not None and cfg.uniform_layers:
            cache_specs = tree_map(lambda sp: sp[1:], cache_specs)

        remat = cfg.remat != "none" and caches is None \
            and torch.is_grad_enabled()
        aux = 0.0
        for i in range(cfg.n_layers):
            kind = cfg.block_kind(i)
            if cfg.uniform_layers:
                lp = tree_map(lambda t: t[i], lay)
                lspecs, lanes = specs, cache_specs
                cache_l, li, pages_l = caches, i, pages
                pre = None if prefix_kv is None else {
                    "k": prefix_kv["k"][i], "v": prefix_kv["v"][i],
                    "len": prefix_kv["len"]}
            else:
                name = f"layer_{i:02d}"
                lp, li = lay[name], None
                lspecs = None if specs is None else specs[name]
                lanes = None if cache_specs is None else cache_specs[name]
                cache_l = None if caches is None else caches[name]
                pages_l = None if pages is None else pages.get(name)
                pre = None
                if prefix_kv is not None \
                        and prefix_kv["k"].get(name) is not None:
                    pre = {"k": prefix_kv["k"][name],
                           "v": prefix_kv["v"][name],
                           "len": prefix_kv["len"]}
            kw = dict(kind=kind, dicts=params.get("dicts"),
                      positions=positions, cache_l=cache_l, li=li,
                      cache_index=cache_index, pages_l=pages_l,
                      slot_mask=slot_mask, n_new=n_new, cols=cols,
                      seg_ids=seg_ids, prefix_l=pre, mesh=mesh,
                      sparse_train=sparse_train, specs=lspecs, lanes=lanes)
            if remat:
                x, aux_l = checkpoint(self._block, lp, x, use_reentrant=False,
                                      **kw)
            else:
                x, aux_l = self._block(lp, x, **kw)
            if torch.is_tensor(aux_l):
                aux = aux + aux_l
        return L.apply_norm(params["final_norm"], x), aux

    def logits(self, params: Dict, h: torch.Tensor,
               mesh=None) -> torch.Tensor:
        return L.lm_logits(params["lm_head"], params["embed"], h, self.cfg,
                           mesh)

    def _embed_in(self, params: Dict, batch: Dict, positions: torch.Tensor,
                  mesh=None) -> torch.Tensor:
        """``batch["embeds"]`` (B, S, d) cast to the compute dtype for a
        model fed external embeddings (no positions added, with
        ``learned_pos`` too: the reference's vit), else the token table's
        rows of ``batch["inputs"]``, plus the learned positions'
        rows of ``positions`` with ``learned_pos``."""
        if self.cfg.external_embeddings:
            return batch["embeds"].to(self.cfg.compute_dtype)
        return L.embed_tokens(params["embed"], batch["inputs"], self.cfg,
                              mesh, positions=positions)

    def _positions(self, batch: Dict) -> torch.Tensor:
        """``batch["positions"]``, or ``0..S-1`` on every row."""
        B, S = self._batch_shape(batch)
        pos = batch.get("positions")
        if pos is None:
            ref = batch["embeds"] if self.cfg.external_embeddings \
                else batch["inputs"]
            pos = torch.arange(S, device=ref.device)[None].expand(B, S)
        return pos.long()

    def _batch_shape(self, batch: Dict) -> Tuple[int, int]:
        ref = batch["embeds"] if self.cfg.external_embeddings \
            else batch["inputs"]
        return ref.shape[0], ref.shape[1]

    def _io(self, params: Dict, specs: Optional[Dict], mesh,
            names=("embed",)) -> Dict:
        """``params`` with the leaves ``names`` (``embed``, ``lm_head``)
        gathered over ``data`` where ``specs`` cut them (FSDP)."""
        if specs is None:
            return params
        return dict(params, **{n: gather_fsdp(params[n], specs[n], mesh, (n,))
                               for n in names})

    def _head_io(self, params: Dict, specs: Optional[Dict], mesh) -> Dict:
        """:meth:`_io` of what the logits read: the head, and the token
        table of a tied head."""
        names = ("lm_head",) + (("embed",) if self.cfg.tie_embeddings
                                else ())
        return self._io(params, specs, mesh, names)

    def cache_placement(self, batch: int, max_len: int, mesh,
                        ring: bool = True) -> Dict:
        """``launch.sharding.cache_specs`` of :meth:`init_cache` ``(batch,
        max_len, ring)`` (``batch``: every rank's rows) on ``mesh``."""
        from repro_torch.launch.sharding import cache_specs
        with shape_mode():
            shapes = self.init_cache(batch, max_len, ring)
        return cache_specs(shapes, mesh, self.cfg.uniform_layers)

    def hidden(self, params: Dict, batch: Dict, *,
               caches: Optional[Dict] = None,
               prefix_kv: Optional[Dict] = None,
               mesh=None, specs: Optional[Dict] = None,
               cache_specs: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, Any]:
        """Full-sequence forward up to the final norm: ``(h (B, S, d),
        caches)``. batch ``{"inputs": (B, S)}`` (or ``{"embeds": (B, S,
        d)}`` with external embeddings) with optional ``"positions"``
        (default ``0..S-1``) and ``"seg_ids"`` (packed or right-aligned
        rows; 0 is padding, an identity step for recurrent blocks). With
        ``caches`` (:meth:`init_cache` with at least S positions) every
        attention layer writes its K/V at positions ``[0, S)`` and every
        recurrent layer its end-of-row state, in place. ``prefix_kv``
        (suffix prefill): the post-RoPE K/V of a shared prompt prefix,
        ``{"k", "v": (L, B, Np, Hkv, D) (a heterogeneous stack: {layer:
        array or None}), "len": (B,)}``, which every attention layer
        prepends to its keys; the batch then holds only the suffix, at
        absolute ``positions``. With ``specs`` (a mesh step) ``params`` are
        the rank's slices, ``batch`` its rows and ``caches`` placed by
        ``cache_specs`` (module docstring)."""
        positions = self._positions(batch)
        x = self._embed_in(self._io(params, specs, mesh), batch, positions,
                           mesh)
        h, _ = self._stack(params, x, positions=positions,
                           caches=caches, seg_ids=batch.get("seg_ids"),
                           prefix_kv=prefix_kv, mesh=mesh,
                           specs=None if specs is None else specs["layers"],
                           cache_specs=cache_specs)
        return h, caches

    def apply(self, params: Dict, batch: Dict, *,
              caches: Optional[Dict] = None,
              prefix_kv: Optional[Dict] = None,
              mesh=None) -> Tuple[torch.Tensor, Any]:
        """:meth:`hidden` with all-position logits ``(B, S, V)`` f32
        (``(B, S, C, V)`` for a multi-codebook head). (The reference also
        returns the aux loss, which :meth:`loss` reads.)"""
        h, caches = self.hidden(params, batch, caches=caches,
                                prefix_kv=prefix_kv, mesh=mesh)
        return self.logits(params, h, mesh), caches

    def loss(self, params: Dict, batch: Dict, *,
             sparse_train: bool = False, mesh=None,
             specs: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
        """The training loss of one batch, ``(total, metrics)``: the
        chunked next-token cross-entropy of ``batch["labels"]`` (``(B, S)``,
        or ``(B, S, C)`` for a multi-codebook head; optional
        ``batch["weights"]`` (B, S)), plus ``0.01 * aux`` (the MoE
        load-balance loss summed over the layers) and, with
        ``sparse_train`` on a factorized model, ``reg_coeff`` times
        :func:`factorization_regularizer`; with ``sparse_train`` every
        factorized W_D also goes through the straight-through projection.
        ``metrics`` holds the reference's keys: ``xent``, ``aux``,
        ``sparsity_reg`` (sparse training only) and ``loss``, as f32 0-d
        tensors.

        ``params`` is the training tree (f32 masters, as ``init`` gives
        them), never :meth:`prepare`'s compute-dtype copy: gradients land
        on the tensors passed here. Each linear casts its weight to the
        compute dtype as it multiplies (at bf16 compute over f32 masters a
        bf16 product, where the reference promotes to an f32 one; see
        :meth:`prepare`).

        On a ``mesh`` of more than one rank (the train step's), ``params``
        are this rank's slices (``launch.sharding.shard_params`` over
        ``specs``, :func:`~repro_torch.launch.sharding.param_specs`) and
        ``batch`` its block over ``pod`` / ``data``. The weights are
        placed as the reference places them: TP-cut on ``model``, FSDP-cut
        on ``data`` (gathered inside each layer, and for the token table
        and the head), MoE experts cut over ``data`` (expert parallelism,
        their tokens by ``all_to_all``). The loss is the whole batch's,
        the same on every rank: the head cut over the vocabulary takes a
        vocabulary-parallel cross-entropy (no ``(B, S, V)`` logits), the
        cross-entropy is ``Σ nll / Σ weights`` over every rank's block,
        ``aux`` averages each layer's over ``pod`` / ``data`` as the
        reference's ``pmean`` does, and the regularizer sums every rank's
        entries. Every collective is differentiable (``launch/mesh.py``),
        so each rank's backward gives the whole batch's gradient for the
        weights it holds, but for a sum over the data-parallel copies of a
        replicated leaf (``launch.sharding.grad_reduce_axes``), which the
        train step adds."""
        cfg = self.cfg
        if mesh is None or mesh.size == 1:
            mesh = specs = None
        elif specs is None:
            raise ValueError("Model.loss on a mesh takes specs= (the "
                             "placement of params: launch.sharding."
                             "param_specs of the whole tree)")
        io = self._io(params, specs, mesh, ("embed", "lm_head"))
        embed, head = io["embed"], io["lm_head"]
        positions = self._positions(batch)
        x = self._embed_in(io, batch, positions, mesh)
        h, aux = self._stack(params, x, positions=positions,
                             caches=None, seg_ids=batch.get("seg_ids"),
                             sparse_train=sparse_train, mesh=mesh,
                             specs=None if mesh is None else specs["layers"])
        aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
        xe = L.chunked_xent(head, embed, h, batch["labels"], cfg,
                            batch.get("weights"), mesh=mesh)
        total = xe + 0.01 * aux
        metrics = {"xent": xe, "aux": aux}
        if sparse_train and cfg.factorization.enabled:
            reg = factorization_regularizer(params, cfg.factorization, mesh,
                                            specs)
            total = total + cfg.factorization.reg_coeff * reg
            metrics["sparsity_reg"] = reg
        metrics["loss"] = total
        return total, metrics

    def prefill(self, params: Dict, batch: Dict, *, max_len: int = 0,
                mesh=None, specs: Optional[Dict] = None,
                cache_specs: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Any]:
        """Forward that fills fresh caches of ``max(max_len, S)`` positions
        (rings of the window for a windowed layer, the prompt's last ring
        positions in canonical ring phase; recurrent layers their end
        state); returns the last position's logits and the caches. With
        ``specs`` on a mesh (``params`` the rank's slices, ``batch`` its
        rows) the caches are the rank's blocks, placed by ``cache_specs``
        (default: :meth:`cache_placement` of every rank's rows)."""
        B, S = self._batch_shape(batch)
        width = max(max_len, S)
        if specs is not None and (mesh is None or mesh.size == 1):
            mesh = specs = None
        if specs is not None:
            if cache_specs is None:
                rows = B * math.prod(mesh.n(a) for a in dp_axes(mesh))
                cache_specs = self.cache_placement(rows, width, mesh)
            caches = self.init_cache(B, width, mesh=mesh, specs=cache_specs)
        else:
            cache_specs = None
            caches = self.init_cache(B, width, mesh=mesh)
        h, caches = self.hidden(params, batch, caches=caches, mesh=mesh,
                                specs=specs, cache_specs=cache_specs)
        return self.logits(self._head_io(params, specs, mesh), h[:, -1:],
                           mesh), caches

    def decode_step(self, params: Dict, batch: Dict, caches,
                    cache_index: torch.Tensor, *,
                    slot_mask: Optional[torch.Tensor] = None,
                    pages: Optional[Dict] = None,
                    mesh=None, specs: Optional[Dict] = None,
                    cache_specs: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, Any]:
        """One-token step over contiguous lanes, or paged lanes when
        ``pages`` is given. batch ``{"inputs": (B, 1)}`` or ``{"embeds":
        (B, 1, d)}``; ``cache_index`` (B,) tokens resident per row (the new
        token is written there); ``slot_mask`` (B,) rows allowed to write
        (recurrent rows outside it keep their state); ``pages`` ``{"bt":
        (B, n) int32, "width": lane width, "page_size": int}``, or
        ``{layer_name: entry or None}`` for a heterogeneous stack. Returns
        ``(logits (B, 1, V) f32, caches)``; the caches are updated in
        place. With ``specs`` on a mesh: the rank's slices and rows, and
        contiguous caches placed by ``cache_specs`` (module docstring);
        a mesh whose ``model`` axis does not divide the head counts is
        refused with the reference's message."""
        if specs is not None and (mesh is None or mesh.size == 1):
            mesh = specs = cache_specs = None
        B, _ = self._batch_shape(batch)
        ci = cache_index.reshape(-1).to(torch.int64).expand(B)
        x = self._embed_in(self._io(params, specs, mesh), batch,
                           ci.reshape(-1, 1), mesh)
        h, _ = self._stack(params, x, positions=ci.reshape(-1, 1),
                           caches=caches, cache_index=ci,
                           slot_mask=slot_mask, pages=pages, mesh=mesh,
                           specs=None if specs is None else specs["layers"],
                           cache_specs=cache_specs)
        return self.logits(self._head_io(params, specs, mesh), h,
                           mesh), caches

    def mixed_hidden(self, params: Dict, batch: Dict, caches,
                     cache_index: torch.Tensor, n_new: torch.Tensor, *,
                     slot_mask: Optional[torch.Tensor] = None,
                     pages: Dict, mesh=None, cols: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, Any]:
        """:meth:`mixed_step` up to the final norm, over the step's
        columns laid flat: ``(h (1, N, d), caches)``, column ``i`` of ``h``
        being row ``cols["row"][i]``'s chunk column ``cols["col"][i]``.

        ``cols`` (``{"row", "col": (N,) int64, "width": S}``) names the
        columns to run, ``batch["inputs"]`` (1, N) their tokens: the
        embedding, norms, every linear, RoPE and the FFN run over those N
        alone. The engine passes a dense stack's live columns (``N = Σ
        n_new``) and takes logits at each row's last. Without ``cols`` the
        batch is :meth:`mixed_step`'s ``(B, S)`` and every column runs, in
        row-major order (``N = B * S``): a routed stack's step, whose
        experts take every column of the step together."""
        if any(self.cfg.block_kind(i) not in ("attn", "local")
               for i in range(self.cfg.n_layers)):
            raise ValueError("the mixed step takes attention-only stacks: "
                             "a recurrent block has no multi-token decode "
                             "form")
        ci = cache_index.reshape(-1).to(torch.int64)
        if cols is None:
            B, S = self._batch_shape(batch)
            grid = torch.arange(B * S, device=ci.device)
            cols = {"row": grid // S, "col": grid % S, "width": S}
            batch = {k: v.reshape((1, B * S) + v.shape[2:])
                     for k, v in batch.items()}
        positions = (ci[cols["row"]] + cols["col"])[None]
        x = self._embed_in(params, batch, positions, mesh)
        h, _ = self._stack(params, x, positions=positions, caches=caches,
                           cache_index=ci, slot_mask=slot_mask, pages=pages,
                           n_new=n_new.reshape(-1), cols=cols, mesh=mesh)
        return h, caches

    def mixed_step(self, params: Dict, batch: Dict, caches,
                   cache_index: torch.Tensor, n_new: torch.Tensor, *,
                   slot_mask: Optional[torch.Tensor] = None,
                   pages: Dict, mesh=None) -> Tuple[torch.Tensor, Any]:
        """One mixed step: up to ``S`` fresh tokens per row — prefill-chunk
        rows (``n_new > 1``), decode rows (``n_new == 1``) and inert rows
        (``n_new == 0``). batch ``{"inputs": (B, S)}`` (or ``{"embeds"}``)
        left-aligned; row b's columns ``[0, n_new[b])`` sit at
        ``[cache_index[b], cache_index[b] + n_new[b])``. Returns
        all-position logits ``(B, S, V)`` and the caches (chunk K/V
        scattered in place after attention)."""
        B, S = self._batch_shape(batch)
        h, caches = self.mixed_hidden(params, batch, caches, cache_index,
                                      n_new, slot_mask=slot_mask, pages=pages,
                                      mesh=mesh)
        y = self.logits(params, h, mesh)
        return y.reshape((B, S) + y.shape[2:]), caches
