"""Engine construction surface (``repro.serve.config``): one frozen config
with the reference's fields and defaults, whose :meth:`EngineConfig.validate`
holds every construction-time refusal.

The port serves attention stacks through the mixed-step engine (paged,
unquantized lanes) or the phase-serialized one (contiguous or paged lanes,
fp or int8 ``kv_quant``), and recurrent stacks (mamba2, recurrentgemma)
through the phase-serialized one; ``mixed=None`` picks the mixed step where
the stack can take it, as the reference does. Every field is served as the
reference serves it — greedy or seeded sampling, prefix sharing,
preemption, audits — so ``EngineConfig()`` is valid. The reference's own
refusals raise :class:`~repro_torch.core.errors.UnsupportedConfigError`,
and so do models fed external embeddings (llava, musicgen), which the
reference's Engine cannot serve either: it feeds token ids only.

On a mesh (``Engine(..., mesh=)``) the port serves the reference's
documented serving mesh, ``("data", "model")`` with ``data = 1``
(``docs/serving.md``, "Sharded decode"), and refuses what the reference
refuses there: compressed MoE experts on more than one rank, and head
counts the ``model`` axis does not divide.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.errors import UnsupportedConfigError
from repro_torch.launch.mesh import tensor_parallel_size

RECURRENT_KINDS = frozenset({"ssd", "rglru"})


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Every serving knob of :class:`~repro_torch.serve.engine.Engine`,
    with the reference's defaults."""

    # capacity / shapes
    max_len: int = 128
    max_new_tokens: int = 16
    num_slots: int = 8
    max_prompt_len: Optional[int] = None
    eos_id: Optional[int] = None
    max_rows: int = 8
    # decode attention kernel selection
    decode_attn: str = "auto"
    decode_block_k: Optional[int] = None
    # paged KV lanes + prefix sharing
    paged: bool = True
    page_size: Optional[int] = None
    pool_frac: float = 1.0
    page_cap: Optional[int] = None
    prefix_share: bool = True
    # engine-wide sampling defaults
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0
    # traffic accounting
    weight_stream_bits: Optional[float] = None
    # failure hardening
    audit: Optional[bool] = None
    max_pending: Optional[int] = None
    default_ttl_steps: Optional[int] = None
    max_preemptions_per_request: Optional[int] = None
    watchdog_patience: int = 64
    # interleaved chunked prefill
    mixed: Optional[bool] = None
    prefill_budget: Optional[int] = None

    def _model_traits(self, model_cfg) -> dict:
        kinds = {model_cfg.block_kind(i) for i in range(model_cfg.n_layers)}
        has_attn = bool(kinds & {"attn", "local"})
        recurrent = bool(kinds & RECURRENT_KINDS)
        paged = bool(self.paged) and has_attn
        return {"kinds": kinds, "has_attn": has_attn,
                "recurrent": recurrent, "paged": paged,
                "mixed_ok": (has_attn and not recurrent and paged
                             and not model_cfg.kv_quant)}

    def validate(self, model_cfg, mesh=None) -> dict:
        """Refuse what the port does not serve; returns the model traits."""
        traits = self._model_traits(model_cfg)
        if mesh is not None and mesh.shape["data"] > 1:
            raise UnsupportedConfigError(
                f"the Engine serves on a (1, N) mesh: got data="
                f"{mesh.shape['data']}. The serving mesh is ('data', "
                "'model') with data = 1 (docs/serving.md, 'Sharded "
                "decode'): K/V lanes shard over 'model' and page ownership "
                "is host metadata every rank shares; run data-parallel "
                "replicas as separate engines (serve/dispatch.py).")
        # Compressed MoE expert streams (wd_vq) cannot ride moe_ffn's
        # sharded EP/TP path, whose placement cuts the dense 'wd' leaf.
        if (mesh is not None and model_cfg.moe is not None
                and model_cfg.weight_format == "compressed"
                and mesh.size > 1):
            raise UnsupportedConfigError(
                "cannot serve compressed MoE expert weights (wd_vq "
                f"streams) on a {mesh.size}-device mesh: moe_ffn's "
                "EP/TP in_specs shard the dense 'wd' leaf, not the "
                "streaming format. Either serve without a mesh (mesh=None "
                "or a 1-device mesh), or serve dense-factorized params "
                "(skip Model.compress_params) on the mesh.")
        # Tensor-parallel decode shards the KV-head axis, so the head
        # counts must split evenly across the mesh's 'model' axis.
        tp = tensor_parallel_size(mesh)
        if tp > 1 and (model_cfg.kv_heads % tp or model_cfg.n_heads % tp):
            raise UnsupportedConfigError(
                f"cannot shard decode over a {tp}-way 'model' mesh "
                f"axis: kv_heads={model_cfg.kv_heads} / "
                f"n_heads={model_cfg.n_heads} must both be divisible by "
                "the tensor-parallel size (KV-head sharding gives each "
                "rank a whole number of heads). Use a mesh whose 'model' "
                "axis divides the head counts, or serve unsharded.")
        if model_cfg.external_embeddings:
            raise UnsupportedConfigError(
                f"{model_cfg.name}: the Engine feeds token ids only (as the "
                "reference's does); a model fed external embeddings runs "
                "through Model.prefill / decode_step with batch "
                "{'embeds': ...}")
        if self.mixed and not traits["mixed_ok"]:
            raise UnsupportedConfigError(
                "mixed-step serving needs a paged, attention-only, "
                f"unquantized-KV stack: got paged={traits['paged']}, "
                f"recurrent={traits['recurrent']}, "
                f"kv_quant={model_cfg.kv_quant}. Drop mixed=True to use "
                "the phase-serialized engine.")
        if self.prefill_budget is not None and self.prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1 token/step, got "
                f"{self.prefill_budget}")
        return traits
