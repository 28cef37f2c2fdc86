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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.errors import UnsupportedConfigError

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

    def validate(self, model_cfg) -> dict:
        """Refuse what the port does not serve; returns the model traits."""
        traits = self._model_traits(model_cfg)
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
