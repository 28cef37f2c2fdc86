"""Engine construction surface (``repro.serve.config``): one frozen config
with the reference's fields and defaults, whose :meth:`EngineConfig.validate`
holds every construction-time refusal.

The port serves greedy decoding of attention-only stacks through the
mixed-step engine (paged, unquantized lanes) or the phase-serialized one
(contiguous or paged lanes, fp or int8 ``kv_quant``); ``mixed=None``
picks the mixed step where the stack can take it, as the reference does.
Settings outside the port so far raise
:class:`~repro_torch.core.errors.UnsupportedConfigError` naming the later
slice (ROADMAP Queue 1) that brings them — never silently ignored, since
each of them changes admission or tokens. The reference's default
``prefix_share=True`` is one of them: pass ``prefix_share=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.errors import UnsupportedConfigError

RECURRENT_KINDS = frozenset({"ssd", "rglru"})

_LATER = "comes with a later slice of the port (ROADMAP Queue 1 item 7)"


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
        """Refuse what this slice does not serve; returns the model traits."""
        traits = self._model_traits(model_cfg)
        if not traits["has_attn"] or traits["recurrent"]:
            raise UnsupportedConfigError(
                "only attention-only stacks are served; recurrent layers "
                "come with a later slice (ROADMAP Queue 1 item 10)")
        if self.mixed and not traits["mixed_ok"]:
            raise UnsupportedConfigError(
                "mixed-step serving needs a paged, attention-only, "
                f"unquantized-KV stack: got paged={traits['paged']}, "
                f"recurrent={traits['recurrent']}, "
                f"kv_quant={model_cfg.kv_quant}. Drop mixed=True to use "
                "the phase-serialized engine.")
        if self.temperature > 0 or self.top_k is not None:
            raise UnsupportedConfigError(
                f"seeded sampling (temperature > 0 / top_k) {_LATER}; "
                "this slice decodes greedily")
        if self.prefix_share:
            raise UnsupportedConfigError(
                f"page-level prefix sharing {_LATER}; pass "
                "prefix_share=False (it changes admission, so it is not "
                "ignored)")
        if self.audit:
            raise UnsupportedConfigError(f"per-step invariant audits {_LATER}")
        if self.prefill_budget is not None and self.prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1 token/step, got "
                f"{self.prefill_budget}")
        return traits
