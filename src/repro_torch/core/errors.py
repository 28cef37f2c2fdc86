"""Structured serving/runtime errors shared across layers.

* :class:`UnsupportedConfigError` — a configuration is outside what the
  port serves (yet). Raised at construction wherever possible, with a
  message that names what to change or which later slice brings it.
* :class:`AuditError` — a runtime invariant was violated
  (``PagePool.check_invariants``), with the failing check's name.
"""
from __future__ import annotations

__all__ = ["UnsupportedConfigError", "AuditError"]


class UnsupportedConfigError(ValueError):
    """A model/engine configuration that cannot be served correctly."""


class AuditError(AssertionError):
    """A runtime invariant audit failed. ``check`` is a short stable
    identifier (e.g. ``"refcount-drift"``); ``detail`` the specifics."""

    def __init__(self, check: str, detail: str):
        self.check = check
        self.detail = detail
        super().__init__(f"[audit:{check}] {detail}")
