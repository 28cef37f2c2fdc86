"""A configuration's architecture: the modules that describe it, named by
its file.

A configuration file of ``bench/configs/`` may name an architecture module
under ``"arch"`` (a ``.py`` path relative to the checkout, such as
``"bench/arch/dense.py"``); without the key it is the dense decoder's,
:data:`DENSE`. The module provides

* ``spec_from_dict(conf)``: the spec, an object with at least ``name``,
  ``vocab``, ``layers``, ``param_dtype``, ``compute_dtype`` and
  ``factorized`` (a factorized spec also ``value_bits``, and ``linears()``
  for the DMM/SMM roofline), whose class the module defines: the harness
  tells from a spec's class which module made it (:func:`module_of`);
* ``leaf_specs(spec)``: the program's parameter layout as
  ``bench/lib/weights.py``'s ``Leaf`` records, drawn by its per-``(seed,
  path, layer)`` generators;
* ``program_config(spec)``: the program's ``ModelConfig`` as a plain dict
  of its fields, nested configs as nested dicts (``bench/lib/program.py``
  builds it);
* ``step_work(spec, kind, lengths, n_new)``: one step's useful work, the
  keys of ``bench/lib/counts.py``'s ``step_work``.

The file's ``"reference"`` names the plain reference, a module with
``Weights(spec, seed, device)`` and ``logits_at(spec, weights, seqs,
quants)`` (``bench/lib/check.py``). Neither module imports the program.
"""
from __future__ import annotations

import importlib
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

from bench.lib.modelspec import ModelSpec

__all__ = ["DENSE", "DENSE_REFERENCE", "load_module", "module_of",
           "spec_from_dict"]

DENSE = "bench/arch/dense.py"
DENSE_REFERENCE = "bench/reference/decoder.py"

_INTERFACE = ("spec_from_dict", "leaf_specs", "program_config", "step_work")
_SPEC_KEYS = ("name", "vocab", "layers", "param_dtype", "compute_dtype",
              "factorized")


def load_module(rel: str) -> ModuleType:
    """The module of ``rel``, a ``.py`` path relative to the checkout,
    imported by its dotted name (``bench/arch/dense.py`` ->
    ``bench.arch.dense``)."""
    parts = Path(rel).with_suffix("").parts
    if Path(rel).suffix != ".py" or Path(rel).is_absolute() \
            or not all(p.isidentifier() for p in parts):
        raise ValueError(f"{rel!r} is not the path of a module in the "
                         "checkout (letters, digits and _, ending in .py)")
    return importlib.import_module(".".join(parts))


def module_of(spec) -> ModuleType:
    """The architecture module that made ``spec``: the one that defines its
    class (the dense decoder's for ``bench/lib/modelspec.py``'s
    ``ModelSpec``)."""
    if type(spec) is ModelSpec:
        return load_module(DENSE)
    return sys.modules[type(spec).__module__]


def spec_from_dict(conf: Dict):
    """The spec of a configuration, made by its architecture module."""
    mod = load_module(conf.get("arch", DENSE))
    missing = [f for f in _INTERFACE if not hasattr(mod, f)]
    if missing:
        raise ValueError(f"{mod.__name__} lacks {missing}")
    spec = mod.spec_from_dict(conf)
    missing = [k for k in _SPEC_KEYS if not hasattr(spec, k)]
    if missing or module_of(spec) is not mod:
        raise ValueError(f"{mod.__name__}: its spec lacks {missing} or is "
                         "of a class another module defines")
    return spec
