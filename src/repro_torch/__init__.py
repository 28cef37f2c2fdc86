"""PyTorch/CUDA port of the T-REX serving system (``src/repro/`` is the JAX
reference it is held against).

The layout mirrors ``repro``: ``configs/``, ``core/``, ``models/``,
``kernels/tda/`` (hand-written CUDA kernels under ``kernels/csrc/``),
``serve/`` and ``launch/``. This package imports ``torch`` and numpy and
nothing of ``jax`` or ``repro``.

Entry points (:class:`~repro_torch.models.transformer.Model`, the serving
:class:`~repro_torch.serve.engine.Engine` built on it, and
``python -m repro_torch.launch.serve``) run on the CUDA device unless the
caller passes ``device="cpu"``; with no CUDA device and no explicit CPU
request they raise.
"""
