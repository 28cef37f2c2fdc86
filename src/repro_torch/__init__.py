"""PyTorch/CUDA port of the T-REX serving system (``src/repro/`` is the JAX
reference it is held against).

The layout mirrors ``repro``: ``configs/``, ``core/``, ``models/``,
``kernels/`` (hand-written CUDA kernels under ``kernels/csrc/``),
``serve/``, ``data/``, ``optim/``, ``checkpoint/``, ``train/`` and
``launch/``. This package imports ``torch`` and numpy and nothing of
``jax`` or ``repro``.

Entry points (:class:`~repro_torch.models.transformer.Model`, the paper's
encoder-decoder :class:`~repro_torch.models.paper_models.EncDecModel`,
the serving :class:`~repro_torch.serve.engine.Engine` built on
``Model``, the trainer :func:`~repro_torch.train.loop.train`, ``python
-m repro_torch.launch.serve`` and ``python -m repro_torch.launch.train``)
run on the CUDA device unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise. ``python -m
repro_torch.launch.paper_tables`` is host-side arithmetic (the T-REX chip
model of ``core/ema.py``).
"""
