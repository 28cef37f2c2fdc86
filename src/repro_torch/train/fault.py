"""Fault tolerance of the trainer (``repro.train.fault``), one device.

- **Hard failures** (a process or card lost): the job restarts and
  ``train.loop.train`` resumes from the last *complete* checkpoint (the
  manifest is written last and the step directory renamed atomically, so
  a torn write is invisible).
- **Soft failures** (NaN / Inf from a corrupt batch or flaky memory, loss
  spikes): the loop's guard reads the loss after the backward pass and
  before the update; a bad step is skipped with the state untouched when
  a checkpoint exists (the reference gets this from buffer donation), and
  ``max_consecutive_bad`` bad steps in a row restore the checkpoint.
- **Stragglers**: a step slower than ``step_timeout_s`` counts as bad.

Sharded training (a mesh, its collectives and their timeouts) is item
12b of the roadmap.
"""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step, restore_checkpoint)
