from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    async_save, cleanup_old, latest_step, restore_checkpoint,
    save_checkpoint, wait_pending)
