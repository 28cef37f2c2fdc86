from repro_torch.optim.adamw import (OptConfig, apply_updates,  # noqa: F401
                                     init_opt_state, lr_at)
