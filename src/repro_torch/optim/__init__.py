from repro_torch.optim.adamw import (OptConfig, apply_updates,  # noqa: F401
                                     init_opt_state, lr_at)
from repro_torch.optim.grad_comp import (  # noqa: F401
    compress_pod_allreduce, init_ef_state)
