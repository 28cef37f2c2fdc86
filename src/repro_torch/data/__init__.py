from repro_torch.data.loader import device_batches  # noqa: F401
from repro_torch.data.synthetic import (MarkovLM, lm_batches,  # noqa: F401
                                        request_lengths)
