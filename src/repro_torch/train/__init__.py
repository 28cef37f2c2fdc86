from repro_torch.train.loop import (TrainLoopConfig,  # noqa: F401
                                    make_project_fn, train)
