from repro_torch.train.loop import Trainer, TrainResult
from repro_torch.train.step import (init_state, load_state, make_train_step,
                                    state_tree)

__all__ = ["TrainResult", "Trainer", "init_state", "load_state",
           "make_train_step", "state_tree"]
