"""Training core of the port: AdamW and the fault-tolerant train loop."""
from .loop import TrainConfig, make_train_step, run, value_and_grad
from .optimizer import (AdamWConfig, AdamWState, adamw_update, global_norm,
                        init_adamw, schedule)

__all__ = ["AdamWConfig", "AdamWState", "TrainConfig", "adamw_update",
           "global_norm", "init_adamw", "make_train_step", "run", "schedule",
           "value_and_grad"]
