"""Training on the port (mirrors ``repro.train``)."""
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update, cosine_lr
from repro_torch.train.step import TrainState, init_train_state, make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr", "TrainState",
           "init_train_state", "make_train_step"]
