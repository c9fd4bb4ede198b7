"""Training: AdamW with gradient compression (``optimizer``) and the train
step (``train_step``), the reference's ``repro.train``.  Serving lives in
``repro_torch.serve``."""
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_init, adamw_update,
                                         compress_tree, global_norm,
                                         lr_schedule, zero_residuals)
from repro_torch.train.train_step import (TrainConfig, TrainState,
                                          cross_entropy, init_train_state,
                                          make_loss_fn, make_train_step)

__all__ = ["AdamWConfig", "AdamWState", "TrainConfig", "TrainState",
           "adamw_init", "adamw_update", "compress_tree", "cross_entropy",
           "global_norm", "init_train_state", "lr_schedule",
           "make_loss_fn", "make_train_step", "zero_residuals"]
