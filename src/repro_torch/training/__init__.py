"""Training substrate: optimizer, loss, gradient-sync config, train step
factory (port of ``repro/training``)."""
from repro_torch.training.grad_sync import PartialSyncConfig
from repro_torch.training.loss import lm_loss
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)
from repro_torch.training.train_step import TrainStepConfig, make_train_step

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "lm_loss",
    "TrainStepConfig",
    "make_train_step",
    "PartialSyncConfig",
]
