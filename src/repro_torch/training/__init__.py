from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.data import MarkovCorpus, data_iterator
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state, lr_at)
from repro_torch.training.train_loop import Trainer, lm_loss, make_train_step

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "lr_at",
           "Trainer", "lm_loss", "make_train_step", "MarkovCorpus",
           "data_iterator", "save_checkpoint", "load_checkpoint"]
