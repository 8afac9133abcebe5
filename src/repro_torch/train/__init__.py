from repro_torch.train.data import synthetic_lm_batch, synthetic_lm_batches
from repro_torch.train.train_step import (TrainConfig, init_optimizer,
                                          make_train_step)

__all__ = ["TrainConfig", "make_train_step", "init_optimizer",
           "synthetic_lm_batch", "synthetic_lm_batches"]
