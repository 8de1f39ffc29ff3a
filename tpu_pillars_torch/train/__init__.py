"""Training: state and optimizer, the step, full and inference
checkpoints, EMA, the elastic hooks, and the synthetic-data loop
(``python -m tpu_pillars_torch.train.loop``)."""

from tpu_pillars_torch.train.step import (
    TrainBatch, make_eval_forward, make_train_step,
)

__all__ = ["TrainBatch", "make_train_step", "make_eval_forward"]
