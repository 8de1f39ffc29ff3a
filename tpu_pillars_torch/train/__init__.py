"""Training: state and optimizer, the step, full and inference
checkpoints, EMA, the elastic hooks, and the synthetic-data loop
(``python -m tpu_pillars_torch.train.loop``)."""
