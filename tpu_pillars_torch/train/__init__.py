"""Training: state and optimizer, the step, inference checkpoints, and the
synthetic-data loop (``python -m tpu_pillars_torch.train.loop``)."""
