"""The benchmark's plain reference: PyTorch and NumPy only.

Nothing here imports ``jax``, ``tpu_pillars`` or ``tpu_pillars_torch``;
``pillarbench/tests/test_pillarbench_imports.py`` holds it to that. The
serving reference (:mod:`.detect`) is a frozen copy of the port's CPU
reference (numpy pillarize, the PointPillars forward, numpy decode and
rotated NMS), batched on the card; the training reference
(:mod:`.train`) is the same model on batch statistics with the port's
windowed assigner semantics, focal / smooth-L1 / direction losses, and
optax's clipped AdamW, written out in plain torch.
"""
