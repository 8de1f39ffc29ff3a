"""The port's dense model: RPN backbone and serving head."""
