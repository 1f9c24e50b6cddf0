"""LM training on the port: the train step, the optimizers and the
confidence-bounded gradient accumulation (``repro/training``)."""
