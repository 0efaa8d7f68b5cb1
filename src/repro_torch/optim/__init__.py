"""Optimizers, LR schedules and gradient clipping (``optimizers``)."""
