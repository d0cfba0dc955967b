"""Optimizers of the training path (the reference's ``repro.optim``)."""
