"""Checkpoints of the training path (the reference's ``repro.checkpoint``)."""
