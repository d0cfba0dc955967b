"""Runtime policies of the training path (the reference's ``repro.runtime``)."""
