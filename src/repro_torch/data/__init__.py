"""Input pipelines of the training path (the reference's ``repro.data``)."""
