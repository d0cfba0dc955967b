"""Model definitions of the port.  So far ``config`` (``ModelConfig``,
with its analytic parameter and FLOP counts): the layers and models
arrive with the LM-stack slice."""
