"""Entry points of the port: serving (``serve``), training (``train``)
and the step functions they run (``steps``)."""
