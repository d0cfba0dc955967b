"""Entry points of the port: serving (``serve``) and the step functions
it runs (``steps``)."""
