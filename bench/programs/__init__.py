"""The users' programs, one module per configuration's ``program``:
``pipeline(rows, **args)`` writes the query as a ``repro_torch``
pipeline of parallel patterns, as a user of the compiler writes it.
The harness hands it to ``repro_torch.core.pipeline.lower_pipeline``;
the compiler (its DSE, its code generator, its kernels) is the system
under test.  ``reference/<program>.py`` states the same query in plain
PyTorch."""
