"""repro_torch: the PyTorch/CUDA port of the parallel-pattern compiler.

Laid out like the JAX package ``repro``: ``core`` holds the PPL IR, the
tiling and fusion passes, the cost and memory models, the pipeline DSE
and the CUDA code generator; ``kernels`` holds the hand-written CUDA
kernels and templates, their wrappers and their build; ``patterns``
holds the benchmark programs; ``models`` the LM families and the paged
KV cache; ``launch`` the serving and training entry points; ``optim``
(AdamW), ``data`` (the token pipeline), ``checkpoint`` and ``runtime``
(fault-tolerance policies) the rest of the training path.
"""
