"""repro_torch: the PyTorch/CUDA port of the parallel-pattern compiler.

Laid out like the JAX package ``repro``: ``core`` holds the PPL IR, the
tiling and fusion passes, the cost and memory models, the pipeline DSE
and the CUDA code generator; ``kernels`` holds the hand-written CUDA
kernels and templates, their wrappers and their build; ``patterns``
holds the benchmark programs; ``models`` the LM families and the paged
KV cache; ``launch`` the serving and training entry points and
distribution on ``torch.distributed`` (``mesh``: production and elastic
device meshes and a fake world; ``shard_rules``: how every tensor is
placed; ``dryrun``: every cell's step on meta shards of a fake
production world); ``optim`` (AdamW), ``data`` (the token pipeline),
``checkpoint`` and ``runtime`` (fault-tolerance policies) the rest of
the training path.
"""
