"""repro_torch: the PyTorch/CUDA port of the parallel-pattern compiler.

Laid out like the JAX package ``repro``: ``core`` holds the PPL IR, the
tiling and fusion passes, the cost and memory models, the pipeline DSE
and the CUDA code generator; ``kernels`` holds the hand-written CUDA
kernels and templates, their wrappers and their build; ``patterns``
holds the benchmark programs; ``models`` the dense LM family and its
paged KV cache; ``launch`` the serving entry points.
"""
