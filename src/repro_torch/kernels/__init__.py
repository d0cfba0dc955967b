"""The hand-written kernel layer: ``matmul``, ``filter_reduce``,
``fused_filter_fold``, ``groupby_fold`` and ``fused_kmeans`` (each a CUDA
kernel in ``csrc/`` with its plain PyTorch version), their front door
``ops`` (with the DSE plan memo ``resolve_plan``), the oracles ``ref``,
``autotile``, and the build of every CUDA template (``build``)."""
