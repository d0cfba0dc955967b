"""The hand-written kernel layer: ``matmul``, ``filter_reduce``,
``fused_filter_fold``, ``groupby_fold``, ``fused_kmeans``,
``flash_attention`` and ``ssd_scan`` (each a CUDA kernel in ``csrc/`` with
its plain PyTorch version), their front door ``ops`` (with the DSE plan
memo ``resolve_plan``; ``ops.attention`` and ``ops.ssd`` for the LM
kernels), the oracles ``ref``, ``autotile``, and the build of every CUDA
template (``build``).  Each kernel's ``auto_tile=True`` path takes the
DSE's tuning arguments (``measure``, ``policy``, ``options``, ``cache``)
and passes them to ``ops.resolve_plan``."""
