"""Model definitions of the port: ``config`` (``ModelConfig``, with its
analytic parameter and FLOP counts), the dense, MoE, audio and VLM
decoder families (``layers``, ``moe``, ``transformer``), the SSM
(Mamba-2, ``ssm``) and hybrid (Zamba-2, ``hybrid``) families, the
unified API with the training loss (``model``), the paged KV cache and
its decode step (``paged``), the sharding hints (``sharding``: the
identity, and under ``use_mesh_hints(mesh)`` divisibility-checked
DTensor redistributions) and the carrying of the reference's weights
(``convert``)."""
