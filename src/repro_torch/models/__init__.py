"""Model definitions of the port: ``config`` (``ModelConfig``, with its
analytic parameter and FLOP counts), the dense and MoE decoder
families (``layers``, ``moe``, ``transformer``, ``model``), the paged KV
cache and its decode step (``paged``), the no-op sharding hints
(``sharding``) and the carrying of the reference's weights
(``convert``).  SSM, hybrid, audio and VLM families arrive with ROADMAP
§1 step 4."""
