"""repro_torch.core: the paper's contribution -- PPL IR, tiling,
metapipelining -- with a CUDA back end."""
