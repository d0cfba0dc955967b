"""Hand-written CUDA templates (``csrc/``) and their build (``build``)."""
