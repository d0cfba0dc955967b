"""Benchmark programs in PPL (the paper's Table 5 suite)."""
