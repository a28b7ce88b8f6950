"""Paged decode attention (port of repro.kernels.decode_attention)."""
