"""Paged chunked-prefill attention (port of repro.kernels.flash_attention)."""
