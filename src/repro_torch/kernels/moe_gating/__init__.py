"""Top-k MoE gating (port of repro.kernels.moe_gating)."""
