"""Fused tensor_transform pass (B7)."""
