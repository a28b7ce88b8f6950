from .pipeline import TokenStream, synthetic_batches

__all__ = ["TokenStream", "synthetic_batches"]
