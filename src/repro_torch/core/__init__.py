"""repro.core — the stream-pipeline framework (the paper's contribution)."""
from .stream import (Buffer, MediaSpec, TensorSpec, TensorsSpec,
                     specs_compatible)
from .element import Element, Pad
from .pipeline import Pipeline, PipelineError
from .parser import parse_pipeline
from .registry import make_element, register_element
from . import elements

__all__ = [
    "Buffer", "MediaSpec", "TensorSpec", "TensorsSpec", "specs_compatible",
    "Element", "Pad", "Pipeline", "PipelineError", "parse_pipeline",
    "make_element", "register_element", "elements",
]
