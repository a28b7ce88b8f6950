"""TensorFilter — the neural network as an atomic pipeline filter.

The NNFW sub-plugin structure of the paper maps to *backends*:

  * ``python`` — arbitrary callable (the custom-C/Python sub-plugin)
  * ``torch``  — callable on torch tensors placed on a device (the NPU /
                 accelerator-delegation analogue): numpy inputs are
                 uploaded, outputs come back as numpy arrays (bf16 as
                 f32: numpy has no bf16)

A filter is resolved either from a direct ``fn`` or from the model
registry (``model="glm4-9b:smoke"``, built on the filter's ``device``),
which mirrors loading a .tflite/.snpe artifact by path.  Filters keep
per-invocation latency statistics so benchmarks can report per-stage
numbers like the paper's Table II.

Micro-batching: buffers produced by ``TensorBatcher`` carry
``meta["batch"]`` and a leading batch axis.  The filter pads such
batches up to the next power-of-2 *bucket* so a backend only ever sees
``log2(max_batch)+1`` distinct leading shapes.
Outputs are sliced back to the true batch size and the batch metadata
is forwarded untouched for the downstream ``TensorUnbatcher``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..element import Element, Pad
from ..stream import Buffer
from .batcher import BATCH_META_KEY


def bucket_for(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, clamped to max_batch."""
    if n >= max_batch:
        return max_batch
    b = 1
    while b < n:
        b <<= 1
    return b


class TensorFilter(Element):
    def __init__(self, name: str, fn: Optional[Callable] = None,
                 model: Optional[str] = None, framework: str = "python",
                 device=None, outputs_meta_key: Optional[str] = None, max_batch: int = 8,
                 pass_meta: bool = False):
        super().__init__(name)
        if pass_meta and framework != "python":
            raise ValueError(
                f"{name}: pass_meta requires the python backend — the "
                f"torch backend passes tensors only")
        self.pass_meta = bool(pass_meta)
        self.add_sink_pad()
        self.add_src_pad()
        self.framework = framework
        self.model_name = model
        self._raw_fn = fn
        self._device = device
        self._compiled: Optional[Callable] = None
        self.outputs_meta_key = outputs_meta_key
        self.max_batch = int(max_batch)
        # latency stats (paper Table II rows 3-5)
        self.n_invocations = 0
        self.total_latency_s = 0.0
        # bucket cache stats: bucket size -> [n_batches, n_frames, total_s]
        self.bucket_stats: Dict[int, List[float]] = {}

    # -- backend resolution -------------------------------------------------
    def _resolve(self) -> Callable:
        if self._compiled is not None:
            return self._compiled
        fn = self._raw_fn
        if fn is None:
            if self.model_name is None:
                raise ValueError(f"{self.name}: TensorFilter needs fn= or model=")
            from ...registry import get_model
            fn = get_model(self.model_name, self._device)
        if self.framework == "python":
            self._compiled = fn
        elif self.framework == "torch":
            self._compiled = _torch_backend(fn, self._device)
        else:
            raise ValueError(f"unknown TensorFilter framework {self.framework!r}")
        return self._compiled

    # -- invocation -----------------------------------------------------------
    def invoke(self, chunks: Sequence[Any],
               metas: Optional[List[Optional[dict]]] = None) -> Tuple[Any, ...]:
        fn = self._resolve()
        t0 = time.perf_counter()
        if metas is not None:
            out = fn(*chunks, metas=metas)
        else:
            out = fn(*chunks)
        self.total_latency_s += time.perf_counter() - t0
        self.n_invocations += 1
        if isinstance(out, (tuple, list)):
            return tuple(out)
        return (out,)

    def invoke_batched(self, chunks: Sequence[Any], n: int,
                       metas: Optional[List[Optional[dict]]] = None,
                       ) -> Tuple[Any, ...]:
        """Invoke on a leading-batch-axis stack of ``n`` frames.

        Pads the batch axis up to the power-of-2 bucket, then slices
        outputs back to the true size.  When ``pass_meta`` supplies per-frame
        ``metas``, pad rows carry ``None``.
        """
        bucket = bucket_for(n, self.max_batch)
        if bucket > n:
            chunks = [np.concatenate(
                [c, np.zeros((bucket - n,) + tuple(np.asarray(c).shape[1:]),
                             np.asarray(c).dtype)], axis=0)
                for c in chunks]
            if metas is not None:
                metas = list(metas) + [None] * (bucket - n)
        t0 = time.perf_counter()
        out = self.invoke(chunks, metas=metas)
        stat = self.bucket_stats.setdefault(bucket, [0, 0, 0.0])
        stat[0] += 1
        stat[1] += n
        stat[2] += time.perf_counter() - t0
        if bucket > n:
            out = tuple(np.asarray(o)[:n] for o in out)
        return out

    @property
    def n_bucket_compilations(self) -> int:
        """Distinct padded leading shapes seen (one per bucket)."""
        return len(self.bucket_stats)

    def transform(self, pad: Pad, buf: Buffer) -> Optional[Buffer]:
        info = buf.meta.get(BATCH_META_KEY)
        if info is not None:
            metas = info["meta"] if self.pass_meta else None
            out_chunks = self.invoke_batched(buf.chunks, int(info["size"]),
                                             metas=metas)
        else:
            out_chunks = self.invoke(
                buf.chunks, metas=[buf.meta] if self.pass_meta else None)
        new = buf.with_chunks(out_chunks)
        if self.outputs_meta_key:
            new.meta[self.outputs_meta_key] = out_chunks
        return new

    @property
    def mean_latency_s(self) -> float:
        return self.total_latency_s / max(self.n_invocations, 1)


def _to_numpy(t) -> np.ndarray:
    """A tensor copied to host numpy; bf16 (which numpy lacks) widened to
    f32, which is exact."""
    import torch
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _torch_backend(fn: Callable, device) -> Callable:
    """Wrap ``fn`` (tensors in, tensor or tuple of tensors out) so it
    takes and returns numpy arrays: inputs are uploaded to ``device``
    (default: the first CUDA device), outputs are copied back, which
    also waits for the device to finish."""
    import torch
    dev = torch.device(device if device is not None else "cuda")

    def run(*args):
        with torch.inference_mode():
            out = fn(*[torch.as_tensor(np.asarray(a), device=dev)
                       for a in args])
        if isinstance(out, (tuple, list)):
            return tuple(_to_numpy(o) for o in out)
        return _to_numpy(out)
    return run
