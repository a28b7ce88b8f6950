"""TensorConverter (media → tensor) and TensorDecoder (tensor → media/other).

Converter sub-plugins accept video / audio / text / flatbuf-like payloads
and emit ``other/tensor`` streams.  Decoder sub-plugins turn tensors back
into consumable results (bounding boxes, labels, overlay frames,
serialized dicts — the Flatbuf/Protobuf analogue is a plain dict payload).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..element import Element, Pad
from ..stream import Buffer, TensorSpec


class TensorConverter(Element):
    """Convert media buffers to tensor buffers.

    modes:
      * "video"  — HWC uint8 frame -> tensor (optionally float32 scaled)
      * "audio"  — PCM samples -> tensor
      * "text"   — str -> uint8 codepoint tensor (fixed size, padded)
      * "passthrough" — already-tensor data, restamp only
      * custom: pass ``fn``
    """

    def __init__(self, name: str, mode: str = "video",
                 to_float: bool = False, text_size: int = 256,
                 fn: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        super().__init__(name)
        self.add_sink_pad()
        self.add_src_pad()
        self.mode = mode
        self.to_float = to_float
        self.text_size = text_size
        self.fn = fn

    def transform(self, pad: Pad, buf: Buffer) -> Optional[Buffer]:
        if self.fn is not None:
            return buf.with_chunks(self.fn(buf.data))
        if self.mode == "text":
            text = buf.data if isinstance(buf.data, str) else str(buf.data)
            codes = np.frombuffer(text.encode("utf-8")[: self.text_size], dtype=np.uint8)
            out = np.zeros((self.text_size,), dtype=np.uint8)
            out[: codes.size] = codes
            return buf.with_chunks(out)
        arr = np.asarray(buf.data)
        if self.mode in ("video", "audio"):
            if self.to_float:
                arr = arr.astype(np.float32)
                if self.mode == "video":
                    arr = arr / 255.0
            return buf.with_chunks(arr)
        if self.mode == "passthrough":
            return buf.with_chunks(arr)
        raise ValueError(f"unknown converter mode {self.mode!r}")


class TensorDecoder(Element):
    """Decode tensor streams into results.

    sub-plugins ("mode"):
      * "argmax_label"   — classification tensor -> {"label": int, "score": float}
      * "bounding_boxes" — (N,5) [x,y,w,h,score] -> list of box dicts
      * "overlay"        — boxes + size -> transparent RGBA frame with boxes
      * "flatbuf"/"protobuf" — dict payload {"tensors": [...], "pts": ...}
      * custom: pass ``fn``
    """

    def __init__(self, name: str, mode: str = "argmax_label",
                 width: int = 0, height: int = 0,
                 fn: Optional[Callable[[Buffer], object]] = None):
        super().__init__(name)
        self.add_sink_pad()
        self.add_src_pad()
        self.mode = mode
        self.width, self.height = width, height
        self.fn = fn

    def transform(self, pad: Pad, buf: Buffer) -> Optional[Buffer]:
        if self.fn is not None:
            return buf.with_chunks(np.asarray(self.fn(buf), dtype=object).reshape(()))
        if self.mode == "argmax_label":
            scores = np.asarray(buf.data).reshape(-1)
            idx = int(np.argmax(scores))
            out = np.array((idx, float(scores[idx])), dtype=np.float32)
            new = buf.with_chunks(out)
            new.meta["label"] = idx
            return new
        if self.mode == "bounding_boxes":
            arr = np.asarray(buf.data).reshape(-1, 5)
            new = buf.with_chunks(arr)
            new.meta["boxes"] = [
                {"x": float(r[0]), "y": float(r[1]), "w": float(r[2]),
                 "h": float(r[3]), "score": float(r[4])} for r in arr]
            return new
        if self.mode == "overlay":
            arr = np.asarray(buf.data).reshape(-1, 5)
            frame = np.zeros((self.height, self.width, 4), dtype=np.uint8)
            for x, y, w, h, score in arr:
                x0, y0 = int(max(x, 0)), int(max(y, 0))
                x1 = int(min(x + w, self.width - 1))
                y1 = int(min(y + h, self.height - 1))
                if x1 <= x0 or y1 <= y0:
                    continue
                frame[y0:y1, x0, :] = (0, 255, 0, 255)
                frame[y0:y1, x1, :] = (0, 255, 0, 255)
                frame[y0, x0:x1, :] = (0, 255, 0, 255)
                frame[y1, x0:x1, :] = (0, 255, 0, 255)
            return buf.with_chunks(frame)
        if self.mode in ("flatbuf", "protobuf"):
            payload = {"tensors": [np.asarray(c) for c in buf.chunks], "pts": buf.pts}
            new = Buffer(buf.chunks, pts=buf.pts, meta=dict(buf.meta))
            new.meta["payload"] = payload
            return new
        raise ValueError(f"unknown decoder mode {self.mode!r}")
