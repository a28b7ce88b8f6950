"""Source elements.

``AppSrc`` — application-driven push source (paper: streams connected
from application threads).  ``VideoTestSrc`` — synthetic video frames at
a target fps.  ``SensorSrc``/``TensorSrcIIO`` — synthetic sensor streams
(the Linux IIO / Tizen Sensor Framework analogues): configurable rate and
channel count, deterministic waveform so tests are reproducible.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from ..element import Element, Pad
from ..stream import Buffer, MediaSpec, TensorSpec


class SourceElement(Element):
    """Base for thread-driven sources."""

    def __init__(self, name: str, num_buffers: int = -1, rate: Optional[float] = None):
        super().__init__(name)
        self.num_buffers = int(num_buffers)   # -1 = unlimited
        self.rate = rate                      # Hz; None = as fast as possible
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.add_src_pad()

    def create(self, index: int) -> Buffer:
        raise NotImplementedError

    def _run(self) -> None:
        index = 0
        period = (1.0 / self.rate) if self.rate else 0.0
        next_t = time.monotonic()
        while self._running and (self.num_buffers < 0 or index < self.num_buffers):
            if period:
                now = time.monotonic()
                if now < next_t:
                    time.sleep(next_t - now)
                next_t += period
            try:
                buf = self.create(index)
                # stream-time pts (gst running time), not arrival wall-clock:
                # keeps sync policies deterministic for bursty sources
                buf.pts = index * period if period else float(index)
                self.srcpad.push(buf)
            except BaseException as exc:  # noqa: BLE001
                self.post_error(exc)
                return
            index += 1
        if self._running:
            self.srcpad.push(Buffer.eos_buffer())

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._run, name=f"src:{self.name}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class AppSrc(Element):
    """Push buffers from application code: ``appsrc.push(buf)``."""

    def __init__(self, name: str, spec=None):
        super().__init__(name)
        self.add_src_pad(spec=spec)

    def push(self, data, pts: Optional[float] = None, meta=None) -> None:
        buf = data if isinstance(data, Buffer) else Buffer(data, pts=pts, meta=meta)
        self.srcpad.push(buf)

    def end_of_stream(self) -> None:
        self.srcpad.push(Buffer.eos_buffer())


class VideoTestSrc(SourceElement):
    """Synthetic video frames (H, W, C) uint8 — moving gradient pattern."""

    def __init__(self, name: str, width: int = 224, height: int = 224,
                 channels: int = 3, num_buffers: int = -1,
                 rate: Optional[float] = None, seed: int = 0):
        super().__init__(name, num_buffers=num_buffers, rate=rate)
        self.width, self.height, self.channels = width, height, channels
        self.seed = seed
        self.srcpad.spec = MediaSpec("video/x-raw", format="RGB", width=width,
                                     height=height, channels=channels, rate=rate)

    def create(self, index: int) -> Buffer:
        h, w, c = self.height, self.width, self.channels
        row = (np.arange(w, dtype=np.uint16)[None, :] + index * 7 + self.seed)
        col = (np.arange(h, dtype=np.uint16)[:, None] * 3)
        frame = ((row + col)[:, :, None] + np.arange(c, dtype=np.uint16) * 85) % 256
        return Buffer(frame.astype(np.uint8), meta={"frame_index": index})


class SensorSrc(SourceElement):
    """Synthetic multi-channel sensor samples (channels,) float32."""

    def __init__(self, name: str, channels: int = 3, num_buffers: int = -1,
                 rate: Optional[float] = None, seed: int = 0):
        super().__init__(name, num_buffers=num_buffers, rate=rate)
        self.channels = channels
        self.seed = seed
        self.srcpad.spec = TensorSpec(dims=(channels,), dtype="float32", framerate=rate)

    def create(self, index: int) -> Buffer:
        t = index * 0.01 + self.seed
        phase = np.arange(self.channels, dtype=np.float32)
        sample = np.sin(2 * np.pi * (0.5 + 0.25 * phase) * t + phase).astype(np.float32)
        return Buffer(sample, meta={"sample_index": index})


class TensorSrcIIO(SensorSrc):
    """Alias element mirroring NNStreamer's Tensor-Src-IIO."""
