"""Pinned host memory for the port's host<->device links.

A copy from pageable host memory ends in a synchronise of the stream, so a
loop that uploads several payloads waits for everything queued before each
one. Every upload on the card therefore goes from pinned memory, with a
non-blocking copy on the current stream:

  * ``PinnedStaging``: two pinned buffers that payloads are packed into, in
    turns (the RUNS engine's batch wire, the aligner's and the overlap
    search's packed reads). A payload may lie anywhere inside a buffer, so
    several payloads share one buffer at their own offsets; a buffer is
    refilled only after the event of its last upload has fired.
  * ``PinnedCopy``: a device tensor's non-blocking copy into a pinned host
    buffer and the event that says it has landed (the strategy's pull
    after a step, as the JAX sims' ``copy_to_host_async``).

Both pin their buffers through ``_buffer`` and make their events (one a
buffer, made once and recorded again at each use: making a CUDA event costs
more than recording one) through ``_new_event``, which a CPU test replaces
with plain buffers and no event.
"""
from __future__ import annotations

import threading

import numpy as np
import torch


class PinnedStaging:
    """Two pinned host buffers that payloads are packed into, in turns. A
    buffer is refilled only after the event of its last upload has fired,
    so packing the next payloads never races the copies of the ones before."""

    def __init__(self):
        self._bufs: list[torch.Tensor | None] = [None, None]
        self._events: list = [None, None]      # each buffer's, once it has one
        self._pending = [False, False]         # an upload since the last take
        self._turn = 0
        self._lock = threading.Lock()

    def take(self, n_words: int) -> np.ndarray:
        """A uint32 [n_words] view of the next buffer (grown as needed)."""
        with self._lock:
            i = self._turn
            self._turn ^= 1
            if self._pending[i] and self._events[i] is not None:
                self._events[i].synchronize()
            self._pending[i] = False
            buf = self._bufs[i]
            if buf is None or buf.numel() < n_words:
                buf = self._buffer(max(n_words, 2 * (0 if buf is None else buf.numel())))
                self._bufs[i] = buf
            return buf.numpy().view(np.uint32)[:n_words]

    def upload(self, wire: np.ndarray, dst: torch.Tensor) -> bool:
        """One async copy of ``wire`` (contiguous 4-byte words) into ``dst``
        on the current stream, if ``wire`` lies inside a staging buffer;
        else False."""
        if not wire.flags.c_contiguous or wire.itemsize != 4:
            return False
        with self._lock:
            for i, buf in enumerate(self._bufs):
                if buf is None:
                    continue
                off = wire.ctypes.data - buf.data_ptr()
                if 0 <= off and off + wire.nbytes <= 4 * buf.numel():
                    src = buf[off // 4: off // 4 + wire.size]
                    dst.view(torch.int32).view(-1).copy_(src, non_blocking=True)
                    ev = self._events[i] = self._events[i] or self._new_event()
                    if ev is not None:
                        ev.record()
                    self._pending[i] = True
                    return True
        return False

    @staticmethod
    def _buffer(n_words: int) -> torch.Tensor:
        return torch.empty(n_words, dtype=torch.int32, pin_memory=True)

    @staticmethod
    def _new_event():
        return torch.cuda.Event()


class PinnedCopy:
    """One device tensor's non-blocking copy into a pinned host buffer.

    ``start(t)`` queues the copy behind whatever the current stream holds
    (the step that wrote ``t``); ``take(t)`` waits on its event and returns
    the host array, or None when no copy of ``t`` is pending (never
    started, or dropped since). The buffer is reused: the next ``start``
    writes it again, so a caller that keeps the values copies them."""

    def __init__(self):
        self._buf: torch.Tensor | None = None
        self._event = None
        self._pending = None  # the source tensor of the copy in flight

    def start(self, t: torch.Tensor) -> None:
        buf = self._buf
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._buf = self._buffer(t.shape, t.dtype)
        buf.copy_(t, non_blocking=True)
        self._event = self._event or self._new_event()
        if self._event is not None:
            self._event.record()
        self._pending = t

    def take(self, t: torch.Tensor) -> np.ndarray | None:
        pend, self._pending = self._pending, None
        if pend is not t:
            return None
        if self._event is not None:
            self._event.synchronize()
        return self._buf.numpy()

    def drop(self) -> None:
        """Forget the pending copy (its source is about to change)."""
        self._pending = None

    @staticmethod
    def _buffer(shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    @staticmethod
    def _new_event():
        return torch.cuda.Event()
