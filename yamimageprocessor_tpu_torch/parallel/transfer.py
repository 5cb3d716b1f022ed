"""Host <-> device copies through pinned buffers on one copy stream (the
port of ``yamimageprocessor_tpu/parallel/transfer.py``, rebuilt for the
card).

The reference cut device-to-host fetches into 4 MiB chunks because its
TPU relay served large copies at a fifth of its rate; that chunking, its
link probe (``probe_and_tune``) and the streaming engine's autotune
(``autotune_transfer``) are not ported.  On the card a copy runs at the
link's rate only from page-locked host memory, and only a copy issued on
a stream of its own overlaps the kernels of the compute stream.  So both
directions here:

* go through **pinned host buffers**;
* are issued ``non_blocking`` on **one copy stream** per device, ordered
  against the compute stream (the current stream when the copy starts)
  by CUDA events: a fetch waits for the kernels that produced its tensor,
  and the compute stream waits for an upload before it reads the tensor;
* never rewrite a host buffer before its copy's event has completed.

Uploads stage through a small pool of pinned buffers (:class:`Staging`):
the caller fills a buffer's numpy view (the streaming engine reads tile
windows straight into it), :func:`start_upload` queues the copy and
returns the buffer to the pool with the copy's event, and the pool hands
it out again only after that event has completed.  Fetches copy into a
pinned buffer of their own, from PyTorch's caching host allocator, and
:func:`finish_fetch` hands that buffer over as a numpy array: nothing
rewrites it while the array lives, so tiles handed on are never views
of a buffer that a later transfer reuses (the allocator takes the block
back only once the array is dropped and the copy's event has completed).

For tensors on the CPU (the tests) the same functions are plain host
copies: no pinning, no streams.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np
import torch

#: pinned staging buffers kept per size and device
_STAGING_BUFFERS = 4

_lock = threading.Lock()
_copy_streams: Dict[torch.device, Any] = {}
_pools: Dict[Tuple[torch.device, int], Deque] = {}


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def copy_stream(device) -> "torch.cuda.Stream":
    """The copy stream of a CUDA device (one per device, made at first use)."""

    device = _device(device)
    with _lock:
        stream = _copy_streams.get(device)
        if stream is None:
            stream = torch.cuda.Stream(device=device)
            _copy_streams[device] = stream
        return stream


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""

    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class Staging:
    """A host buffer to fill before an upload: ``array`` is its numpy view
    of ``shape`` and ``dtype`` (page-locked when the device is a card)."""

    __slots__ = ("array", "_buffer", "_device")

    def __init__(self, array: np.ndarray, buffer: Optional[torch.Tensor], device: torch.device) -> None:
        self.array = array
        self._buffer = buffer
        self._device = device


def staging(shape, dtype, device) -> Staging:
    """A staging buffer for an upload to ``device``: from the pool of
    pinned buffers for a card (one whose last copy has completed; a new one
    while the pool holds fewer than :data:`_STAGING_BUFFERS` of this size,
    else the oldest, after waiting for its copy), a plain array for the
    CPU."""

    device = _device(device)
    dtype = np.dtype(dtype)
    shape = tuple(int(s) for s in shape)
    if device.type != "cuda":
        return Staging(np.empty(shape, dtype), None, device)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    key = (device, nbytes)
    with _lock:
        pool = _pools.setdefault(key, deque())
        buffer = None
        for i, (buf, event) in enumerate(pool):
            if event.query():
                del pool[i]
                buffer = buf
                break
        if buffer is None and len(pool) >= _STAGING_BUFFERS:
            buffer, event = pool.popleft()
            event.synchronize()
    if buffer is None:
        buffer = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
    array = buffer.numpy()[:nbytes].view(dtype).reshape(shape)
    return Staging(array, buffer, device)


class UploadHandle:
    """An upload in flight: ``tensor`` is on the device; read it only after
    :func:`finish_upload`."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event: Optional[Any]) -> None:
        self.tensor = tensor
        self.event = event


def start_upload(src, device, out: Optional[torch.Tensor] = None) -> UploadHandle:
    """Queue the copy of ``src`` (a :class:`Staging` filled by the caller,
    or an array, which is first copied into one) to ``device``, into
    ``out`` when given (a tensor of the same shape and dtype on the
    device).  On a card the copy runs on the copy stream; the staging
    buffer goes back to the pool with the copy's event."""

    device = _device(device)
    if not isinstance(src, Staging):
        array = np.asarray(src)
        stage = staging(array.shape, array.dtype, device)
        np.copyto(stage.array, array)
        src = stage
    if device.type != "cuda":
        host = torch.from_numpy(src.array)
        if out is None:
            return UploadHandle(host.to(device), None)
        out.copy_(host)
        return UploadHandle(out, None)
    if out is None:
        out = torch.empty(src.array.shape, dtype=torch_dtype(src.array.dtype), device=device)
    host = src._buffer[: src.array.nbytes].view(out.dtype).reshape(out.shape)
    stream = copy_stream(device)
    # the destination may still be read by queued kernels of the compute
    # stream (a buffer reused across batches): the copy waits for them
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        out.copy_(host, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    out.record_stream(stream)
    key = (device, src.array.nbytes)
    with _lock:
        _pools.setdefault(key, deque()).append((src._buffer, event))
    src._buffer = None  # the pool owns it again
    return UploadHandle(out, event)


def finish_upload(handle: UploadHandle) -> torch.Tensor:
    """The uploaded tensor, with the current stream ordered after its copy
    (nothing waits on the host)."""

    if handle.event is not None:
        torch.cuda.current_stream(handle.tensor.device).wait_event(handle.event)
    return handle.tensor


def upload(src, device) -> torch.Tensor:
    """Synchronous-order upload: :func:`start_upload` then
    :func:`finish_upload`."""

    return finish_upload(start_upload(src, device))


class FetchHandle:
    """A device -> host copy in flight (start early, finish at drain)."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event: Optional[Any]) -> None:
        self.host = host
        self.event = event


def start_fetch(dev: torch.Tensor) -> FetchHandle:
    """Queue the copy of ``dev`` to a pinned host buffer of its own on the
    copy stream, after the work the current stream has queued; returns a
    handle for :func:`finish_fetch`."""

    if not dev.is_cuda:
        return FetchHandle(dev.detach(), None)
    stream = copy_stream(dev.device)
    stream.wait_stream(torch.cuda.current_stream(dev.device))
    host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        host.copy_(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    dev.record_stream(stream)
    return FetchHandle(host, event)


def finish_fetch(handle: FetchHandle) -> np.ndarray:
    """Wait until the copy has landed; the host buffer as a numpy array,
    owned by the caller (no later transfer rewrites it)."""

    if handle.event is not None:
        handle.event.synchronize()
    return handle.host.numpy()


def fetch(dev: torch.Tensor) -> np.ndarray:
    """Synchronous fetch (start + finish)."""

    return finish_fetch(start_fetch(dev))


__all__ = [
    "FetchHandle",
    "Staging",
    "UploadHandle",
    "copy_stream",
    "fetch",
    "finish_fetch",
    "finish_upload",
    "staging",
    "start_fetch",
    "start_upload",
    "torch_dtype",
    "upload",
]
