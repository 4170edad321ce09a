"""One device-call thread per device (port of
retina_tpu/utils/device_proxy.py).

The agent is multi-threaded on the host (the feed loop, feed workers, the
dispatch thread, the harvest thread, scrapes), but all of the engine's
card work runs on one daemon thread per device, which owns one
``torch.cuda.Stream`` and runs every call under ``torch.cuda.stream(...)``:
the kernels' wrappers launch on ``torch.cuda.current_stream()``, so every
K1-K7 launch of the engine lands on that stream, in the order the calls
were queued. Callers enqueue closures and block on the result
(``run``), or fire and forget (``submit``); a later blocking call is a
fence for everything submitted before it. Re-entrant calls (a proxied
closure calling ``run``) execute directly.

``run``, ``submit`` and ``fence`` are the reference's ``run_on_device``,
``submit_on_device`` and ``fence``; ``proxy_for(device)`` is the
process's proxy of a device.

Streams are per thread in torch, so a call crosses streams twice, and
both crossings are ordered by CUDA events, never by a host wait: the proxy
stream waits for an event recorded on the caller's current stream when the
call was queued (work the caller issued before, such as the tensors it
passes, is done first), and after a ``run`` or ``fence`` the caller's
stream waits for an event recorded on the proxy stream after the call
(work the caller issues next sees the call's results). Results a thread
reads on the host cross as a :class:`HostCopy`: an asynchronous copy into
pinned host memory on the proxy stream and the event after it, which the
reader waits for off the proxy (``HostCopy.result``, where the reference
calls ``fetch_on_device``). Wires cross the other way from
:class:`PinnedStaging` buffers, each reused only once the event recorded
after its copy has completed.

On the CPU (the tests) the proxy is the same thread and queue with no
stream and no events, and a host copy is a clone.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from typing import Any, Callable, TypeVar

import numpy as np
import torch

T = TypeVar("T")

_log = logging.getLogger("retina_tpu_torch.device_proxy")


class HostCopy:
    """Tensors copied to the host on the proxy stream; ``result()`` waits
    for the copy (off the proxy) and returns them."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors: dict[str, torch.Tensor], event: Any = None):
        self.tensors = tensors
        self.event = event

    def result(self, timeout: float | None = None) -> dict[str, torch.Tensor]:
        """The host tensors once the copy is done; with ``timeout``, raise
        ``TimeoutError`` if it is not done within that many seconds (a wait
        that cannot hang on a wedged card)."""
        event = self.event  # several readers may wait on one copy
        if event is not None:
            if timeout is None:
                event.synchronize()
            else:
                deadline = time.monotonic() + timeout
                while not event.query():
                    if time.monotonic() >= deadline:
                        raise TimeoutError(f"host copy not done within {timeout} s")
                    time.sleep(0.0005)
            self.event = None
        return self.tensors


def to_host(tensors: dict[str, torch.Tensor]) -> HostCopy:
    """(On the proxy thread.) Start copying ``tensors`` to the host: into
    pinned buffers with ``non_blocking=True`` and an event after them on the
    current stream for card tensors, a clone for CPU tensors (the state is
    updated in place by later calls)."""
    out, event = {}, None
    for name, t in tensors.items():
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            if event is None:
                event = torch.cuda.Event()
            out[name] = host
        else:
            out[name] = t.clone()
    if event is not None:
        event.record(torch.cuda.current_stream())
    return HostCopy(out, event)


class PinnedStaging:
    """Host buffers the wires are built in and cross from to ``device``:
    pinned on a card, so the copy runs with ``non_blocking=True`` on the
    proxy stream. ``take`` hands out a free buffer whose last copy has
    completed (its event has fired), or a new one; ``give`` returns a buffer
    with the event recorded after its copy."""

    MAX_FREE = 16
    MIN_BYTES = 1 << 16

    def __init__(self, device: torch.device):
        self._pin = torch.device(device).type == "cuda"
        self._lock = threading.Lock()
        self._free: list[tuple[torch.Tensor, Any]] = []
        self.allocated = 0  # buffers made (a measure of reuse)

    def take(self, nbytes: int) -> torch.Tensor:
        """A uint8 buffer of at least ``nbytes`` that no copy still reads."""
        with self._lock:
            best = None
            for i, (buf, ev) in enumerate(self._free):
                if buf.numel() >= nbytes and (ev is None or ev.query()):
                    if best is None or buf.numel() < self._free[best][0].numel():
                        best = i
            if best is not None:
                return self._free.pop(best)[0]
            self.allocated += 1
        size = max(self.MIN_BYTES, 1 << max(0, int(nbytes) - 1).bit_length())
        return torch.empty(size, dtype=torch.uint8, pin_memory=self._pin)

    def give(self, buf: torch.Tensor, event: Any = None) -> None:
        with self._lock:
            if len(self._free) < self.MAX_FREE:
                self._free.append((buf, event))

    def array(self, shape: tuple, dtype=np.uint32) -> tuple[np.ndarray, torch.Tensor]:
        """A zeroed numpy array of ``shape`` in a taken buffer, and the
        buffer (hand both to ``to_card``)."""
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        buf = self.take(nbytes)
        arr = buf[:nbytes].numpy().view(dtype).reshape(shape)
        arr.fill(0)
        return arr, buf

    def to_card(self, arr: np.ndarray, buf: torch.Tensor, device: torch.device) -> torch.Tensor:
        """(On the proxy thread.) Copy ``arr`` (a u32 array in ``buf``) to
        ``device`` as int32 bit patterns, and give the buffer back once the
        copy is queued, with the event after it."""
        src = buf[: arr.nbytes].view(torch.int32).reshape(arr.shape)
        if not self._pin:
            out = src.clone()
            self.give(buf)
            return out
        out = torch.empty(arr.shape, dtype=torch.int32, device=device)
        out.copy_(src, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        self.give(buf, ev)
        return out

    def to_cards(self, arr: np.ndarray, buf: torch.Tensor,
                 devices: list[torch.device]) -> list[torch.Tensor]:
        """(On the proxy thread.) Copy row i of ``arr`` (a u32 array in
        ``buf``, one row a device) to ``devices[i]``: one copy when every row
        goes to one device, else one a row, each on its card's current
        stream. The buffer goes back once the last copy is queued, with an
        event a card after it."""
        if all(d == devices[0] for d in devices):
            return list(self.to_card(arr, buf, devices[0]))
        src = buf[: arr.nbytes].view(torch.int32).reshape(arr.shape)
        rows = []
        for row, dev in zip(src, devices):
            out = torch.empty(row.shape, dtype=torch.int32, device=dev)
            out.copy_(row, non_blocking=self._pin)
            rows.append(out)
        events = []
        for dev in dict.fromkeys(devices) if self._pin else ():
            events.append(torch.cuda.Event())
            events[-1].record(torch.cuda.current_stream(dev))
        self.give(buf, _Events(events) if events else None)
        return rows


class _Events:
    """Several events as one: done when every one is."""

    __slots__ = ("events",)

    def __init__(self, events: list) -> None:
        self.events = events

    def query(self) -> bool:
        return all(e.query() for e in self.events)


class _Call:
    __slots__ = ("fn", "args", "kwargs", "after", "done", "result", "error", "ready")

    def __init__(self, fn, args, kwargs, after, done):
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self.after, self.done = after, done
        self.result = self.error = self.ready = None


class DeviceProxy:
    """The device-call thread of one device and its stream."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self.stream: Any = None
        self._q: queue.Queue = queue.Queue()  # bounded upstream by the engine's semaphores
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.errors = 0  # fire-and-forget closures that raised
        self.busy_s = 0.0  # host seconds spent running closures

    def on_thread(self) -> bool:
        return threading.current_thread() is self._thread

    def _ensure(self) -> queue.Queue:
        with self._lock:
            if self._thread is None:
                if self._cuda:
                    self.stream = torch.cuda.Stream(self.device)
                self._thread = threading.Thread(target=self._loop,
                                                name=f"device-proxy-{self.device}",
                                                daemon=True)
                self._thread.start()
        return self._q

    def _caller_event(self) -> Any:
        """An event on the calling thread's current stream (CUDA only). On a
        lost CUDA context the record fails: the call is queued without one,
        and raises its own error on the proxy."""
        if not self._cuda:
            return None
        try:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        except Exception:
            _log.warning("no caller event (the CUDA context is lost?)", exc_info=True)
            return None
        return ev

    def _loop(self) -> None:
        ctx = (torch.cuda.stream(self.stream) if self._cuda else contextlib.nullcontext())
        dev = torch.cuda.device(self.device) if self._cuda else contextlib.nullcontext()
        with dev, ctx:
            while True:
                call: _Call = self._q.get()
                t0 = time.perf_counter()
                try:
                    if call.after is not None:
                        self.stream.wait_event(call.after)
                    call.result = call.fn(*call.args, **call.kwargs)
                except BaseException as e:  # delivered to the caller, or counted
                    call.error = e
                    if call.done is None:
                        self.errors += 1
                        _log.error("submitted device call %r raised", call.fn, exc_info=e)
                finally:
                    if self._cuda and call.done is not None:
                        try:
                            call.ready = torch.cuda.Event()
                            call.ready.record(self.stream)
                        except Exception as e:
                            # A lost CUDA context fails the record too: the
                            # caller gets the error, and this thread lives
                            # on to deliver the next call's.
                            call.ready = None
                            if call.error is None:
                                call.error = e
                    self.busy_s += time.perf_counter() - t0
                    if call.done is not None:
                        call.done.set()

    def _wait_ready(self, call: _Call) -> None:
        if call.ready is not None:
            torch.cuda.current_stream(self.device).wait_event(call.ready)

    def run(self, fn: Callable[..., T], *args: Any, **kwargs: Any) -> T:
        """Run ``fn(*args, **kwargs)`` on the proxy thread and return (or
        re-raise) its result; the caller's stream then waits for it."""
        if self.on_thread():
            return fn(*args, **kwargs)
        q = self._ensure()
        call = _Call(fn, args, kwargs, self._caller_event(), threading.Event())
        q.put(call)
        call.done.wait()
        if call.error is not None:
            raise call.error
        self._wait_ready(call)
        return call.result

    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        """Fire and forget, in FIFO order with every other call. ``fn``
        handles its own failures; one that raises anyway is logged and
        counted in ``errors``. Callers bound the outstanding submissions."""
        if self.on_thread():
            try:
                fn(*args, **kwargs)
            except Exception:
                self.errors += 1
                _log.exception("submitted device call %r raised", fn)
            return
        self._ensure().put(_Call(fn, args, kwargs, self._caller_event(), None))

    def fence(self, timeout: float | None = None) -> bool:
        """Block until everything queued before this call has run; False
        if ``timeout`` seconds elapsed first."""
        if self.on_thread():
            return True
        call = _Call(lambda: None, (), {}, self._caller_event(), threading.Event())
        self._ensure().put(call)
        if not call.done.wait(timeout):
            return False
        self._wait_ready(call)
        return True


_proxies: dict[str, DeviceProxy] = {}
_proxies_lock = threading.Lock()


def proxy_for(device: torch.device | str) -> DeviceProxy:
    """The process's one proxy of ``device`` (its thread starts at first
    use)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _proxies_lock:
        p = _proxies.get(str(dev))
        if p is None:
            p = _proxies[str(dev)] = DeviceProxy(dev)
        return p
