"""In-process publish/subscribe bus (port of retina_tpu/pubsub.py).

Reference analog: pkg/pubsub/pubsub.go — a topic → callback registry where
``Publish`` fires every callback in its own goroutine (pubsub.go:40-59),
``Subscribe`` returns a UUID used by ``Unsubscribe`` (:62-113). It is the
seam between the control plane (the identity cache, the metrics module)
and the data plane.

Concurrency: callbacks run on a shared thread pool (goroutine analog);
callback exceptions are logged, never propagated to the publisher — a
misbehaving subscriber must not take down the data plane. The pool gives
no ordering; ``wait_delivered`` (the port's addition) waits until every
callback published on a topic so far has run, which is how the agent's
identity watcher knows that a LIST's pod events reached the metrics
module.
"""

from __future__ import annotations

import concurrent.futures
import threading
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable

from retina_tpu_torch.log import logger

CallBackFunc = Callable[[Any], None]


class PubSub:
    """Thread-safe topic bus (reference PubSubInterface)."""

    def __init__(self, max_workers: int = 8):
        self._lock = threading.RLock()
        self._topics: dict[str, dict[str, CallBackFunc]] = {}
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="pubsub"
        )
        self._log = logger("pubsub")
        # topic -> callbacks submitted and not yet finished
        self._pending: dict[str, set[Future]] = {}

    def publish(self, topic: str, msg: Any) -> None:
        """Fire-and-forget to every subscriber (pubsub.go:40-59)."""
        with self._lock:
            subs = list(self._topics.get(topic, {}).values())
            pending = self._pending.setdefault(topic, set())
            for cb in subs:
                fut = self._pool.submit(self._safe_call, cb, msg, topic)
                pending.add(fut)
                fut.add_done_callback(lambda f, p=pending: self._done(p, f))

    def _done(self, pending: set[Future], fut: Future) -> None:
        with self._lock:
            pending.discard(fut)

    def wait_delivered(self, topic: str, timeout: float | None = None) -> bool:
        """Wait until every callback published on ``topic`` before this
        call has run; False if ``timeout`` ran out first."""
        with self._lock:
            pending = set(self._pending.get(topic, ()))
        _, left = concurrent.futures.wait(pending, timeout=timeout)
        return not left

    def publish_sync(self, topic: str, msg: Any) -> None:
        """Synchronous variant: callbacks run inline, still error-isolated.
        Used on paths that need ordering (e.g. cache event fan-out in
        tests)."""
        with self._lock:
            subs = list(self._topics.get(topic, {}).values())
        for cb in subs:
            self._safe_call(cb, msg, topic)

    def _safe_call(self, cb: CallBackFunc, msg: Any, topic: str) -> None:
        try:
            cb(msg)
        except Exception:
            self._log.exception("subscriber callback failed topic=%s", topic)

    def subscribe(self, topic: str, cb: CallBackFunc) -> str:
        """Register; returns the unsubscribe UUID (pubsub.go:62-80)."""
        sub_id = str(uuid.uuid4())
        with self._lock:
            self._topics.setdefault(topic, {})[sub_id] = cb
        return sub_id

    def unsubscribe(self, topic: str, sub_id: str) -> None:
        with self._lock:
            subs = self._topics.get(topic)
            if not subs or sub_id not in subs:
                raise KeyError(f"no subscriber {sub_id} on topic {topic}")
            del subs[sub_id]

    def has_subscribers(self, topic: str) -> bool:
        with self._lock:
            return bool(self._topics.get(topic))

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)


_singleton: PubSub | None = None
_singleton_lock = threading.Lock()


def get_pubsub() -> PubSub:
    """Process-wide bus (reference sync.Once singleton pattern)."""
    global _singleton
    with _singleton_lock:
        if _singleton is None:
            _singleton = PubSub()
        return _singleton
