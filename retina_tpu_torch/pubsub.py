"""In-process publish/subscribe bus (port of retina_tpu/pubsub.py).

Reference analog: pkg/pubsub/pubsub.go — a topic → callback registry where
``Publish`` fires every callback in its own goroutine (pubsub.go:40-59),
``Subscribe`` returns a UUID used by ``Unsubscribe`` (:62-113). It is the
seam between the control plane (the identity cache, the metrics module)
and the data plane.

Concurrency: callbacks run on a shared thread pool (goroutine analog);
callback exceptions are logged, never propagated to the publisher — a
misbehaving subscriber must not take down the data plane.
"""

from __future__ import annotations

import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
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

    def publish(self, topic: str, msg: Any) -> None:
        """Fire-and-forget to every subscriber (pubsub.go:40-59)."""
        with self._lock:
            subs = list(self._topics.get(topic, {}).values())
        for cb in subs:
            self._pool.submit(self._safe_call, cb, msg, topic)

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
