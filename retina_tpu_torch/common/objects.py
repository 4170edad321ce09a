"""Identity domain objects, dirty-tracking cache, retry helper (a copy of
retina_tpu/common/objects.py).

Reference analogs:
- RetinaEndpoint (pkg/common/endpoint.go): slim pod identity — name,
  namespace, IPs, labels, owner refs, containers. Thread-safety via an
  internal lock in the Go version; here instances are treated as immutable
  snapshots (replaced, never mutated) which is both simpler and what the
  device-side identity rebuild wants.
- DirtyCache (pkg/common/dirtycache.go): add/delete dirty-key tracking the
  metrics module uses to sync pod IPs into the filter map.
- retry (pkg/common/apiretry): bounded retries with backoff.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, TypeVar

T = TypeVar("T")


class IPFamily:
    IPv4 = "v4"
    IPv6 = "v6"


# Pod/namespace pod-level opt-in annotation (reference
# common/types.go:17-18): retina.sh=observe.
POD_ANNOTATION = "retina.sh"
POD_ANNOTATION_VALUE = "observe"


@dataclasses.dataclass(frozen=True)
class RetinaEndpoint:
    """Slim pod identity (reference pkg/common/endpoint.go)."""

    name: str
    namespace: str
    ips: tuple[str, ...] = ()
    labels: tuple[tuple[str, str], ...] = ()
    owner_refs: tuple[tuple[str, str], ...] = ()  # (kind, name)
    containers: tuple[str, ...] = ()
    annotations: tuple[tuple[str, str], ...] = ()
    node: str = ""

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def primary_ip(self) -> str:
        return self.ips[0] if self.ips else ""

    def workload(self) -> str:
        """Top owner ref, the reference's 'workloads' label source."""
        return self.owner_refs[0][1] if self.owner_refs else self.name

    def labels_dict(self) -> dict[str, str]:
        return dict(self.labels)


@dataclasses.dataclass(frozen=True)
class RetinaSvc:
    name: str
    namespace: str
    cluster_ip: str = ""
    lb_ip: str = ""
    selector: tuple[tuple[str, str], ...] = ()

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclasses.dataclass(frozen=True)
class RetinaNode:
    name: str
    ip: str = ""
    zone: str = ""


class DirtyCache:
    """Tracks keys to add/delete since last drain (dirtycache.go)."""

    def __init__(self) -> None:
        self._to_add: dict[str, Any] = {}
        self._to_delete: dict[str, Any] = {}

    def to_add(self, key: str, obj: Any) -> None:
        self._to_delete.pop(key, None)
        self._to_add[key] = obj

    def to_delete(self, key: str, obj: Any) -> None:
        self._to_add.pop(key, None)
        self._to_delete[key] = obj

    def get_add_list(self) -> list[Any]:
        return list(self._to_add.values())

    def get_delete_list(self) -> list[Any]:
        return list(self._to_delete.values())

    def clear_add(self) -> None:
        self._to_add.clear()

    def clear_delete(self) -> None:
        self._to_delete.clear()


def retry(
    fn: Callable[[], T],
    attempts: int = 5,
    base_delay_s: float = 0.05,
    max_delay_s: float = 2.0,
    retry_on: type[BaseException] = Exception,
) -> T:
    """Exponential-backoff retry (reference pkg/common/apiretry and the
    filtermanager backoff, manager_linux.go:31-60)."""
    delay = base_delay_s
    for i in range(attempts):
        try:
            return fn()
        except retry_on:
            if i == attempts - 1:
                raise
            time.sleep(delay)
            delay = min(delay * 2, max_delay_s)
    raise AssertionError("unreachable")
