"""The host side of a copy off the card (``HostCopy``, which
``utils/device_proxy.to_host`` returns): a module of its own with no torch
import, so that a process that never loads torch (the churn harness's
node-agent children, ``fleet/node_agent.py``) can import the shipper that
accepts one."""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    import torch


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
