"""mockplugin: trivial fake plugin for wiring tests (copy of retina_tpu/plugins/mockplugin.py).

Reference analog: pkg/plugin/mockplugin — a no-op plugin used to test the
pluginmanager lifecycle without a kernel. This one records lifecycle calls
and can be told to fail at any stage or emit canned records.
"""

from __future__ import annotations

import threading

import numpy as np

from retina_tpu_torch.config import Config
from retina_tpu_torch.events.schema import NUM_FIELDS
from retina_tpu_torch.plugins import registry
from retina_tpu_torch.plugins.api import Plugin


@registry.register
class MockPlugin(Plugin):
    name = "mock"

    fail_stage: str | None = None  # class-level test knob

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.calls: list[str] = []
        self.records_to_emit: np.ndarray | None = None
        self.started = threading.Event()

    def _maybe_fail(self, stage: str) -> None:
        self.calls.append(stage)
        if MockPlugin.fail_stage == stage:
            raise RuntimeError(f"mock failure at {stage}")

    def generate(self) -> None:
        self._maybe_fail("generate")

    def compile(self) -> None:
        self._maybe_fail("compile")

    def init(self) -> None:
        self._maybe_fail("init")

    def start(self, stop: threading.Event) -> None:
        self._maybe_fail("start")
        self.started.set()
        if self.records_to_emit is None:
            self.records_to_emit = np.zeros((4, NUM_FIELDS), np.uint32)
        while not stop.is_set():
            self.emit(self.records_to_emit)
            stop.wait(0.01)

    def stop(self) -> None:
        self.calls.append("stop")
