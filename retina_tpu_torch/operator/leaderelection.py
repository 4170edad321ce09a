"""Lease-based leader election for the operator (port of
retina_tpu/operator/leaderelection.py).

Reference analog: operator/cmd/root.go:21-39 — the standard operator
passes ``--enable-leader-election`` into controller-runtime, which
arbitrates a ``coordination.k8s.io/v1`` Lease so exactly one replica
reconciles; the cilium-crds cell configures the same via
LeaderElectionLeaseDuration/RenewDeadline (cells_linux.go:245).

Same protocol here on the stdlib client, with client-go's two key
robustness properties preserved:

- **Skew-safe expiry**: a follower never compares the remote renewTime
  against its own wall clock (clocks across replicas disagree). It times
  the lease from when it *locally observed* the current (holder,
  renewTime) pair, and only seizes after a full lease duration passes
  with no change — so a leader with a slow clock is not deposed early
  and two leaders cannot overlap.
- **Renew grace**: a leader keeps leadership through transient renew
  errors until the lease it last wrote would itself have expired
  (the renew-deadline), rather than flapping demote/promote on one
  connection reset. Losing the lease to another live holder demotes
  immediately.

Writes use resourceVersion preconditions so two candidates racing a
takeover cannot both win — the apiserver rejects the stale write with
409.
"""

from __future__ import annotations

import datetime
import json
import socket
import threading
import time
import urllib.error
from typing import Callable, Optional

from retina_tpu_torch.log import logger
from retina_tpu_torch.operator.kubeclient import KubeClient

COORD_V1 = "/apis/coordination.k8s.io/v1"


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def _fmt(ts: datetime.datetime) -> str:
    # k8s MicroTime format.
    return ts.strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z"


def _parse(ts: str) -> Optional[datetime.datetime]:
    if not ts:
        return None
    try:
        return datetime.datetime.strptime(
            ts.rstrip("Z"), "%Y-%m-%dT%H:%M:%S.%f"
        ).replace(tzinfo=datetime.timezone.utc)
    except ValueError:
        try:
            return datetime.datetime.strptime(
                ts.rstrip("Z"), "%Y-%m-%dT%H:%M:%S"
            ).replace(tzinfo=datetime.timezone.utc)
        except ValueError:
            return None


class LeaderElector:
    """Acquire/renew a Lease; exactly one identity leads at a time."""

    def __init__(
        self,
        client: KubeClient,
        name: str = "retina-tpu-operator",
        namespace: str = "kube-system",
        identity: str = "",
        lease_duration_s: float = 15.0,
        renew_period_s: float = 5.0,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ):
        self._log = logger("leaderelection")
        self.client = client
        self.name = name
        self.namespace = namespace
        self.identity = identity or f"{socket.gethostname()}-{id(self):x}"
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leading = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Skew-safe follower state: the (holder, renewTime) pair we last
        # saw and WHEN WE saw it (local monotonic clock).
        self._observed: Optional[tuple[str, str]] = None
        self._observed_at = 0.0
        # Renew grace: when our own last successful write happened.
        self._last_write_ok = 0.0
        self._err_streak = 0

    # -- REST ----------------------------------------------------------
    def _url(self, suffix: str = "") -> str:
        return self.client.url(COORD_V1, "leases",
                               namespace=self.namespace, suffix=suffix)

    def _get_lease(self) -> Optional[dict]:
        """Returns the lease, None for 404, raises on other errors."""
        try:
            with self.client.request(self._url(f"/{self.name}")) as r:
                return json.load(r)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def _write_lease(self, lease: dict, create: bool) -> bool:
        """True on success; False when another writer won (409/404 on
        create); raises on auth/transport errors so the caller can tell
        'lost the race' from 'cluster problem'."""
        body = json.dumps(lease).encode()
        try:
            if create:
                self.client.request(self._url(), method="POST",
                                    body=body).close()
            else:
                self.client.request(self._url(f"/{self.name}"),
                                    method="PUT", body=body).close()
            self._last_write_ok = time.monotonic()
            return True
        except urllib.error.HTTPError as e:
            if e.code in (409, 404):
                self._log.debug("lease write lost the race (%d)", e.code)
                return False
            raise

    # -- election ------------------------------------------------------
    def try_acquire_or_renew(self) -> bool:
        """One election round; returns whether we lead afterwards."""
        lease = self._get_lease()
        now = _now()
        if lease is None:
            new = {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": {"name": self.name,
                             "namespace": self.namespace},
                "spec": {
                    "holderIdentity": self.identity,
                    # k8s field is integer seconds; 0 would mean
                    # instantly-expired, so clamp to >=1.
                    "leaseDurationSeconds": max(
                        1, int(self.lease_duration_s)),
                    "acquireTime": _fmt(now),
                    "renewTime": _fmt(now),
                    "leaseTransitions": 0,
                },
            }
            return self._write_lease(new, create=True)

        spec = lease.get("spec", {}) or {}
        holder = spec.get("holderIdentity", "")
        duration = float(spec.get("leaseDurationSeconds",
                                  self.lease_duration_s))
        if holder == self.identity:
            spec["renewTime"] = _fmt(now)
        elif holder:
            # Skew-safe expiry: never trust the remote timestamp against
            # our wall clock. Time the (holder, renewTime) pair on OUR
            # monotonic clock from first observation; seize only after a
            # full duration with no renewal observed.
            key = (holder, spec.get("renewTime", ""))
            mono = time.monotonic()
            if key != self._observed:
                self._observed = key
                self._observed_at = mono
                return False  # freshly observed: not ours this round
            if mono - self._observed_at <= duration:
                return False  # holder's lease still live by our watch
            self._take_over(spec, now)
        else:
            # Empty holder = gracefully released.
            self._take_over(spec, now)
        lease["spec"] = spec
        # resourceVersion rides along: a concurrent takeover bumps it and
        # our stale PUT is rejected with 409 -> we did NOT win.
        return self._write_lease(lease, create=False)

    def _take_over(self, spec: dict, now: datetime.datetime) -> None:
        spec["holderIdentity"] = self.identity
        spec["acquireTime"] = _fmt(now)
        spec["renewTime"] = _fmt(now)
        spec["leaseDurationSeconds"] = max(1, int(self.lease_duration_s))
        spec["leaseTransitions"] = int(spec.get("leaseTransitions", 0)) + 1

    def _set_leading(self, leading: bool) -> None:
        if leading == self._leading:
            return
        self._leading = leading
        self._log.info("%s leading (identity=%s)",
                       "started" if leading else "stopped", self.identity)
        cb = self.on_started_leading if leading else self.on_stopped_leading
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001
                self._log.exception("leader transition callback failed")

    def is_leader(self) -> bool:
        return self._leading

    # -- lifecycle -----------------------------------------------------
    def run_once(self) -> None:
        try:
            self._set_leading(self.try_acquire_or_renew())
            self._err_streak = 0
        except Exception as e:  # noqa: BLE001 — election never kills op
            self._err_streak += 1
            level = (self._log.warning if self._err_streak >= 3
                     else self._log.debug)
            level("election round failed (streak %d): %s: %s",
                  self._err_streak, type(e).__name__, e)
            if self._leading and (
                    time.monotonic() - self._last_write_ok
                    <= self.lease_duration_s):
                # Renew grace: the lease we wrote is still live; one
                # transient error must not flap leadership.
                return
            self._set_leading(False)

    def start(self) -> None:
        def loop() -> None:
            while not self._stop.is_set():
                self.run_once()
                self._stop.wait(self.renew_period_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="leaderelection")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
        if self._leading:
            # Graceful release: zero the holder so a peer takes over
            # immediately instead of waiting out the lease.
            try:
                lease = self._get_lease()
                if lease is not None and (
                        lease.get("spec", {}).get("holderIdentity")
                        == self.identity):
                    lease["spec"]["holderIdentity"] = ""
                    self._write_lease(lease, create=False)
            except Exception as e:  # noqa: BLE001 — best effort
                self._log.warning("lease release failed: %s", e)
            self._set_leading(False)
