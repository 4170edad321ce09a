"""Managed capture storage provisioning (port of retina_tpu/capture/managed.py).

Reference analog: pkg/capture/outputlocation/managed/storageaccount.go
:1-358 — when a Capture names NO output location and managed storage is
enabled, the operator provisions a storage account (idempotently, found
again across restarts by its ``createdBy=retina`` tag), attaches a
7-day auto-delete lifecycle policy, creates one container per capture
namespace (``retina-capture-<ns>``) with a 3-day immutability window,
and mints a write-only container SAS whose expiry is
``max(2 x capture duration, 10 min)``.

The Azure ARM calls sit behind an injectable :class:`CloudStorageClient`
seam (the azclients.AZClients analog): deployments plug in a real cloud
client; tests plug in a fake and assert the provisioning contract. No
cloud SDK import exists in this module.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Protocol

from retina_tpu_torch.log import logger

DEFAULT_CONTAINER = "retina-capture"
ACCOUNT_PREFIX = "retinacapture"
TAG_CREATED_BY = "createdBy"
TAG_VALUE = "retina"

# SAS expiry floor and multiplier (storageaccount.go:26-37).
EXPIRY_FLOOR_S = 10 * 60
DURATION_MULTIPLIER = 2

RETAIN_BLOB_DAYS = 7  # lifecycle auto-delete (:184-212)
IMMUTABILITY_DAYS = 3  # container immutability window (:29-32)


class CloudStorageClient(Protocol):
    """The cloud-provider seam (azclients.AZClients analog)."""

    def list_accounts(self) -> list[dict]:
        """[{"name": str, "tags": {str: str}}, ...] in the resource
        group."""

    def create_account(self, name: str, params: dict) -> None:
        """Idempotent storage-account creation."""

    def set_management_policy(self, account: str, policy: dict) -> None:
        ...

    def create_container(self, account: str, container: str) -> None:
        ...

    def set_immutability_policy(
        self, account: str, container: str, days: int
    ) -> None:
        ...

    def container_sas_url(
        self, account: str, container: str, expiry_s: float,
        permissions: str,
    ) -> str:
        """Write-scoped container SAS URL."""


class StorageAccountManager:
    """Idempotent managed-storage lifecycle (StorageAccountManager)."""

    def __init__(
        self,
        client: CloudStorageClient,
        unique_container_per_namespace: bool = True,
    ):
        self._log = logger("capture.managed")
        self.client = client
        self.unique_container_per_namespace = unique_container_per_namespace
        self.account: str = ""
        # Container-creation cache (:59-67): creation is idempotent, the
        # cache only trims provider API calls.
        self._containers: set[str] = set()
        self._lock = threading.Lock()

    # -- setup (storageaccount.go:131-227) ----------------------------
    def setup(self) -> None:
        """Find the tagged account from a previous run or create a new
        one, then attach the auto-delete lifecycle policy. Every step is
        idempotent to withstand operator restarts."""
        existing = ""
        for acct in self.client.list_accounts():
            if (acct.get("tags") or {}).get(TAG_CREATED_BY) == TAG_VALUE:
                existing = acct["name"]
                break
        if existing:
            self.account = existing
            self._log.info("using existing storage account %s", existing)
        else:
            # Unique, 3-24 chars, lowercase+digits (:45-51).
            self.account = f"{ACCOUNT_PREFIX}{int(time.time())}"
            self._log.info("creating storage account %s", self.account)
            self.client.create_account(
                self.account,
                {
                    "kind": "StorageV2",
                    "sku": "Standard_LRS",
                    "access_tier": "Cool",
                    "tags": {TAG_CREATED_BY: TAG_VALUE},
                },
            )
        self.client.set_management_policy(
            self.account,
            {
                "rule": "auto-delete",
                "type": "Lifecycle",
                "blob_types": ["blockBlob"],
                "delete_after_days": RETAIN_BLOB_DAYS,
            },
        )
        if not self.unique_container_per_namespace:
            self._ensure_container(DEFAULT_CONTAINER)

    def container_for(self, namespace: str) -> str:
        if not self.unique_container_per_namespace:
            return DEFAULT_CONTAINER
        return f"{DEFAULT_CONTAINER}-{namespace}"

    def _ensure_container(self, container: str) -> None:
        with self._lock:
            if container in self._containers:
                return
        self.client.create_container(self.account, container)
        self.client.set_immutability_policy(
            self.account, container, IMMUTABILITY_DAYS
        )
        with self._lock:
            self._containers.add(container)

    # -- per-capture SAS (storageaccount.go:312-358) ------------------
    def create_container_sas_url(
        self, namespace: str, duration_s: float
    ) -> str:
        if not self.account:
            raise RuntimeError("storage manager not set up")
        container = self.container_for(namespace)
        self._ensure_container(container)
        expiry = max(
            DURATION_MULTIPLIER * duration_s, float(EXPIRY_FLOOR_S)
        )
        url = self.client.container_sas_url(
            self.account, container, expiry, permissions="w"
        )
        self._log.info(
            "minted managed SAS for %s (expiry %.0fs)", container, expiry
        )
        return url


def managed_manager_or_none(
    client: Optional[CloudStorageClient],
) -> Optional[StorageAccountManager]:
    """Construct + set up a manager when a cloud client is configured
    (controller.go:75-81: enabled iff the credential config exists)."""
    if client is None:
        return None
    mgr = StorageAccountManager(client)
    mgr.setup()
    return mgr
