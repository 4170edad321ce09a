"""Core/v1 identity watchers: pods, services, nodes → identity cache (port
of retina_tpu/operator/kubewatch.py).

Reference analogs:
- pkg/k8s/watcher_linux.go — the agent's apiserver watcher layer.
- pkg/controllers/daemon/pod/controller.go:38-86 — Pod → slim
  RetinaEndpoint into the cache; host-network pods ignored; pods without
  an IP skipped; deletion (or deletionTimestamp) removes the endpoint.
- pkg/controllers/daemon/service/controller.go — Service → RetinaSvc.
- pkg/controllers/daemon/node/controller.go — Node → RetinaNode.

Design: one list+watch thread per resource over the shared
:class:`~retina_tpu_torch.operator.kubeclient.KubeClient`. Translation is
pure (`pod_to_endpoint` etc.) so it is testable without an apiserver;
events land as upserts/deletes on
:class:`~retina_tpu_torch.controllers.cache.Cache`, which assigns the dense
pod indexes feeding the card's identity table — so a pod appearing in the
cluster becomes a joinable identity on the card after the next identity
rebuild. ``pod_list_scope`` is handed to the pod LIST (``list_watch``'s
``list_scope``): the agent's holds the filter table's push until the
LIST's pod events have been delivered.
"""

from __future__ import annotations

import threading
from typing import Callable, ContextManager, Optional

from retina_tpu_torch.common import (
    POD_ANNOTATION,
    POD_ANNOTATION_VALUE,
    RetinaEndpoint,
    RetinaNode,
    RetinaSvc,
)
from retina_tpu_torch.log import logger
from retina_tpu_torch.operator.kubeclient import KubeClient

CORE_V1 = "/api/v1"


# -- pure translations (controller.go Reconcile bodies) -----------------
def pod_to_endpoint(doc: dict) -> Optional[RetinaEndpoint]:
    """Pod → RetinaEndpoint; None = ignore (host-network or no IP yet,
    pod/controller.go:61-77)."""
    spec = doc.get("spec", {}) or {}
    status = doc.get("status", {}) or {}
    meta = doc.get("metadata", {}) or {}
    if spec.get("hostNetwork"):
        return None
    ips = tuple(
        e["ip"] for e in status.get("podIPs") or []
        if e.get("ip")
    ) or ((status.get("podIP"),) if status.get("podIP") else ())
    if not ips:
        return None
    return RetinaEndpoint(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        ips=ips,
        labels=tuple(sorted((meta.get("labels") or {}).items())),
        owner_refs=tuple(
            (r.get("kind", ""), r.get("name", ""))
            for r in meta.get("ownerReferences") or []
        ),
        containers=tuple(
            c.get("name", "") for c in spec.get("containers") or []
        ),
        annotations=tuple(sorted((meta.get("annotations") or {}).items())),
        node=spec.get("nodeName", ""),
    )


def service_to_svc(doc: dict) -> RetinaSvc:
    meta = doc.get("metadata", {}) or {}
    spec = doc.get("spec", {}) or {}
    status = doc.get("status", {}) or {}
    lb_ingress = (status.get("loadBalancer") or {}).get("ingress") or []
    return RetinaSvc(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        cluster_ip=(
            "" if spec.get("clusterIP") in (None, "None")
            else spec.get("clusterIP", "")
        ),
        lb_ip=(lb_ingress[0].get("ip", "") if lb_ingress else ""),
        selector=tuple(sorted((spec.get("selector") or {}).items())),
    )


def node_to_node(doc: dict) -> RetinaNode:
    meta = doc.get("metadata", {}) or {}
    status = doc.get("status", {}) or {}
    internal = next(
        (a.get("address", "") for a in status.get("addresses") or []
         if a.get("type") == "InternalIP"),
        "",
    )
    labels = meta.get("labels") or {}
    return RetinaNode(
        name=meta.get("name", ""),
        ip=internal,
        zone=labels.get("topology.kubernetes.io/zone", ""),
    )


def meta_keys(metas: list[dict]) -> set[str]:
    """The ns/name keys of a LIST's item metadata."""
    return {
        f"{m.get('namespace', 'default')}/{m.get('name', '')}"
        for m in metas
    }


class CoreWatcher:
    """Up to four list+watch loops feeding the identity cache.

    When active, this watcher OWNS pod/service identity in the cache:
    post-LIST resync deletes cache entries absent from the apiserver, so
    don't feed the same cache from another endpoint source concurrently
    (the two sources would fight; pick one per deployment, as the
    reference does with its enable-retina-endpoint switch).
    """

    def __init__(self, cache, kubeconfig: str, namespace: str = "",
                 retry_s: float = 2.0, include_pods: bool = True,
                 include_services: bool = True,
                 include_nodes: bool = True,
                 include_namespaces: bool = False,
                 on_pods_synced=None,
                 pod_list_scope: Optional[Callable[[], ContextManager]] = None):
        """``include_pods=False`` watches only services+nodes — used when
        pod identity comes from elsewhere (CiliumEndpoints); a pods-only
        watcher (others False) backs the operator's CEP publisher.
        ``include_namespaces`` adds the annotated-namespace watch (the
        enable_annotations opt-in path). ``on_pods_synced()`` fires after
        each pod LIST resync — the publisher's restart GC hook."""
        self._log = logger("kubewatch")
        self.cache = cache
        self.namespace = namespace  # "" = cluster-wide (pods/services)
        self.retry_s = retry_s
        self.include_pods = include_pods
        self.include_services = include_services
        self.include_nodes = include_nodes
        self.include_namespaces = include_namespaces
        self.on_pods_synced = on_pods_synced
        self.pod_list_scope = pod_list_scope
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.client = KubeClient(kubeconfig)

    # -- event handlers ------------------------------------------------
    def _on_pod(self, event: str, doc: dict) -> None:
        meta = doc.get("metadata", {}) or {}
        key = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
        deleting = (
            event == "DELETED" or meta.get("deletionTimestamp") is not None
        )
        if deleting:
            self.cache.delete_endpoint(key)
            return
        ep = pod_to_endpoint(doc)
        if ep is not None:
            self.cache.update_endpoint(ep)

    def _on_service(self, event: str, doc: dict) -> None:
        svc = service_to_svc(doc)
        if event == "DELETED":
            self.cache.delete_service(svc.key())
        else:
            self.cache.update_service(svc)

    def _on_node(self, event: str, doc: dict) -> None:
        # Node removal keeps the last-known entry (the cache has no node
        # delete either); stale nodes age out with the cluster.
        if event != "DELETED":
            self.cache.update_node(node_to_node(doc))

    def _on_namespace(self, event: str, doc: dict) -> None:
        """namespace_controller.go:54-62: the retina.sh=observe
        annotation opts a whole namespace into pod-level metrics."""
        meta = doc.get("metadata", {}) or {}
        name = meta.get("name", "")
        if not name:
            return
        annotated = (
            event != "DELETED"
            and meta.get("deletionTimestamp") is None
            and (meta.get("annotations") or {}).get(POD_ANNOTATION)
            == POD_ANNOTATION_VALUE
        )
        self.cache.set_annotated_namespace(name, annotated)

    # -- resync (informer semantics): a re-LIST after a dropped watch
    # must delete objects that vanished while disconnected, or stale
    # endpoints pin dense pod indexes forever.
    def _sync_pods(self, metas: list[dict]) -> None:
        listed = meta_keys(metas)
        for key in self.cache.list_endpoint_keys():
            if key not in listed:
                self.cache.delete_endpoint(key)
        if self.on_pods_synced is not None:
            self.on_pods_synced()

    def _sync_services(self, metas: list[dict]) -> None:
        listed = meta_keys(metas)
        for key in self.cache.list_service_keys():
            if key not in listed:
                self.cache.delete_service(key)

    def _sync_namespaces(self, metas: list[dict]) -> None:
        annotated = {
            m.get("name", "") for m in metas
            if (m.get("annotations") or {}).get(POD_ANNOTATION)
            == POD_ANNOTATION_VALUE
        }
        for ns in self.cache.annotated_namespaces() - annotated:
            self.cache.set_annotated_namespace(ns, False)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        plans = []
        if self.include_pods:
            plans.append(("pods", self._on_pod, self.namespace,
                          self._sync_pods, self.pod_list_scope))
        if self.include_services:
            plans.append(("services", self._on_service, self.namespace,
                          self._sync_services, None))
        if self.include_nodes:
            # cluster-scoped
            plans.append(("nodes", self._on_node, "", None, None))
        if self.include_namespaces:
            plans.append(("namespaces", self._on_namespace, "",
                          self._sync_namespaces, None))
        for plural, handler, ns, sync, scope in plans:
            t = threading.Thread(
                target=self.client.list_watch,
                args=(CORE_V1, plural),
                kwargs={
                    "on_event": handler,
                    "stop": self._stop,
                    "namespace": ns,
                    "retry_s": self.retry_s,
                    "log": self._log,
                    "on_sync": sync,
                    "list_scope": scope,
                },
                name=f"kubewatch-{plural}", daemon=True,
            )
            t.start()
            self._threads.append(t)
        self._log.info("core/v1 watchers (%s) at %s",
                       ",".join(p[0] for p in plans), self.client.server)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(2.0)
