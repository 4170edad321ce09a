"""Minimal kube-apiserver REST client on the standard library (port of
retina_tpu/operator/kubeclient.py).

The reference talks to the apiserver through client-go informers
(pkg/k8s/watcher_linux.go, controller-runtime managers); with no
``kubernetes`` package the same REST contract — kubeconfig auth, LIST,
chunked WATCH with resourceVersion resumption, subresource PATCH — is
implemented directly on :mod:`urllib`. Shared by the CR bridge
(:class:`~retina_tpu_torch.operator.bridge.KubeBridge`), the core/v1
identity watcher (:class:`~retina_tpu_torch.operator.kubewatch.CoreWatcher`),
the Cilium interop and the leader election. PyYAML is imported only to
read a kubeconfig.

One addition to the reference's ``list_watch``: ``list_scope``, a context
manager factory entered around each LIST's replay (its ``ADDED`` events
and ``on_sync``). The agent passes one that holds the filter table's push
until the LIST's pod events have been delivered, so a LIST of N pods
pushes the table once, not N times (ROADMAP §3 "Settled").
"""

from __future__ import annotations

import base64
import contextlib
import json
import os
import ssl
import tempfile
import threading
import urllib.request
from typing import Any, Callable, ContextManager, Optional

# In-cluster service-account paths (what client-go's rest.InClusterConfig
# reads when a pod runs with a serviceAccountName).
SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def in_cluster_available(sa_dir: str = SA_DIR) -> bool:
    return bool(os.environ.get("KUBERNETES_SERVICE_HOST")) and os.path.exists(
        os.path.join(sa_dir, "token")
    )


class KubeClient:
    """kubeconfig- or service-account-authenticated REST to one apiserver.

    ``kubeconfig=""`` selects in-cluster config (the deployment path: the
    daemonset runs with a service account and no kubeconfig file), reading
    KUBERNETES_SERVICE_HOST/PORT and the mounted SA token + CA.
    """

    def __init__(self, kubeconfig: str = "", sa_dir: str = SA_DIR):
        if kubeconfig:
            self._load_kubeconfig(kubeconfig)
        elif in_cluster_available(sa_dir):
            self._load_in_cluster(sa_dir)
        else:
            raise ValueError(
                "no kubeconfig given and not running in-cluster "
                "(KUBERNETES_SERVICE_HOST unset or no service-account token)"
            )

    def _load_in_cluster(self, sa_dir: str) -> None:
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.server = f"https://{host}:{port}"
        with open(os.path.join(sa_dir, "token")) as fh:
            self.token = fh.read().strip()
        self._ssl_ctx = ssl.create_default_context()
        ca = os.path.join(sa_dir, "ca.crt")
        if os.path.exists(ca):
            self._ssl_ctx.load_verify_locations(cafile=ca)

    # -- kubeconfig ----------------------------------------------------
    def _load_kubeconfig(self, path: str) -> None:
        import yaml  # only here: the agent imports no YAML parser otherwise

        with open(path) as fh:
            kc = yaml.safe_load(fh) or {}
        clusters = kc.get("clusters") or []
        if not clusters:
            raise ValueError(f"kubeconfig {path}: no clusters defined")
        contexts = kc.get("contexts") or []
        ctx_name = kc.get("current-context", "")
        ctx = next(
            (c.get("context", {}) for c in contexts
             if c.get("name") == ctx_name),
            contexts[0].get("context", {}) if contexts else {},
        )
        want_cluster = ctx.get("cluster", clusters[0].get("name"))
        cluster = next(
            (c["cluster"] for c in clusters
             if c.get("name") == want_cluster), None,
        )
        if cluster is None:
            raise ValueError(
                f"kubeconfig {path}: context references unknown cluster "
                f"{want_cluster!r}"
            )
        users = kc.get("users") or []
        user = next(
            (u.get("user", {}) for u in users
             if u.get("name") == ctx.get("user")),
            users[0].get("user", {}) if users else {},
        )
        if not cluster.get("server"):
            raise ValueError(f"kubeconfig {path}: cluster has no server URL")
        self.server = cluster["server"].rstrip("/")
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if self.server.startswith("https"):
            self._ssl_ctx = ssl.create_default_context()
            ca_data = cluster.get("certificate-authority-data")
            ca_file = cluster.get("certificate-authority")
            if ca_data:
                self._ssl_ctx.load_verify_locations(
                    cadata=base64.b64decode(ca_data).decode()
                )
            elif ca_file:
                self._ssl_ctx.load_verify_locations(cafile=ca_file)
            if cluster.get("insecure-skip-tls-verify"):
                self._ssl_ctx.check_hostname = False
                self._ssl_ctx.verify_mode = ssl.CERT_NONE
            cert_data = user.get("client-certificate-data")
            key_data = user.get("client-key-data")
            if cert_data and key_data:
                # load_cert_chain needs files; materialize with 0600.
                fd, certpath = tempfile.mkstemp(suffix=".pem")
                with os.fdopen(fd, "wb") as fh:
                    fh.write(base64.b64decode(cert_data))
                    fh.write(b"\n")
                    fh.write(base64.b64decode(key_data))
                self._ssl_ctx.load_cert_chain(certpath)
                os.unlink(certpath)
            elif user.get("client-certificate"):
                self._ssl_ctx.load_cert_chain(
                    user["client-certificate"], user.get("client-key")
                )
        self.token = user.get("token", "")

    # -- REST ----------------------------------------------------------
    def url(self, api_base: str, plural: str, namespace: str = "",
            suffix: str = "", query: str = "") -> str:
        """``api_base`` is e.g. ``/api/v1`` or ``/apis/retina.sh/v1alpha1``."""
        ns = f"/namespaces/{namespace}" if namespace else ""
        u = f"{self.server}{api_base}{ns}/{plural}{suffix}"
        return u + (f"?{query}" if query else "")

    def request(self, url: str, method: str = "GET",
                body: bytes | None = None,
                content_type: str = "application/json",
                timeout: float = 300):
        req = urllib.request.Request(url, data=body, method=method)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        if body is not None:
            req.add_header("Content-Type", content_type)
        return urllib.request.urlopen(req, context=self._ssl_ctx,
                                      timeout=timeout)

    # -- list + watch --------------------------------------------------
    def list_watch(
        self,
        api_base: str,
        plural: str,
        on_event: Callable[[str, dict], None],
        stop: threading.Event,
        namespace: str = "",
        retry_s: float = 2.0,
        log: Any = None,
        on_sync: Optional[Callable[[list[dict]], None]] = None,
        watch_timeout_s: int = 240,
        list_scope: Optional[Callable[[], ContextManager]] = None,
    ) -> None:
        """The client-go informer loop, minus the local store.

        LIST once, then WATCH with resourceVersion continuation: the
        server closes the stream after ``watch_timeout_s``
        (``timeoutSeconds``) and the loop re-WATCHes from the last seen
        resourceVersion WITHOUT re-listing — bookmarks keep the rv fresh
        on quiet streams, so an idle cluster costs one tiny request per
        cycle, not a full collection LIST. A connection failure or an
        ERROR event (410 Gone) falls back to a fresh LIST.

        ``on_sync(metadatas)`` fires after every LIST with the metadata of
        every listed item, so the consumer can delete objects that
        vanished while the watch was down (informer resync semantics —
        an upsert stream cannot express a missed delete). ``list_scope()``
        is entered around each LIST's ``ADDED`` events and ``on_sync``.
        """
        rv = ""
        need_list = True
        scope = list_scope or contextlib.nullcontext
        while not stop.is_set():
            try:
                if need_list:
                    with self.request(self.url(api_base, plural,
                                               namespace=namespace)) as resp:
                        body = json.load(resp)
                    rv = body.get("metadata", {}).get("resourceVersion", "")
                    items = body.get("items", [])
                    with scope():
                        for item in items:
                            on_event("ADDED", item)
                        if on_sync is not None:
                            on_sync([it.get("metadata", {}) or {}
                                     for it in items])
                    need_list = False
                q = (
                    "watch=true&allowWatchBookmarks=true"
                    f"&timeoutSeconds={watch_timeout_s}"
                    + (f"&resourceVersion={rv}" if rv else "")
                )
                with self.request(
                    self.url(api_base, plural, namespace=namespace, query=q),
                    timeout=watch_timeout_s + 60,
                ) as stream:
                    for line in stream:
                        if stop.is_set():
                            return
                        if not line.strip():
                            continue
                        ev = json.loads(line)
                        etype = ev.get("type", "")
                        obj = ev.get("object", {}) or {}
                        if etype == "ERROR":
                            # e.g. 410 Gone: rv too old — full resync.
                            need_list = True
                            rv = ""
                            break
                        new_rv = (obj.get("metadata", {}) or {}).get(
                            "resourceVersion", "")
                        if new_rv:
                            rv = new_rv
                        if etype == "BOOKMARK":
                            continue
                        on_event(etype, obj)
                # Clean server-side close: loop re-watches from rv with no
                # LIST and no backoff.
                continue
            except Exception as e:  # noqa: BLE001 — watch never dies
                if stop.is_set():
                    return
                need_list = True
                if log is not None:
                    log.warning(
                        "%s list/watch failed (%s: %s); retrying in %.1fs",
                        plural, type(e).__name__, e, retry_s,
                    )
            stop.wait(retry_s)
