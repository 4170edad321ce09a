"""CRD self-registration (port of retina_tpu/operator/crdinstall.py).

Reference analog: deploy/standard/registercrd.go — the operator embeds
its CRD YAMLs and applies them at startup when ``InstallCRDs`` is set
(operator/cmd/standard/deployment.go:149), so a bare cluster needs no
separate install step. Here the manifests are GENERATED from this module
(the container ships no YAML files); ``deploy/manifests/crds.yaml`` is
the rendered copy for ``kubectl apply`` flows, and a test keeps the two
identical.
"""

from __future__ import annotations

import json
import urllib.error
from typing import Any

from retina_tpu_torch.log import logger
from retina_tpu_torch.operator.kubeclient import KubeClient

APIEXT_V1 = "/apis/apiextensions.k8s.io/v1"

# kind -> (plural, spec description, status description, printer columns)
_CRDS: dict[str, tuple[str, str, str, list[dict]]] = {
    "Capture": (
        "captures",
        "Capture spec (crd/types.py CaptureSpec): captureTarget "
        "(nodeSelector/nodeNames XOR podSelector/namespaceSelector), "
        "outputConfiguration (hostPath / persistentVolumeClaim / "
        "blobUpload / s3Upload), duration (seconds, <= 3600), "
        "tcpdumpFilter.",
        "Written by the operator via the status subresource: phase "
        "(Pending|Running|Completed|Failed), jobs_active, "
        "jobs_completed, jobs_failed, message, artifacts.",
        [
            {"name": "Phase", "type": "string",
             "jsonPath": ".status.phase"},
            {"name": "Completed", "type": "integer",
             "jsonPath": ".status.jobs_completed"},
            {"name": "Age", "type": "date",
             "jsonPath": ".metadata.creationTimestamp"},
        ],
    ),
    "MetricsConfiguration": (
        "metricsconfigurations",
        "MetricsSpec (crd/types.py): contextOptions (metricName + "
        "sourceLabels/destinationLabels/additionalLabels), "
        "namespaces.include XOR namespaces.exclude.",
        "",
        [],
    ),
    "TracesConfiguration": ("tracesconfigurations", "", "", []),
}


def crd_manifests() -> list[dict[str, Any]]:
    """The CustomResourceDefinition docs for every retina.sh kind."""
    out = []
    for kind, (plural, spec_desc, status_desc, cols) in _CRDS.items():
        def prop(desc: str) -> dict:
            p: dict[str, Any] = {
                "type": "object",
                "x-kubernetes-preserve-unknown-fields": True,
            }
            if desc:
                p["description"] = desc
            return p

        version: dict[str, Any] = {
            "name": "v1alpha1",
            "served": True,
            "storage": True,
            "subresources": {"status": {}},
            "schema": {
                "openAPIV3Schema": {
                    "type": "object",
                    "properties": {
                        "spec": prop(spec_desc),
                        "status": prop(status_desc),
                    },
                },
            },
        }
        if cols:
            version["additionalPrinterColumns"] = cols
        out.append({
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "CustomResourceDefinition",
            "metadata": {"name": f"{plural}.retina.sh"},
            "spec": {
                "group": "retina.sh",
                "names": {
                    "categories": ["retina"],
                    "kind": kind,
                    "listKind": f"{kind}List",
                    "plural": plural,
                    "singular": kind.lower(),
                },
                "scope": "Namespaced",
                "versions": [version],
            },
        })
    return out


def render(path: str = "deploy/manifests/crds.yaml") -> None:
    """Regenerate the rendered YAML copy of the manifests, byte for byte
    the reference's (its header names the reference's generator, which
    renders the same file)."""
    import yaml

    header = (
        "# CustomResourceDefinitions for the retina.sh API group — what "
        "the\n# operator's kube backend (retina_tpu/operator/bridge.py "
        "KubeBridge) and\n# kubectl-retina work against. GENERATED from\n"
        "# retina_tpu/operator/crdinstall.py (the operator can also "
        "self-install\n# these with --install-crds, the registercrd.go "
        "analog); a test keeps\n# this file and the code in sync. "
        "Regenerate with:\n#   python -c \"from "
        "retina_tpu.operator.crdinstall import render; render()\"\n"
    )
    body = "".join(
        "---\n" + yaml.safe_dump(d, sort_keys=False)
        for d in crd_manifests()
    )
    with open(path, "w") as fh:
        fh.write(header + body)


def install_crds(client: KubeClient, timeout: float = 30.0) -> int:
    """POST each CRD; on AlreadyExists, PUT the current manifest over it
    so upgrades take effect (registercrd.go applies, not create-only).
    Best effort with a short timeout — a black-holed apiserver must not
    stall operator startup. Returns created+updated count."""
    log = logger("crdinstall")
    applied = 0
    base = client.url(APIEXT_V1, "customresourcedefinitions")
    for doc in crd_manifests():
        name = doc["metadata"]["name"]
        try:
            client.request(base, method="POST",
                           body=json.dumps(doc).encode(),
                           timeout=timeout).close()
            applied += 1
            log.info("installed CRD %s", name)
        except urllib.error.HTTPError as e:
            if e.code != 409:
                log.warning("CRD %s install failed: HTTP %d",
                            name, e.code)
                continue
            try:
                applied += self_update(client, doc, timeout)
            except Exception as e2:  # noqa: BLE001
                log.warning("CRD %s update failed: %s", name, e2)
        except Exception as e:  # noqa: BLE001 — install is best effort
            log.warning("CRD %s install failed: %s", name, e)
    return applied


def self_update(client: KubeClient, doc: dict, timeout: float) -> int:
    """Update an existing CRD to the current manifest (upgrade path).
    Returns 1 when a PUT was issued, 0 when already current."""
    log = logger("crdinstall")
    name = doc["metadata"]["name"]
    url = client.url(APIEXT_V1, "customresourcedefinitions",
                     suffix=f"/{name}")
    with client.request(url, timeout=timeout) as r:
        cur = json.load(r)
    if cur.get("spec") == doc["spec"]:
        log.debug("CRD %s already current", name)
        return 0
    merged = dict(doc)
    merged["metadata"] = {
        **doc["metadata"],
        "resourceVersion": cur["metadata"]["resourceVersion"],
    }
    client.request(url, method="PUT",
                   body=json.dumps(merged).encode(),
                   timeout=timeout).close()
    log.info("updated CRD %s", name)
    return 1
