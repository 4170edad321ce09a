"""kind-backed e2e harness (port of retina_tpu/e2e/kind.py): real cluster,
real helm chart, real scrape.

Reference analog: test/e2e/retina_e2e_test.go:19-66 + framework/
scaffold — the reference creates an AKS/kind cluster, helm-installs
retina, drives scenario jobs (drop, dns, ...), and asserts Prometheus
series through the deployed agent. Here:

- the chart (the repo's shared ``deploy/helm/retina-tpu``) renders through
  the package's CLI (``python -m retina_tpu_torch deploy render``) ->
  kubectl apply;
- the agent image is the repo's deploy/Dockerfile built locally and
  ``kind load``-ed (pullPolicy Never);
- scenarios reuse the SAME step DSL as the in-process e2e
  (e2e/framework.py) with cluster-backed steps;
- assertions parse the agent's real /metrics exposition fetched with
  ``kubectl exec`` (e2e/prometheus.py).

Everything shells out to kind/kubectl/docker, so it runs only where those
exist, and only on opt-in: ``RETINA_KIND_E2E=1``. Without the opt-in, or
without a tool, the first step's prevalidation refuses with
:class:`StepFailed` before anything runs. The CLI's ``deploy`` verb is not
ported yet (ROADMAP §1 item 7.5): ``InstallChart`` refuses without it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any

from retina_tpu_torch.e2e.framework import Step, StepFailed
from retina_tpu_torch.e2e.prometheus import parse_exposition
from retina_tpu_torch.log import logger

_log = logger("e2e.kind")

KIND_VALUES = {
    # kind nodes have no accelerator: drop the scheduling constraints and
    # capture live AF_PACKET traffic inside the node netns.
    "image.tag": "e2e",
    "image.pullPolicy": "Never",
    "agent.nodeSelector": "",
    "agent.tolerations": "",
    "agent.resources.limits": "",
    "agent.shapes.nPods": "256",
    "agent.batchCapacity": "16384",
}


OPT_IN = "RETINA_KIND_E2E"  # the harness runs only with this set to "1"


def kind_enabled() -> bool:
    """Whether the cluster harness is opted in (``RETINA_KIND_E2E=1``)."""
    return os.environ.get(OPT_IN) == "1"


def sh(*cmd: str, timeout: float = 600, check: bool = True,
       capture: bool = True) -> str:
    _log.info("$ %s", " ".join(cmd))
    try:
        res = subprocess.run(
            cmd, timeout=timeout, text=True,
            capture_output=capture,
        )
    except FileNotFoundError as e:
        raise StepFailed(f"{cmd[0]} not found: {e}") from e
    if check and res.returncode != 0:
        raise StepFailed(
            f"command failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{(res.stdout or '')[-2000:]}\n{(res.stderr or '')[-2000:]}"
        )
    return res.stdout or ""


def cli_verbs() -> set[str]:
    """The subcommands of the package's CLI."""
    import argparse

    from retina_tpu_torch import cli

    return {verb for a in cli.build_parser()._actions
            if isinstance(a, argparse._SubParsersAction) for verb in a.choices}


class CreateKindCluster(Step):
    name = "create-kind-cluster"

    def __init__(self, cluster: str = "retina-tpu-e2e"):
        self.cluster = cluster

    def prevalidate(self, ctx: dict[str, Any]) -> None:
        if not kind_enabled():
            raise StepFailed(
                f"the kind harness is opt-in: set {OPT_IN}=1 "
                "(needs kind/kubectl/docker)"
            )
        for tool in ("kind", "kubectl", "docker"):
            sh(tool, "--help", timeout=30)

    def run(self, ctx: dict[str, Any]) -> None:
        existing = sh("kind", "get", "clusters", check=False)
        if self.cluster not in existing.split():
            sh("kind", "create", "cluster", "--name", self.cluster,
               "--wait", "120s", timeout=600)
        ctx["cluster"] = self.cluster
        ctx["kubectl"] = ("kubectl", "--context", f"kind-{self.cluster}")

    def cleanup(self, ctx: dict[str, Any]) -> None:
        if ctx.get("keep_cluster"):
            return
        sh("kind", "delete", "cluster", "--name", self.cluster,
           check=False)


class BuildAndLoadImage(Step):
    name = "build-and-load-image"

    def run(self, ctx: dict[str, Any]) -> None:
        sh("docker", "build", "-f", "deploy/Dockerfile",
           "-t", "retina-tpu:e2e", ".", timeout=1800)
        sh("kind", "load", "docker-image", "retina-tpu:e2e",
           "--name", ctx["cluster"], timeout=600)


class InstallChart(Step):
    """Render with OUR renderer, apply with kubectl (helm-free path the
    CLI ships; `helm install deploy/helm/retina-tpu` works identically
    because templates stick to the helmlite subset)."""

    name = "install-chart"

    def __init__(self, namespace: str = "retina"):
        self.namespace = namespace

    def prevalidate(self, ctx: dict[str, Any]) -> None:
        if "deploy" not in cli_verbs():
            raise StepFailed(
                "the CLI has no deploy verb yet (ROADMAP §1 item 7.5): "
                "the chart cannot render"
            )

    def run(self, ctx: dict[str, Any]) -> None:
        sets = [f"{k}={v}" for k, v in KIND_VALUES.items()]
        out = sh(
            sys.executable, "-m", "retina_tpu_torch", "deploy", "render",
            "--namespace", self.namespace,
            *[a for kv in sets for a in ("--set", kv)],
        )
        kubectl = ctx["kubectl"]
        sh(*kubectl, "create", "namespace", self.namespace, check=False)
        with tempfile.NamedTemporaryFile(
            "w", suffix=".yaml", delete=False
        ) as f:
            f.write(out)
            path = f.name
        sh(*kubectl, "apply", "-n", self.namespace, "-f", path)
        ctx["namespace"] = self.namespace

    def cleanup(self, ctx: dict[str, Any]) -> None:
        kubectl = ctx.get("kubectl")
        if kubectl and not ctx.get("keep_cluster"):
            sh(*kubectl, "delete", "namespace", self.namespace,
               check=False, timeout=180)


class WaitAgentReady(Step):
    name = "wait-agent-ready"

    def __init__(self, timeout_s: float = 420.0):
        self.timeout_s = timeout_s

    def run(self, ctx: dict[str, Any]) -> None:
        kubectl, ns = ctx["kubectl"], ctx["namespace"]
        sh(*kubectl, "-n", ns, "rollout", "status",
           "daemonset/retina-tpu-agent",
           f"--timeout={int(self.timeout_s)}s",
           timeout=self.timeout_s + 30)
        pods = json.loads(sh(
            *kubectl, "-n", ns, "get", "pods", "-l",
            "app=retina-tpu-agent", "-o", "json",
        ))
        names = [p["metadata"]["name"] for p in pods["items"]]
        if not names:
            raise StepFailed("no agent pods scheduled")
        ctx["agent_pod"] = names[0]


class GenerateClusterTraffic(Step):
    """Drive the drop + dns scenarios with REAL cluster traffic: DNS
    lookups resolve through kube-dns (the dns scenario) and connects to
    a port nothing listens on produce failed/denied flows (the drop
    scenario's traffic shape, scenario.go:19-60)."""

    name = "generate-traffic"

    def run(self, ctx: dict[str, Any]) -> None:
        kubectl, ns = ctx["kubectl"], ctx["namespace"]
        script = (
            "for i in $(seq 1 40); do "
            "nslookup kubernetes.default.svc.cluster.local >/dev/null 2>&1; "
            "wget -q -T 1 -O- http://10.96.255.254:9/ >/dev/null 2>&1; "
            "done; echo traffic-done"
        )
        out = sh(
            *kubectl, "-n", ns, "run", "trafficgen", "--rm", "-i",
            "--restart=Never", "--image=busybox:1.36", "--", "sh", "-c",
            script, timeout=300,
        )
        if "traffic-done" not in out:
            raise StepFailed(f"traffic generator failed: {out[-500:]}")

    def cleanup(self, ctx: dict[str, Any]) -> None:
        kubectl, ns = ctx.get("kubectl"), ctx.get("namespace")
        if kubectl:
            sh(*kubectl, "-n", ns, "delete", "pod", "trafficgen",
               check=False)


class ScrapeDeployedAgent(Step):
    """Fetch /metrics from inside the agent pod and parse the
    exposition; retries until the expected families appear (publish
    cadence + first-window lag)."""

    name = "scrape-deployed-agent"

    def __init__(self, required: tuple[str, ...] = (), timeout_s: float = 120.0):
        self.required = required
        self.timeout_s = timeout_s

    def run(self, ctx: dict[str, Any]) -> None:
        kubectl, ns = ctx["kubectl"], ctx["namespace"]
        pod = ctx["agent_pod"]
        deadline = time.monotonic() + self.timeout_s
        last = ""
        while time.monotonic() < deadline:
            last = sh(
                *kubectl, "-n", ns, "exec", pod, "--",
                "python", "-c",
                "import urllib.request;"
                "print(urllib.request.urlopen("
                "'http://127.0.0.1:10093/metrics').read().decode())",
                check=False, timeout=60,
            )
            samples = parse_exposition(last)
            fams = {s.name for s in samples}
            if all(any(r in f for f in fams) for r in self.required):
                ctx["samples"] = samples
                return
            time.sleep(5)
        raise StepFailed(
            f"required families {self.required} not found; got "
            f"{sorted({s.name for s in parse_exposition(last)})[:40]}"
        )
