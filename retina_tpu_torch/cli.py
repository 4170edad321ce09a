"""retina-tpu-torch CLI (port of retina_tpu/cli.py but its shell and deploy verbs).

Reference analog: cli/ (kubectl-retina) plus the agent binary
(controller/main.go). One entry point, subcommand per role:

  agent     run the node agent daemon (on the card; ``--set
            device_platform=cpu`` runs it on the CPU)
  operator  run the operator over a watch directory of CRD YAMLs or a
            kube-apiserver (Captures → local captures and batch/v1 Jobs)
  capture   create/list/download/delete packet captures (operator-less)
  observe   stream flows from the Hubble relay (hubble observe analog)
  status    flow-server occupancy + peers (hubble status analog)
  relay     run the cluster-wide flow relay (the hubble-relay analog)
  top       heavy-hitter tables from a running agent
  config    print the effective layered configuration
  trace     sampled flow traces from the agent (module/traces)
  version   print version

The reference's ``shell`` and ``deploy`` verbs are not ported yet
(ROADMAP §1 item 7).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.request
from typing import Any

from retina_tpu_torch.utils import buildinfo


def _parse_overrides(pairs: list[str]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, _, v = p.partition("=")
        out[k] = v
    return out


# ---------------------------------------------------------------- agent
def cmd_agent(args: argparse.Namespace) -> int:
    from retina_tpu_torch.daemon import run_agent

    overrides = _parse_overrides(args.set or [])
    if getattr(args, "kubeconfig", ""):
        overrides["kubeconfig"] = args.kubeconfig
    run_agent(
        config_path=args.config,
        overrides=overrides,
        apiserver_host=args.apiserver,
    )
    return 0


# -------------------------------------------------------------- operator
def cmd_operator(args: argparse.Namespace) -> int:
    """Operator main: reconcilers against an external CR backend.

    Backends (retina_tpu/operator/bridge.py): ``--watch-dir`` (directory
    of CR YAMLs; status written back beside the files) or
    ``--kubeconfig`` (kube-apiserver list+watch on the retina.sh CRs) —
    the reference operator against controller-runtime informers
    (pkg/controllers/operator/capture/controller.go:102).
    """
    import signal
    import threading

    from retina_tpu_torch.log import setup_logger
    from retina_tpu_torch.operator import CRDStore, Operator

    setup_logger()
    use_kube = bool(args.kubeconfig) or args.in_cluster
    if not args.watch_dir and not use_kube:
        print("operator: need --watch-dir, --kubeconfig or --in-cluster",
              file=sys.stderr)
        return 2
    if args.publish_cilium_crds and not use_kube:
        print("operator: --publish-cilium-crds requires a kube backend",
              file=sys.stderr)
        return 2
    if args.install_crds and not use_kube:
        print("operator: --install-crds requires a kube backend",
              file=sys.stderr)
        return 2
    store = CRDStore()
    bridges = []
    sinks = []
    if args.watch_dir:
        from retina_tpu_torch.operator.bridge import FileBridge

        fb = FileBridge(store, args.watch_dir,
                        poll_interval=args.poll_interval)
        bridges.append(fb)
        sinks.append(fb.on_status)
    if use_kube:
        from retina_tpu_torch.operator.bridge import KubeBridge

        try:
            # kubeconfig "" = in-cluster service-account config.
            kube = KubeBridge(store, args.kubeconfig,
                              namespace=args.namespace)
        except (ValueError, OSError) as e:
            print(f"operator: {e}", file=sys.stderr)
            return 2
        if args.install_crds:
            # Self-register the retina.sh CRDs (registercrd.go analog).
            from retina_tpu_torch.operator.crdinstall import install_crds

            install_crds(kube.client)
        bridges.append(kube)
        sinks.append(kube.patch_status)
        if args.publish_cilium_crds:
            # cilium-crds interop mode: watch core/v1 pods and publish
            # CiliumEndpoint/CiliumIdentity CRs so cilium-ecosystem
            # consumers get standard identity objects (reference
            # operator cilium-crds cell).
            from retina_tpu_torch.controllers.cache import Cache
            from retina_tpu_torch.common.topics import TOPIC_PODS
            from retina_tpu_torch.operator.cilium import CiliumPublisher
            from retina_tpu_torch.operator.kubewatch import CoreWatcher
            from retina_tpu_torch.pubsub import PubSub

            ps = PubSub()
            pod_cache = Cache(pubsub=ps)
            pub = CiliumPublisher(kube.client, node_name=args.node_name)
            ps.subscribe(TOPIC_PODS, pub.on_pod_event)
            pub.bootstrap()  # learn leftover CEP/CIDs from a prior run
            bridges.append(CoreWatcher(
                pod_cache, args.kubeconfig, namespace=args.namespace,
                include_services=False, include_nodes=False,
                on_pods_synced=pub.gc_stale,
            ))

    def fan_out_status(kind, obj):
        for s in sinks:
            s(kind, obj)

    elector = None
    if args.leader_elect:
        if not use_kube:
            print("operator: --leader-elect requires a kube backend",
                  file=sys.stderr)
            return 2
        if args.watch_dir:
            # File-backend status is per-pod: each failover would re-run
            # captures the old leader already completed.
            print("operator: warning: --watch-dir with --leader-elect "
                  "re-runs file-sourced captures on every failover; "
                  "prefer apiserver CRs", file=sys.stderr)
        from retina_tpu_torch.operator.leaderelection import LeaderElector

        elector = LeaderElector(
            kube.client,
            namespace=args.namespace or "kube-system",
        )
    job_runner = None
    cluster_nodes = None
    if use_kube:
        # Remote capture nodes get batch/v1 Jobs (capture
        # controller.go:102); local nodes still run in-process. A node
        # watcher supplies the live cluster inventory for translation.
        from retina_tpu_torch.capture.k8s_jobs import KubeJobRunner
        from retina_tpu_torch.controllers.cache import Cache
        from retina_tpu_torch.operator.kubewatch import CoreWatcher

        job_runner = KubeJobRunner(kube.client,
                                   image=args.capture_image)
        node_cache = Cache()
        bridges.append(CoreWatcher(
            node_cache, args.kubeconfig, include_pods=False,
            include_services=False, include_nodes=True,
        ))
        cluster_nodes = node_cache.list_nodes
    op = Operator(
        store, node_name=args.node_name,
        status_sink=fan_out_status if sinks else None,
        leading=(elector.is_leader if elector else None),
        job_runner=job_runner,
        cluster_nodes=cluster_nodes,
    )
    if elector is not None:
        elector.on_started_leading = op.resync
        elector.start()
    op.start()
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    for b in bridges:
        b.start()
    print("operator running (ctrl-c to stop)")
    stop.wait()
    if elector is not None:
        elector.stop()  # release the lease for fast failover
    for b in bridges:
        b.stop()
    return 0


# -------------------------------------------------------------- capture
def cmd_capture_create(args: argparse.Namespace) -> int:
    from retina_tpu_torch.capture.manager import CaptureManager
    from retina_tpu_torch.capture.translator import translate_capture_to_jobs
    from retina_tpu_torch.common import RetinaNode
    from retina_tpu_torch.crd.types import (
        Capture,
        CaptureOutput,
        CaptureSpec,
        CaptureTarget,
    )

    cap = Capture(
        name=args.name,
        namespace=args.namespace,
        spec=CaptureSpec(
            target=CaptureTarget(node_names=args.node_names or ["local"]),
            output=CaptureOutput(
                host_path=args.host_path,
                # In-cluster capture Jobs deliver the SAS URL through a
                # Secret-injected BLOB_URL env (k8s_jobs.job_manifest);
                # direct invocations may pass --blob-url.
                blob_upload_secret=(
                    args.blob_url or os.environ.get("BLOB_URL", "")
                ),
                s3_upload=(
                    {
                        "bucket": args.s3_bucket,
                        "region": args.s3_region,
                        **({"key_prefix": args.s3_prefix}
                           if args.s3_prefix else {}),
                        **({"endpoint": args.s3_endpoint}
                           if args.s3_endpoint else {}),
                    }
                    if args.s3_bucket else {}
                ),
            ),
            duration_s=args.duration,
            max_capture_size_mb=args.max_size,
            packet_size_bytes=args.packet_size,
            tcpdump_filter=args.filter,
            include_metadata=not args.no_metadata,
        ),
    )
    nodes = [RetinaNode(name=n) for n in (args.node_names or ["local"])]
    from retina_tpu_torch.crd.types import ValidationError

    try:
        jobs = translate_capture_to_jobs(cap, nodes, [])
    except ValidationError as e:
        print(f"invalid capture: {e}", file=sys.stderr)
        return 2
    mgr = CaptureManager()
    rc = 0
    for job in jobs:
        try:
            artifacts = mgr.run_job(job)
            for a in artifacts:
                print(a)
        except Exception as e:
            print(f"capture job {job.job_name()} failed: {e}",
                  file=sys.stderr)
            rc = 1
    return rc


def _capture_store(args: argparse.Namespace):
    """Resolve the artifact store the list/download/delete verbs act on.

    Precedence: explicit --blob-url, then explicit --s3-bucket, then
    explicit --host-path (local), then the BLOB_URL env (the reference's
    download contract, cli/cmd/capture/download.go:19). An explicit flag
    always beats ambient environment.

    Returns (store, key_root, ok): ``store`` None means local hostPath;
    ``key_root`` is the S3 key prefix the verbs must compose into (and
    strip out of) artifact names; ``ok`` False means no location was
    given at all — callers must NOT fall back to a relative local path
    (deleting ./<file> because an env var was unset is how files get
    lost)."""
    if getattr(args, "blob_url", ""):
        from retina_tpu_torch.capture.remote import BlobStore

        return BlobStore(args.blob_url), "", True
    if getattr(args, "s3_bucket", ""):
        from retina_tpu_torch.capture.remote import S3Store

        # S3 uploads key artifacts under a prefix (default
        # retina/captures, outputs.py) — compose it into every match so
        # `--file capture-x` round-trips with what create stored.
        root = (getattr(args, "s3_prefix", "") or "retina/captures")
        return (
            S3Store(args.s3_bucket, args.s3_region,
                    endpoint=args.s3_endpoint or ""),
            root.rstrip("/") + "/",
            True,
        )
    if args.host_path:
        return None, "", True  # explicit local store
    env_url = os.environ.get("BLOB_URL", "")
    if env_url:
        from retina_tpu_torch.capture.remote import BlobStore

        return BlobStore(env_url), "", True
    print("no capture location: pass --host-path, --blob-url, "
          "--s3-bucket, or set BLOB_URL", file=sys.stderr)
    return None, "", False


def cmd_capture_list(args: argparse.Namespace) -> int:
    from retina_tpu_torch.capture.remote import RemoteStoreError

    try:
        store, root, ok = _capture_store(args)
        if not ok:
            return 2
        if store is not None:
            prefix = root + (getattr(args, "prefix", "") or "")
            for a in store.list(prefix=prefix):
                # Print names relative to the key root so a listed name
                # pastes straight into download/delete --file (which
                # re-compose the root).
                name = a.name[len(root):] if a.name.startswith(root) \
                    else a.name
                print(f"{name}\t{a.size}\t{a.last_modified}")
            return 0
    except (RemoteStoreError, ValueError) as e:
        print(f"capture list failed: {e}", file=sys.stderr)
        return 1
    if not os.path.isdir(args.host_path):
        print("no captures found")
        return 0
    for f in sorted(os.listdir(args.host_path)):
        if f.endswith(".tar.gz"):
            st = os.stat(os.path.join(args.host_path, f))
            print(f"{f}\t{st.st_size}\t{time.ctime(st.st_mtime)}")
    return 0


def cmd_capture_download(args: argparse.Namespace) -> int:
    import shutil

    from retina_tpu_torch.capture.remote import RemoteStoreError

    try:
        store, root, ok = _capture_store(args)
        if not ok:
            return 2
        if store is not None:
            # Prefix semantics like the reference: download every
            # artifact whose name starts with the given name (multi-node
            # captures produce one tarball per node).
            matches = [a for a in store.list(prefix=root + args.file)]
            if not matches:
                print(f"no remote artifacts match: {root}{args.file}",
                      file=sys.stderr)
                return 1
            out_dir = args.output
            os.makedirs(out_dir, exist_ok=True)
            for a in matches:
                dst = store.download(
                    a.name,
                    os.path.join(out_dir, os.path.basename(a.name)),
                )
                print(dst)
            return 0
    except (RemoteStoreError, ValueError) as e:
        print(f"capture download failed: {e}", file=sys.stderr)
        return 1
    src = os.path.join(args.host_path, args.file)
    if not os.path.exists(src):
        print(f"not found: {src}", file=sys.stderr)
        return 1
    dst = shutil.copy2(src, args.output)
    print(dst)
    return 0


def cmd_capture_delete(args: argparse.Namespace) -> int:
    from retina_tpu_torch.capture.remote import RemoteStoreError

    try:
        store, root, ok = _capture_store(args)
        if not ok:
            return 2
        if store is not None:
            matches = [a for a in store.list(prefix=root + args.file)]
            if not matches:
                print(f"no remote artifacts match: {root}{args.file}",
                      file=sys.stderr)
                return 1
            for a in matches:
                store.delete(a.name)
                print(f"deleted {a.name}")
            return 0
    except (RemoteStoreError, ValueError) as e:
        print(f"capture delete failed: {e}", file=sys.stderr)
        return 1
    src = os.path.join(args.host_path, args.file)
    try:
        os.unlink(src)
        print(f"deleted {src}")
        return 0
    except OSError as e:
        print(f"delete failed: {e}", file=sys.stderr)
        return 1


# --------------------------------------------------------------- observe
def _duration_ns(spec: str) -> int:
    """'30s' / '5m' / '2h' / '1d' -> nanoseconds (hubble observe
    --since duration style)."""
    units = {"s": 1, "m": 60, "h": 3600, "d": 86400}
    if not spec or spec[-1] not in units or not spec[:-1].isdigit():
        raise SystemExit(
            f"bad duration {spec!r}: expected e.g. 30s, 5m, 2h, 1d"
        )
    return int(spec[:-1]) * units[spec[-1]] * 1_000_000_000


def cmd_observe(args: argparse.Namespace) -> int:
    from retina_tpu_torch.hubble.flow import FlowFilter
    from retina_tpu_torch.hubble.server import HubbleClient

    client = HubbleClient(args.server)
    now_ns = time.time_ns()
    filt = FlowFilter(
        pod=args.pod, namespace=args.namespace,
        # Flow dicts carry upper-case verdict/protocol names; accept
        # any case on the command line (hubble observe does).
        verdict=args.verdict.upper() if args.verdict else None,
        protocol=args.protocol.upper() if args.protocol else None,
        port=args.port, ip=args.ip,
        event_type=args.type,
        # Clamped at the epoch: a span longer than wall-clock time means
        # "everything" (and negative ints overflow the msgpack wire).
        since_ns=max(0, now_ns - _duration_ns(args.since))
        if args.since else None,
        until_ns=max(0, now_ns - _duration_ns(args.until))
        if args.until else None,
    )
    # A time window names its own span: --since without an explicit
    # --last means "everything in the window", not the default last-20
    # (the msgpack surface sizes the scan window from `last` BEFORE
    # filtering, so a nonzero default would silently truncate).
    last = args.last if args.last is not None else (0 if args.since else 20)
    try:
        for flow in client.get_flows(
            filter=filt, last=last, follow=args.follow,
            lost_markers=args.follow,
        ):
            if "lost_events" in flow and "ip" not in flow:
                # Ring-overwrite marker (the LostEvent analog): the
                # reader fell behind and n flows were overwritten. In
                # JSON mode it stays in-stream (machine consumers must
                # see loss); in text mode it goes to stderr.
                if args.json:
                    print(json.dumps(flow))
                else:
                    print(f"{flow['lost_events']} flows lost "
                          "(ring overwrite; reader too slow)",
                          file=sys.stderr)
                continue
            if args.json:
                print(json.dumps(flow))
            else:
                src = flow.get("source", {}).get("pod_name") or \
                    flow["ip"]["source"]
                dst = flow.get("destination", {}).get("pod_name") or \
                    flow["ip"]["destination"]
                l4 = flow["l4"]
                ts = int(flow.get("time_ns", 0))
                tstr = (
                    time.strftime("%b %d %H:%M:%S",
                                  time.localtime(ts // 1_000_000_000))
                    + f".{ts % 1_000_000_000 // 1_000_000:03d}"
                ) if ts else "-"
                print(
                    f"{tstr} {src}:{l4['source_port']} -> {dst}:"
                    f"{l4['destination_port']} {l4['protocol']} "
                    f"{flow['verdict']} {flow['event_type']}"
                )
    except KeyboardInterrupt:  # noqa: RT101 — ctrl-C ends the tail cleanly
        pass
    finally:
        client.close()
    return 0


# --------------------------------------------------------------- status
def cmd_status(args: argparse.Namespace) -> int:
    """`hubble status` analog: flow-buffer occupancy + peer set of a
    node agent or cluster relay."""
    from retina_tpu_torch.hubble.server import HubbleClient

    client = HubbleClient(args.server)
    try:
        st = client.server_status()
        peers = client.list_peers()
    finally:
        client.close()
    if args.json:
        print(json.dumps({"status": st, "peers": peers}))
        return 0
    cap = int(st.get("max_flows", 0)) or 1
    print(f"Current/Max Flows: {st.get('num_flows', 0)}/{cap} "
          f"({100.0 * int(st.get('num_flows', 0)) / cap:.2f}%)")
    print(f"Flows seen total: {st.get('seen_flows', 0)}")
    print(f"Uptime: {int(st.get('uptime_ns', 0)) / 1e9:.0f}s")
    for p in peers:
        print(f"peer: {p.get('name', '?')} at {p.get('address', '?')}")
    return 0


# ------------------------------------------------------------------ top
def cmd_top(args: argparse.Namespace) -> int:
    url = f"http://{args.server}/debug/vars"
    doc = json.loads(urllib.request.urlopen(url, timeout=5).read())
    key = f"top_{args.what}"
    rows = doc.get(key)
    if rows is None:
        print(f"agent does not expose {key}", file=sys.stderr)
        return 1
    for row in rows:
        print("\t".join(str(c) for c in row))
    return 0


# --------------------------------------------------------------- config
def cmd_config(args: argparse.Namespace) -> int:
    import dataclasses

    import yaml  # only here: the one verb that prints YAML

    from retina_tpu_torch.config import load_config

    cfg = load_config(args.config, overrides=_parse_overrides(args.set or []))
    print(yaml.safe_dump(dataclasses.asdict(cfg), sort_keys=True))
    return 0


# ---------------------------------------------------------------- trace
def cmd_trace(args: argparse.Namespace) -> int:
    """Show sampled flow traces from the agent (module/traces): the agent
    samples matching flows off the live record stream per the reconciled
    TracesSpec and serves them through /debug/vars."""
    url = f"http://{args.server}/debug/vars"
    doc = json.loads(urllib.request.urlopen(url, timeout=5).read())
    if args.stats:
        print(json.dumps(doc.get("traces_stats", {}), indent=2))
        return 0
    traces = doc.get("traces")
    if traces is None:
        print("agent does not expose traces", file=sys.stderr)
        return 1
    if not traces:
        print("no trace targets configured "
              "(apply a TracesConfiguration)")
        return 0
    for name, events in traces.items():
        if args.target and name != args.target:
            continue
        print(f"== {name} ({len(events)} sampled)")
        for e in events[-args.limit:]:
            print(
                f"  {e['ts']:.3f} {e['plugin']:>12} "
                f"{e['src']}:{e['sport']} -> {e['dst']}:{e['dport']} "
                f"proto={e['proto']} dir={e['direction']} "
                f"verdict={e['verdict']} reason={e['drop_reason']} "
                f"{e['packets']}pkt/{e['bytes']}B"
            )
    return 0


# ---------------------------------------------------------------- relay
def cmd_relay(args: argparse.Namespace) -> int:
    """Run the cluster-wide flow relay (the hubble-relay binary analog):
    fans in peer agents' GetFlows streams, serves one Observer surface."""
    import signal
    import threading

    from retina_tpu_torch.hubble.relay import HubbleRelay

    peers = [
        {"name": p, "address": p} for p in (args.peer or [])
    ]
    relay = HubbleRelay(
        peers=peers,
        discover_from=args.discover_from,
        addr=args.addr,
        node_name=args.name,
    )
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    relay.start()
    stop.wait()
    relay.stop()
    return 0


def cmd_version(args: argparse.Namespace) -> int:
    print(f"{buildinfo.APP_NAME} {buildinfo.VERSION}")
    return 0


# ---------------------------------------------------------------- parser
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="retina-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("agent", help="run the node agent")
    a.add_argument("--config", default=None, help="YAML config path")
    a.add_argument("--set", action="append", metavar="KEY=VAL")
    a.add_argument("--apiserver", default="", help="apiserver host to watch")
    a.add_argument("--kubeconfig", default="",
                   help="watch core/v1 pods/services/nodes for identity "
                        "and the module CRs (default: in-cluster when a "
                        "service account is mounted)")
    a.set_defaults(fn=cmd_agent)

    o = sub.add_parser("operator", help="run the operator")
    o.add_argument("--watch-dir", default="",
                   help="directory of CR YAMLs (file backend)")
    o.add_argument("--kubeconfig", default="",
                   help="kubeconfig path (kube-apiserver backend)")
    o.add_argument("--in-cluster", action="store_true",
                   help="kube backend via the mounted service account")
    o.add_argument("--namespace", default="",
                   help="namespace scope for --kubeconfig ('' = all)")
    o.add_argument("--publish-cilium-crds", action="store_true",
                   help="publish CiliumEndpoint/CiliumIdentity CRs from "
                        "pods (cilium-crds interop mode)")
    o.add_argument("--leader-elect", action="store_true",
                   help="coordinate replicas via a coordination.k8s.io "
                        "Lease; followers watch but do not reconcile")
    o.add_argument("--install-crds", action="store_true",
                   help="self-register the retina.sh CRDs at startup")
    o.add_argument("--capture-image", default="retina-tpu:latest",
                   help="image for remote capture Jobs (kube backend)")
    o.add_argument("--node-name", default="local")
    o.add_argument("--poll-interval", type=float, default=2.0)
    o.set_defaults(fn=cmd_operator)

    cap = sub.add_parser("capture", help="packet captures")
    csub = cap.add_subparsers(dest="capture_cmd", required=True)

    def remote_args(sp, with_s3: bool = True):
        sp.add_argument("--blob-url", default="",
                        help="blob container SAS URL (or BLOB_URL env)")
        if with_s3:
            sp.add_argument("--s3-bucket", default="")
            sp.add_argument("--s3-region", default="")
            sp.add_argument("--s3-prefix", default="",
                            help="object key prefix (default "
                                 "retina/captures)")
            sp.add_argument("--s3-endpoint", default="",
                            help="endpoint override for S3-compatible "
                                 "stores")

    cc = csub.add_parser("create")
    cc.add_argument("--name", required=True)
    cc.add_argument("--namespace", default="default")
    cc.add_argument("--node-names", nargs="*", default=None)
    cc.add_argument("--host-path", default="",
                    help="local artifact directory (omit for remote-"
                         "only outputs)")
    cc.add_argument("--duration", type=int, default=10)
    cc.add_argument("--max-size", type=int, default=100)
    cc.add_argument("--filter", default="")
    cc.add_argument("--packet-size", type=int, default=0,
                    help="snap length in bytes (0 = full packets)")
    cc.add_argument("--no-metadata", action="store_true",
                    help="skip the network-state metadata dumps")
    remote_args(cc)
    cc.set_defaults(fn=cmd_capture_create)
    cl = csub.add_parser("list")
    cl.add_argument("--host-path", default="")
    cl.add_argument("--prefix", default="")
    remote_args(cl)
    cl.set_defaults(fn=cmd_capture_list)
    cd = csub.add_parser("download")
    cd.add_argument("--host-path", default="")
    cd.add_argument("--file", required=True,
                    help="artifact name (remote stores: name prefix)")
    cd.add_argument("--output", default=".")
    remote_args(cd)
    cd.set_defaults(fn=cmd_capture_download)
    cx = csub.add_parser("delete")
    cx.add_argument("--host-path", default="")
    cx.add_argument("--file", required=True,
                    help="artifact name (remote stores: name prefix)")
    remote_args(cx)
    cx.set_defaults(fn=cmd_capture_delete)

    ob = sub.add_parser("observe", help="stream flows from the relay")
    ob.add_argument("--server", default="127.0.0.1:4244")
    ob.add_argument("--follow", action="store_true")
    ob.add_argument("--last", type=int, default=None,
                    help="N most recent (default 20; a --since window "
                         "defaults to everything in the window)")
    ob.add_argument("--pod")
    ob.add_argument("--namespace")
    ob.add_argument("--verdict")
    ob.add_argument("--protocol")
    ob.add_argument("--port", type=int)
    ob.add_argument("--ip", help="match either endpoint IP")
    ob.add_argument("--type", choices=["flow", "drop", "dns_request",
                                       "dns_response", "tcp_retransmit"],
                    help="match the event type")
    ob.add_argument("--since", help="only flows newer than this long "
                                    "ago (30s, 5m, 2h, 1d)")
    ob.add_argument("--until", help="only flows older than this long ago")
    ob.add_argument("--json", action="store_true")
    ob.set_defaults(fn=cmd_observe)

    st = sub.add_parser("status", help="flow-server status and peers")
    st.add_argument("--server", default="127.0.0.1:4244")
    st.add_argument("--json", action="store_true")
    st.set_defaults(fn=cmd_status)

    tp = sub.add_parser("top", help="heavy-hitter tables")
    tp.add_argument("what", choices=["flows", "services", "dns"])
    tp.add_argument("--server", default="127.0.0.1:10093")
    tp.set_defaults(fn=cmd_top)

    cf = sub.add_parser("config", help="print effective config")
    cf.add_argument("--config", default=None)
    cf.add_argument("--set", action="append", metavar="KEY=VAL")
    cf.set_defaults(fn=cmd_config)

    tr = sub.add_parser(
        "trace", help="sampled flow traces from the agent"
    )
    tr.add_argument("--server", default="127.0.0.1:10093")
    tr.add_argument("--target", default="",
                    help="only this trace target")
    tr.add_argument("--limit", type=int, default=50)
    tr.add_argument("--stats", action="store_true",
                    help="sampling stats instead of events")
    tr.set_defaults(fn=cmd_trace)

    rl = sub.add_parser("relay", help="cluster-wide flow relay")
    rl.add_argument("--peer", action="append", metavar="HOST:PORT",
                    help="agent relay endpoint (repeatable)")
    rl.add_argument("--discover-from", default="",
                    metavar="HOST:PORT",
                    help="seed agent whose peer service lists the cluster")
    rl.add_argument("--addr", default="127.0.0.1:4245")
    rl.add_argument("--name", default="relay")
    rl.set_defaults(fn=cmd_relay)

    v = sub.add_parser("version")
    v.set_defaults(fn=cmd_version)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
