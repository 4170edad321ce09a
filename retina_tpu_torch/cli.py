"""retina-tpu-torch CLI (port of the agent-side verbs of retina_tpu/cli.py).

Reference analog: cli/ (kubectl-retina) plus the agent binary
(controller/main.go). One entry point, subcommand per role:

  agent     run the node agent daemon (on the card; ``--set
            device_platform=cpu`` runs it on the CPU)
  observe   stream flows from the Hubble relay (hubble observe analog)
  status    flow-server occupancy + peers (hubble status analog)
  relay     run the cluster-wide flow relay (the hubble-relay analog)
  top       heavy-hitter tables from a running agent
  config    print the effective layered configuration
  trace     sampled flow traces from the agent (module/traces)
  version   print version

The reference's ``operator``, ``capture``, ``shell`` and ``deploy`` verbs
are not ported yet (ROADMAP §1 items 4 and 7).
"""

from __future__ import annotations

import argparse
import json
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
                        "(not ported yet: the agent refuses it)")
    a.set_defaults(fn=cmd_agent)

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
