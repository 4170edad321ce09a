"""retina-tpu-torch CLI (port of the agent-side verbs of retina_tpu/cli.py).

Reference analog: cli/ (kubectl-retina) plus the agent binary
(controller/main.go). One entry point, subcommand per role:

  agent     run the node agent daemon (on the card; ``--set
            device_platform=cpu`` runs it on the CPU)
  top       heavy-hitter tables from a running agent
  config    print the effective layered configuration
  trace     sampled flow traces from the agent (module/traces)
  version   print version

The reference's ``operator``, ``capture``, ``observe``, ``status``,
``shell``, ``relay`` and ``deploy`` verbs are not ported yet (ROADMAP §1
items 4 and 7).
"""

from __future__ import annotations

import argparse
import json
import sys
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

    v = sub.add_parser("version")
    v.set_defaults(fn=cmd_version)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
