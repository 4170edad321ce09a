"""The port's Hubble control plane through its agent and its CLI, on the CPU.

A ``Daemon`` with ``enable_hubble`` streams enriched flows: the plugins
mirror blocks into the external channel -> monitor agent -> observer -> the
gRPC server, read over msgpack (the port's and the reference's client), the
Cilium protobuf surface and the unix socket, with the hubble metrics mux
serving only the hubble registry. Two port agents (A in a child process,
``python -m retina_tpu_torch agent``; B in this one, listing A as a peer)
and the port's relay: discovery through B's ``peer.Peer/Notify`` reaches A,
and A's flows show through the relay with A's node name. The CLI's
``observe``, ``status`` and ``relay`` verbs parse the reference's flags
alike and print what the reference's verbs print against the same server.
Every wait has a deadline.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import grpc
import numpy as np
import pytest

from retina_tpu import cli as rcli
from retina_tpu.hubble import proto as rpb
from retina_tpu.hubble import server as rserver
from retina_tpu_torch import cli, exporter, metrics
from retina_tpu_torch.common import RetinaEndpoint, RetinaNode
from retina_tpu_torch.config import load_config
from retina_tpu_torch.daemon import Daemon
from retina_tpu_torch.events.schema import F, NUM_FIELDS, ip_to_u32
from retina_tpu_torch.hubble import FlowObserver, HubbleServer
from retina_tpu_torch.hubble.flow import record_to_flow
from retina_tpu_torch.hubble.relay import HubbleRelay
from retina_tpu_torch.hubble.server import HubbleClient
from tests.procutil import wait_until

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(batch_capacity=1 << 10, n_pods=1 << 8, cms_width=1 << 10, topk_slots=1 << 7,
             hll_precision=8, entropy_buckets=1 << 8, conntrack_slots=1 << 10,
             identity_slots=1 << 10, flow_dict_slots=1 << 10, transfer_min_bucket=1 << 6,
             invertible_width=1 << 8, invertible_hi_width=1 << 6, window_seconds=0.5,
             metrics_interval_s=0.2, feed_workers=1)
AGENT = dict(SMALL, device_platform="cpu", enabled_plugins=["packetparser"],
             synthetic_rate=50_000, synthetic_flows=500, bypass_lookup_ip_of_interest=True)


@pytest.fixture(autouse=True)
def fresh_port_metrics():
    exporter.reset_for_tests()
    metrics.reset_for_tests()
    yield


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pb_get_flows(chan):
    return chan.unary_stream(
        "/observer.Observer/GetFlows", request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=rpb.GetFlowsResponse.FromString)


def _run(d: Daemon):
    stop = threading.Event()
    t = threading.Thread(target=d.start, args=(stop,), name="daemon", daemon=True)
    t.start()
    assert wait_until(lambda: d.cm._ready.is_set() or not t.is_alive(), 120.0)
    assert t.is_alive(), "the agent died while booting"
    return stop, t


def _stop(stop: threading.Event, t: threading.Thread) -> None:
    stop.set()
    t.join(60)
    assert not t.is_alive(), "the agent did not stop"


def test_hubble_daemon_flow_stream(tmp_path):
    sock = str(tmp_path / "hubble.sock")
    cfg = load_config(None, overrides=dict(
        AGENT, api_server_addr="127.0.0.1:0", enable_hubble=True, hubble_addr="127.0.0.1:0",
        hubble_metrics_addr="127.0.0.1:0", hubble_sock_path=sock, node_name="node-a"), env={})
    d = Daemon(cfg, apiserver_host="127.0.0.1")
    d.cm.cache.update_endpoint(RetinaEndpoint(name="pod-1", namespace="default",
                                              ips=("10.0.0.1",)))
    stop, t = _run(d)
    try:
        assert wait_until(lambda: d.observer.flows_seen > 0, 30.0), "no flow reached the observer"
        addr = f"127.0.0.1:{d.hubble.port}"
        for client in (HubbleClient(addr), rserver.HubbleClient(addr),
                       HubbleClient(f"unix:{sock}")):
            flows = list(client.get_flows(last=50, timeout=10))
            assert len(flows) == 50
            assert all("ip" in f and "l4" in f and "verdict" in f for f in flows)
            assert client.server_status()["seen_flows"] > 0
            assert client.list_peers() == []
            client.close()
        with grpc.insecure_channel(addr) as chan:
            resps = list(_pb_get_flows(chan)(rpb.GetFlowsRequest(number=20), timeout=10))
        assert len(resps) == 20 and {r.node_name for r in resps} == {"node-a"}
        assert {r.flow.node_name for r in resps} == {"node-a"}
        # The :9965-analog mux serves the hubble registry alone.
        mux = d.hubble_metrics_server.port

        def mux_has_requests() -> bool:
            with urllib.request.urlopen(f"http://127.0.0.1:{mux}/metrics", timeout=10) as r:
                body = r.read().decode()
            return 'hubble_get_flows_requests_total{surface="protobuf"} 1.0' in body and \
                "networkobservability_" not in body

        assert wait_until(mux_has_requests, 30.0, poll_s=0.2)
    finally:
        _stop(stop, t)


def test_refuse_unported_passes_enable_hubble():
    """enable_hubble is wired now: refuse_unported lets it through."""
    import retina_tpu_torch.daemon as daemon_mod

    daemon_mod.refuse_unported(load_config(None, overrides=dict(
        device_platform="cpu", enable_hubble=True), env={}))


@pytest.fixture(scope="module")
def agent_a(tmp_path_factory):
    """Agent A in a child process: the agent as users start it, with the
    Hubble plane on a known port and its node name."""
    port, api = _free_port(), _free_port()
    log = tmp_path_factory.mktemp("agent_a") / "agent.log"
    args = [sys.executable, "-m", "retina_tpu_torch", "agent", "--set",
            f"api_server_addr=127.0.0.1:{api}", "--set", "enable_hubble=true", "--set",
            f"hubble_addr=127.0.0.1:{port}", "--set", "node_name=node-a"]
    for k, v in AGENT.items():
        v = ",".join(v) if isinstance(v, list) else v
        args += ["--set", f"{k}={v}"]
    env = {k: v for k, v in os.environ.items() if not k.startswith("RETINA_")}
    with open(log, "w") as out:
        proc = subprocess.Popen(args, cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        def serving() -> bool:
            assert proc.poll() is None, "agent A exited: " + log.read_text()[-3000:]
            try:
                client = HubbleClient(f"127.0.0.1:{port}")
                try:
                    return client.server_status()["seen_flows"] > 0
                finally:
                    client.close()
            except grpc.RpcError:
                return False

        assert wait_until(serving, 180.0, poll_s=0.5), log.read_text()[-3000:]
        yield port
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            assert proc.wait(timeout=90) == 0, log.read_text()[-3000:]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def test_flow_from_agent_a_visible_via_relay_discovered_from_agent_b(agent_a):
    a_addr = f"127.0.0.1:{agent_a}"
    cfg = load_config(None, overrides=dict(
        AGENT, api_server_addr="127.0.0.1:0", enable_hubble=True, hubble_addr="127.0.0.1:0",
        node_name="node-b", hubble_peers=[{"name": "node-a", "address": a_addr}]), env={})
    b = Daemon(cfg, apiserver_host="127.0.0.1")
    stop, t = _run(b)
    relay = None
    try:
        b_addr = f"127.0.0.1:{b.hubble.port}"
        # B's peer service: A from the static list, node-x from the node store.
        b.cm.cache.update_node(RetinaNode(name="node-x", ip="10.99.0.7"))
        with grpc.insecure_channel(b_addr) as chan:
            stream = chan.unary_stream(
                "/peer.Peer/Notify", request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=rpb.ChangeNotification.FromString)(rpb.NotifyRequest(),
                                                                         timeout=20)
            it = iter(stream)
            notes = [next(it), next(it)]
            stream.cancel()
        assert [(n.name, n.address, n.type) for n in notes] == [
            ("node-a", a_addr, 1), ("node-x", f"10.99.0.7:{b.hubble.port}", 1)]
        relay = HubbleRelay(discover_from=b_addr, addr="127.0.0.1:0", node_name="relay-b",
                            retry_s=0.2)
        relay.start()
        assert wait_until(lambda: a_addr in relay._connected, 30.0, poll_s=0.1)
        assert wait_until(lambda: relay.observer.flows_seen > 0, 60.0), \
            "no flow crossed from agent A to the relay"
        # The relay takes A's flows one response at a time: the query below
        # asks for five, so it waits until five have crossed.
        assert wait_until(lambda: relay.observer.flows_seen >= 5, 60.0), \
            f"{relay.observer.flows_seen} flows crossed from agent A to the relay"
        with grpc.insecure_channel(f"127.0.0.1:{relay.port}") as chan:
            got = list(_pb_get_flows(chan)(rpb.GetFlowsRequest(number=5), timeout=10))
        assert len(got) == 5
        assert {g.flow.node_name for g in got} == {"node-a"}
        assert {g.node_name for g in got} == {"relay-b"}
        assert all(g.flow.IP.source for g in got)
        # The relay's own peer service lists what it follows.
        assert {"name": "node-a", "address": a_addr} in relay.peer_list()
    finally:
        if relay is not None:
            relay.stop()
        _stop(stop, t)


def test_relay_verb_follows_a_static_peer(agent_a, tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("RETINA_")}
    with open(tmp_path / "relay.log", "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "retina_tpu_torch", "relay", "--peer",
             f"127.0.0.1:{agent_a}", "--addr", f"127.0.0.1:{port}", "--name", "cli-relay"],
            cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        got: list = []

        def through() -> bool:
            assert proc.poll() is None, (tmp_path / "relay.log").read_text()[-3000:]
            try:
                with grpc.insecure_channel(f"127.0.0.1:{port}") as chan:
                    got[:] = list(_pb_get_flows(chan)(rpb.GetFlowsRequest(number=3),
                                                      timeout=5))
            except grpc.RpcError:
                return False
            return len(got) == 3

        assert wait_until(through, 120.0, poll_s=0.3)
        assert {g.flow.node_name for g in got} == {"node-a"}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


ARGVS = [
    ["observe"],
    ["observe", "--server", "10.0.0.1:4244", "--follow", "--last", "7", "--pod", "web-0",
     "--namespace", "prod", "--verdict", "dropped", "--protocol", "tcp", "--port", "443",
     "--ip", "10.0.0.2", "--type", "dns_request", "--since", "5m", "--until", "30s", "--json"],
    ["observe", "--type", "tcp_retransmit", "--since", "2h"],
    ["status"],
    ["status", "--server", "unix:/run/hubble.sock", "--json"],
    ["relay"],
    ["relay", "--peer", "10.0.0.1:4244", "--peer", "10.0.0.2:4244", "--discover-from",
     "10.0.0.3:4244", "--addr", "0.0.0.0:4245", "--name", "cluster-relay"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "-".join(a[:2]))
def test_verbs_parse_the_reference_flags_alike(argv):
    got = vars(cli.build_parser().parse_args(argv))
    want = vars(rcli.build_parser().parse_args(argv))
    got.pop("fn"), want.pop("fn")
    assert got == want


@pytest.mark.parametrize("spec", ["30s", "5m", "2h", "1d", "0s"])
def test_duration_ns_matches_the_reference(spec):
    assert cli._duration_ns(spec) == rcli._duration_ns(spec)


@pytest.mark.parametrize("spec", ["", "5", "m5", "1.5h", "-3s"])
def test_bad_duration_exits_like_the_reference(spec):
    with pytest.raises(SystemExit) as got:
        cli._duration_ns(spec)
    with pytest.raises(SystemExit) as want:
        rcli._duration_ns(spec)
    assert str(got.value) == str(want.value)


def _records() -> np.ndarray:
    rng = np.random.default_rng(5)
    rec = np.zeros((12, NUM_FIELDS), np.uint32)
    ts = 1_700_000_000 * 10**9 + rng.integers(0, 10**9, 12)
    rec[:, F.TS_LO] = (ts & 0xFFFFFFFF).astype(np.uint32)
    rec[:, F.TS_HI] = (ts >> 32).astype(np.uint32)
    rec[:, F.SRC_IP] = ip_to_u32("10.0.0.1")
    rec[:, F.DST_IP] = ip_to_u32("10.0.0.2") + np.arange(12, dtype=np.uint32) % 3
    rec[:, F.PORTS] = (rng.integers(1000, 2000, 12).astype(np.uint32) << 16) | 80
    rec[:, F.META] = (np.where(np.arange(12) % 2, 6, 17).astype(np.uint32) << 24) | (1 << 4)
    rec[:, F.VERDICT] = np.where(np.arange(12) % 4 == 0, 2, 1).astype(np.uint32)
    rec[:, F.EVENT_TYPE] = np.where(np.arange(12) % 4 == 0, 1, 0).astype(np.uint32)
    rec[0, F.TS_LO] = rec[0, F.TS_HI] = 0  # one unstamped flow
    return rec


VERB_ARGS = [
    ["observe"], ["observe", "--json"], ["observe", "--last", "3"],
    ["observe", "--verdict", "dropped"], ["observe", "--protocol", "udp", "--json"],
    ["observe", "--ip", "10.0.0.3"], ["observe", "--type", "drop", "--json"],
    ["observe", "--port", "80", "--last", "0"], ["status"], ["status", "--json"],
]


@pytest.mark.parametrize("args", VERB_ARGS, ids=lambda a: "-".join(a))
@pytest.mark.parametrize("server", ["port", "reference"])
def test_observe_and_status_print_what_the_reference_prints(args, server, capsys):
    from retina_tpu.hubble import observer as robserver

    if server == "port":
        obs = FlowObserver(capacity=1 << 8)
        srv = HubbleServer(obs, addr="127.0.0.1:0",
                           peers=[{"name": "node-b", "address": "10.0.0.2:4244"}])
    else:
        obs = robserver.FlowObserver(capacity=1 << 8)
        srv = rserver.HubbleServer(obs, addr="127.0.0.1:0",
                                   peers=[{"name": "node-b", "address": "10.0.0.2:4244"}])
    srv.start()
    try:
        obs.consume(_records())
        argv = [args[0], "--server", f"127.0.0.1:{srv.port}"] + args[1:]
        assert cli.main(argv) == 0
        got = capsys.readouterr()
        assert rcli.main(argv) == 0
        want = capsys.readouterr()
    finally:
        srv.stop()
    if args[0] == "status" and "--json" in args:  # the uptime moves between the calls
        g, w = json.loads(got.out), json.loads(want.out)
        g["status"].pop("uptime_ns"), w["status"].pop("uptime_ns")
        assert g == w and g["status"]["seen_flows"] == 12
    elif args[0] == "status":
        got_out = [ln for ln in got.out.splitlines() if not ln.startswith("Uptime")]
        want_out = [ln for ln in want.out.splitlines() if not ln.startswith("Uptime")]
        assert got_out == want_out and "Flows seen total: 12" in got_out
    else:
        assert got.out == want.out and got.out
        if "--json" in args:
            flows = [record_to_flow(r) for r in _records()]
            assert all(json.loads(ln) in flows for ln in got.out.splitlines())


def test_observe_follow_prints_lost_markers_to_stderr(capsys, monkeypatch):
    """observe --follow in text form: a ring-overwrite marker goes to
    stderr while the flows go on to stdout."""
    obs = FlowObserver(capacity=1 << 4)
    srv = HubbleServer(obs, addr="127.0.0.1:0")
    srv.start()
    printed: list = []
    real_print = print

    def counting_print(*a, **kw):
        real_print(*a, **kw)
        if kw.get("file") is sys.stderr:
            printed.append(a[0])
            raise KeyboardInterrupt  # ends the tail as ctrl-C does

    monkeypatch.setattr("builtins.print", counting_print)
    done = threading.Event()

    def feed() -> None:
        obs.consume(_records()[:1])
        time.sleep(0.3)
        while not done.is_set():
            obs.consume(np.concatenate([_records()] * 8))  # laps 16 slots
            time.sleep(0.05)

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    try:
        assert cli.main(["observe", "--server", f"127.0.0.1:{srv.port}", "--follow",
                         "--last", "1"]) == 0
    finally:
        done.set()
        feeder.join(10)
        srv.stop()
    assert printed and "flows lost (ring overwrite; reader too slow)" in printed[0]
