"""The port's Hubble control plane (retina_tpu_torch/hubble/) against the
reference's (retina_tpu/hubble/), on the CPU.

The same records, made from a seed with numpy, go through both packages:
``record_to_flow`` and ``FlowFilter`` give equal dicts and verdicts (DNS and
drop rows included); the observers give equal reads through the same
script (buffered, follow, overwrite-oldest, lost markers, the memoised
decode); the protobuf messages are equal byte for byte, each package's
bytes parse in the other's classes, and the ``since``/``until`` bounds
serialise alike; the wire works across packages, the reference's
``HubbleClient`` and a raw Cilium-surface stub against the port's
``HubbleServer`` and the port's client against the reference's server.
Then TLS and mutual TLS, the unix socket, a second construction, the
lost-event markers on both surfaces, the relay's accounting of
peer-reported loss, and the plugin manager's channel broadcast through
the monitor agent.
"""

from __future__ import annotations

import queue
import subprocess
import threading

import grpc
import numpy as np
import pytest

from retina_tpu.common import RetinaEndpoint as RefEndpoint
from retina_tpu.controllers.cache import Cache as RefCache
from retina_tpu.hubble import flow as rflow
from retina_tpu.hubble import observer as robserver
from retina_tpu.hubble import proto as rpb
from retina_tpu.hubble import server as rserver
from retina_tpu_torch import exporter, metrics
from retina_tpu_torch.common import RetinaEndpoint
from retina_tpu_torch.controllers.cache import Cache
from retina_tpu_torch.events.schema import (
    EV_DNS_REQ,
    EV_DNS_RESP,
    EV_DROP,
    EV_FORWARD,
    EV_TCP_RETRANS,
    F,
    NUM_FIELDS,
    ip_to_u32,
)
from retina_tpu_torch.hubble import flow as pflow
from retina_tpu_torch.hubble import observer as pobserver
from retina_tpu_torch.hubble import proto as ppb
from retina_tpu_torch.hubble import server as pserver
from retina_tpu_torch.hubble.monitoragent import MonitorAgent
from retina_tpu_torch.hubble.relay import HubbleRelay
from tests.procutil import wait_until

SEEDS = (0, 1, 2)
IPS = ["10.0.0.1", "10.0.0.2", "10.0.1.7", "192.168.5.5", "10.0.0.9"]


@pytest.fixture(autouse=True)
def fresh_port_metrics():
    exporter.reset_for_tests()
    metrics.reset_for_tests()
    yield


def make_records(seed: int, n: int = 96) -> np.ndarray:
    """``n`` records over IPS: every protocol, verdict, direction and event
    type, random flags, ports, DNS columns and timestamps."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((n, NUM_FIELDS), np.uint32)
    ts = rng.integers(1, 2**40, size=n, dtype=np.uint64)
    rec[:, F.TS_LO] = (ts & 0xFFFFFFFF).astype(np.uint32)
    rec[:, F.TS_HI] = (ts >> np.uint64(32)).astype(np.uint32)
    ips = np.array([ip_to_u32(ip) for ip in IPS], np.uint32)
    rec[:, F.SRC_IP] = ips[rng.integers(0, len(IPS), n)]
    rec[:, F.DST_IP] = ips[rng.integers(0, len(IPS), n)]
    sport = rng.integers(1, 65536, n, dtype=np.uint32)
    dport = rng.choice(np.array([53, 80, 443, 8080], np.uint32), n)
    rec[:, F.PORTS] = (sport << 16) | dport
    proto = rng.choice(np.array([6, 17, 1, 58], np.uint32), n)
    flags = rng.integers(0, 256, n, dtype=np.uint32)
    direction = rng.integers(0, 3, n, dtype=np.uint32)
    reply = rng.integers(0, 2, n, dtype=np.uint32)
    rec[:, F.META] = (proto << 24) | (flags << 16) | (direction << 4) | reply
    rec[:, F.BYTES] = rng.integers(40, 9000, n, dtype=np.uint32)
    rec[:, F.PACKETS] = rng.integers(1, 10, n, dtype=np.uint32)
    ev = np.array([EV_FORWARD, EV_DROP, EV_DNS_REQ, EV_DNS_RESP, EV_TCP_RETRANS],
                  np.uint32)[np.arange(n) % 5]
    rec[:, F.EVENT_TYPE] = ev
    rec[:, F.VERDICT] = np.where(ev == EV_DROP, 2, rng.integers(0, 2, n)).astype(np.uint32)
    rec[:, F.DROP_REASON] = rng.integers(0, 200, n, dtype=np.uint32)
    qtype = rng.choice(np.array([1, 28, 5, 16, 99], np.uint32), n)
    rcode = rng.integers(0, 4, n, dtype=np.uint32)
    rec[:, F.DNS] = (qtype << 16) | (rcode << 8) | rng.integers(0, 2, n, dtype=np.uint32)
    rec[:, F.DNS_QHASH] = rng.integers(0, 2**32, n, dtype=np.uint32)
    return rec


def caches():
    """The same pods in the port's and the reference's cache."""
    pods = [("web-0", "default", "10.0.0.1", (("app", "web"),), (("Deployment", "web"),)),
            ("db-0", "prod", "10.0.0.2", (), ()),
            ("api-1", "prod", "10.0.1.7", (("tier", "api"), ("app", "api")),
             (("ReplicaSet", "api-7f"),))]
    pc, rc = Cache(), RefCache()
    for name, ns, ip, labels, owners in pods:
        pc.update_endpoint(RetinaEndpoint(name=name, namespace=ns, ips=(ip,), labels=labels,
                                          owner_refs=owners))
        rc.update_endpoint(RefEndpoint(name=name, namespace=ns, ips=(ip,), labels=labels,
                                       owner_refs=owners))
    return pc, rc


def resolve(h: int) -> str:
    return f"q{h:08x}.svc.cluster.local"


# ------------------------------------------------------------------ flow
@pytest.mark.parametrize("seed", SEEDS)
def test_record_to_flow_matches_reference(seed):
    pc, rc = caches()
    recs = make_records(seed)
    kinds = set()
    for r in recs:
        assert pflow.record_to_flow(r) == rflow.record_to_flow(r)
        got = pflow.record_to_flow(r, pc, resolve)
        assert got == rflow.record_to_flow(r, rc, resolve)
        kinds.add(got["event_type"])
        if got["verdict"] == "DROPPED":
            assert got["drop_reason"] == int(r[F.DROP_REASON])
        if got["event_type"].startswith("dns_"):
            assert got["l7_dns"]["query"] == resolve(int(r[F.DNS_QHASH]))
    assert kinds == {"flow", "drop", "dns_request", "dns_response", "tcp_retransmit"}


FILTERS = [
    dict(pod="web-0"), dict(pod="api-1"), dict(namespace="prod"), dict(verdict="DROPPED"),
    dict(verdict="FORWARDED", protocol="TCP"), dict(protocol="UDP", port=53), dict(port=443),
    dict(ip="10.0.0.1"), dict(ip="192.168.5.5"), dict(event_type="drop"),
    dict(event_type="dns_response", namespace="prod"), dict(since_ns=2**39),
    dict(until_ns=2**38), dict(since_ns=2**36, until_ns=2**39, protocol="ICMP"), {},
]


@pytest.mark.parametrize("seed", SEEDS)
def test_flow_filter_verdicts_match_reference(seed):
    pc, rc = caches()
    recs = make_records(seed)
    pflows = [pflow.record_to_flow(r, pc, resolve) for r in recs]
    rflows = [rflow.record_to_flow(r, rc, resolve) for r in recs]
    hits = 0
    for spec in FILTERS:
        pf, rf = pflow.FlowFilter(**spec), rflow.FlowFilter(**spec)
        assert pf.to_dict() == rf.to_dict() == spec
        back = pflow.FlowFilter.from_dict(rf.to_dict())
        got = [pf.matches(f) for f in pflows]
        assert got == [rf.matches(f) for f in rflows]
        assert got == [back.matches(f) for f in pflows]
        hits += sum(got)
    assert hits > 0


# -------------------------------------------------------------- observer
def _drive_observer(mod, recs: np.ndarray) -> list:
    """One script over an observer module: what each read returned."""
    out = []
    obs = mod.FlowObserver(capacity=8)
    obs.consume(recs[:4])
    # Raw (block, row) refs until the first read; memoised dicts after it.
    out.append(all(isinstance(e, tuple) for e in obs._ring if e is not None))
    out.append(list(obs.get_flows()))
    out.append(all(not isinstance(e, tuple) for e in obs._ring if e is not None))
    flows, cursor = obs.snapshot_flows()
    again, _ = obs.snapshot_flows()
    out.append((cursor, all(a is b for a, b in zip(flows, again))))
    out.append(list(obs.get_flows(last=2)))
    # Overwrite oldest: 10 more rows into the 8-slot ring.
    obs.consume(recs[4:14])
    out.append((list(obs.get_flows()), obs.flows_seen))
    # Follow from the live edge with lost markers, driven from this thread.
    stop = threading.Event()
    it = obs.get_flows(follow=True, stop=stop, lost_markers=True, last=1)
    out.append(next(it))
    obs.consume(recs[14:15])
    out.append(next(it))
    obs.consume(recs[15:40])  # laps the reader: a marker, then the newest 8
    out.append([next(it) for _ in range(9)])
    out.append(obs.lost_observed)
    stop.set()
    # follow_from yields ("flow", f) and ("lost", n) items.
    obs2 = mod.FlowObserver(capacity=4)
    obs2.consume(recs[40:50])
    fit = obs2.follow_from(0, stop=threading.Event())
    out.append([next(fit) for _ in range(5)])
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_observer_ring_semantics_match_reference(seed):
    recs = make_records(seed)
    got = _drive_observer(pobserver, recs)
    assert got == _drive_observer(robserver, recs)
    assert got[0] and got[2] and got[3][1]
    assert [f["time_ns"] for f in got[5][0]] == [
        pflow.record_to_flow(r)["time_ns"] for r in recs[6:14]]
    assert got[5][1] == 14
    assert got[8][0] == {"lost_events": 17} and got[9] == 17
    assert got[10][0] == ("lost", 6)


def test_observer_capacity_must_be_a_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        pobserver.FlowObserver(capacity=12)


# ----------------------------------------------------------------- proto
@pytest.mark.parametrize("seed", SEEDS)
def test_flow_proto_bytes_match_reference(seed):
    pc, rc = caches()
    for r in make_records(seed):
        for cache, rcache in ((None, None), (pc, rc)):
            f = pflow.record_to_flow(r, cache, resolve)
            assert f == rflow.record_to_flow(r, rcache, resolve)
            pm = ppb.flow_dict_to_proto(f, node_name="node-a")
            rm = rpb.flow_dict_to_proto(f, node_name="node-a")
            raw = pm.SerializeToString(deterministic=True)
            assert raw == rm.SerializeToString(deterministic=True)
            # Each package's bytes parse in the other's classes.
            assert ppb.flow_proto_to_dict(ppb.Flow.FromString(raw)) == \
                rpb.flow_proto_to_dict(rpb.Flow.FromString(raw))
            assert ppb.Flow.FromString(rm.SerializeToString()) == pm
            flt = rpb.FlowFilterPB(source_ip=["10.0"], verdict=[2])
            assert ppb.proto_filter_matches(
                [ppb.FlowFilterPB.FromString(flt.SerializeToString())], pm
            ) == rpb.proto_filter_matches([flt], rm)


def _requests(pb):
    req = pb.GetFlowsRequest(number=25, follow=True)
    w = req.whitelist.add()
    w.source_ip.append("10.0.0.1")
    w.verdict.extend([1, 2])
    w.protocol.append("tcp")
    w.destination_port.append("443")
    b = req.blacklist.add()
    b.source_pod.append("prod/db-0")
    req.since.seconds, req.since.nanos = 1_700_000_000, 5
    req.until.seconds, req.until.nanos = 1_700_000_100, 999_999_999
    bare = pb.GetFlowsRequest()
    bare.until.nanos = 2000
    status = pb.ServerStatusResponse(num_flows=7, max_flows=4096, seen_flows=1 << 40,
                                     uptime_ns=123456789, version="retina-tpu")
    note = pb.ChangeNotification(name="node-x", address="10.99.0.7:4244", type=1)
    note.tls.enabled, note.tls.server_name = True, "node-x.hubble"
    resp = pb.GetFlowsResponse(node_name="node-a")
    resp.lost_events.source = 3
    resp.lost_events.num_events_lost = 17
    return [req, bare, status, note, resp, pb.NotifyRequest(), pb.ServerStatusRequest()]


def test_request_and_status_bytes_match_reference_with_time_bounds():
    for pm, rm in zip(_requests(ppb), _requests(rpb)):
        raw = pm.SerializeToString(deterministic=True)
        assert raw == rm.SerializeToString(deterministic=True)
        assert type(rm).FromString(raw) == rm and type(pm).FromString(raw) == pm
    req = ppb.GetFlowsRequest.FromString(_requests(rpb)[0].SerializeToString())
    assert req.HasField("since") and req.until.nanos == 999_999_999


def test_proto_module_imports_without_protobuf():
    code = ("import sys\nsys.modules['google.protobuf'] = None\n"
            "from retina_tpu_torch.hubble import proto\n"
            "try:\n    proto.Flow\nexcept ImportError:\n    print('lazy')\n")
    out = subprocess.run([__import__("sys").executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "lazy", out.stderr


# ------------------------------------------------------------------ wire
def _serve(mod, recs=None, **kw):
    obs = (pobserver if mod is pserver else robserver).FlowObserver(capacity=1 << 8)
    srv = mod.HubbleServer(obs, addr="127.0.0.1:0", **kw)
    srv.start()
    if recs is not None:
        obs.consume(recs)
    return obs, srv


IMPLS = {"port": pserver, "reference": rserver}


@pytest.mark.parametrize("server_impl", ["port", "reference"])
@pytest.mark.parametrize("client_impl", ["port", "reference"])
def test_msgpack_surface_across_packages(server_impl, client_impl):
    recs = make_records(7, n=40)
    peers = [{"name": "node-b", "address": "10.0.0.2:4244"}]
    _, srv = _serve(IMPLS[server_impl], recs, peers=peers)
    client = IMPLS[client_impl].HubbleClient(f"127.0.0.1:{srv.port}")
    try:
        want = [rflow.record_to_flow(r) for r in recs]
        assert list(client.get_flows(last=40, timeout=10)) == want
        assert list(client.get_flows(last=5, timeout=10)) == want[-5:]
        filt = IMPLS[client_impl].FlowFilter(verdict="DROPPED", protocol="TCP")
        assert list(client.get_flows(filter=filt, timeout=10)) == [
            f for f in want if rflow.FlowFilter(verdict="DROPPED", protocol="TCP").matches(f)]
        st = client.server_status()
        assert (st["num_flows"], st["max_flows"], st["seen_flows"]) == (40, 256, 40)
        assert client.list_peers() == peers
    finally:
        client.close()
        srv.stop()


def _pb_get_flows(chan, pb, raw: bool = False):
    return chan.unary_stream(
        "/observer.Observer/GetFlows",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=(lambda b: b) if raw else pb.GetFlowsResponse.FromString)


@pytest.mark.parametrize("seed", SEEDS)
def test_cilium_surface_bytes_equal_the_reference_servers(seed):
    """A raw Cilium-surface stub (method names only, response bytes kept)
    reads the same GetFlows bytes from both packages' servers, and the
    ``since``/``until`` bounds cut both alike."""
    recs = make_records(seed)
    got = {}
    for name, mod in IMPLS.items():
        _, srv = _serve(mod, recs, node_name="node-a")
        chan = grpc.insecure_channel(f"127.0.0.1:{srv.port}")
        try:
            get_flows = _pb_get_flows(chan, rpb, raw=True)
            out = []
            for req in (rpb.GetFlowsRequest(number=50), rpb.GetFlowsRequest()):
                out.append(list(get_flows(req, timeout=10)))
            mid = int(np.median((recs[:, F.TS_HI].astype(np.uint64) << np.uint64(32))
                                | recs[:, F.TS_LO]))
            for field in ("since", "until"):
                req = rpb.GetFlowsRequest()
                getattr(req, field).seconds = mid // 1_000_000_000
                getattr(req, field).nanos = mid % 1_000_000_000
                out.append(list(get_flows(req, timeout=10)))
            flt = rpb.GetFlowsRequest()
            flt.whitelist.add().verdict.append(2)
            flt.blacklist.add().protocol.append("UDP")
            out.append(list(get_flows(flt, timeout=10)))
            got[name] = out
        finally:
            chan.close()
            srv.stop()
    assert got["port"] == got["reference"]
    everything, since, until = got["port"][1], got["port"][2], got["port"][3]
    assert len(got["port"][0]) == 50 and len(everything) == len(recs)
    assert 0 < len(since) < len(recs) and 0 < len(until) < len(recs)
    # Field numbers on the wire: GetFlowsResponse.flow = 1, node_name = 1000,
    # Flow.IP = 5 (source 1), Flow.node_name = 11.
    resp = rpb.GetFlowsResponse.FromString(everything[0])
    assert resp.node_name == "node-a" and resp.flow.node_name == "node-a"
    assert resp.flow.IP.source == pflow.record_to_flow(recs[0])["ip"]["source"]


def test_port_server_cilium_semantics():
    """last-N of the matching flows, the in-stream LostEvent of a lapped
    follower, and a follow stream past its ``until`` ending."""
    obs, srv = _serve(pserver)
    chan = grpc.insecure_channel(f"127.0.0.1:{srv.port}")
    try:
        get_flows = _pb_get_flows(chan, rpb)
        recs = make_records(3, n=120)
        recs[:, F.TS_HI] = 0
        recs[:, F.TS_LO] = 1000
        drops = recs[recs[:, F.VERDICT] == 2][:5]
        fwd = recs[recs[:, F.VERDICT] != 2]
        obs.consume(drops)
        obs.consume(fwd)
        req = rpb.GetFlowsRequest(number=3)
        req.whitelist.add().verdict.append(2)
        got = list(get_flows(req, timeout=10))
        assert [g.flow.IP.source for g in got] == [
            pflow.record_to_flow(r)["ip"]["source"] for r in drops[-3:]]

        stream = get_flows(rpb.GetFlowsRequest(follow=True), timeout=15)
        it = iter(stream)
        buffered = [next(it) for _ in range(len(drops) + len(fwd))]
        assert all(r.WhichOneof("response_types") == "flow" for r in buffered)
        obs.consume(np.concatenate([fwd] * 8))  # laps the 256-slot ring at once
        lost = None
        for resp in it:
            if resp.WhichOneof("response_types") == "lost_events":
                lost = resp.lost_events
                break
        assert lost is not None and lost.source == 3 and lost.num_events_lost > 0
        stream.cancel()

        req = rpb.GetFlowsRequest(follow=True)
        req.until.nanos = 2000
        stream = get_flows(req, timeout=15)
        first = next(stream)
        assert first.flow.time.nanos == 1000
        late = recs[:1].copy()
        late[:, F.TS_LO] = 9000
        obs.consume(late)
        rest = list(stream)  # ends once a flow past `until` arrives
        assert all(r.flow.time.nanos <= 2000 for r in rest)
    finally:
        chan.close()
        srv.stop()


def test_server_status_peer_notify_and_self_metrics():
    obs, srv = _serve(pserver, make_records(5, n=7),
                      peers=lambda: [{"name": "node-b", "address": "10.0.0.2:4244"}])
    chan = grpc.insecure_channel(f"127.0.0.1:{srv.port}")
    try:
        status = chan.unary_unary(
            "/observer.Observer/ServerStatus",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=rpb.ServerStatusResponse.FromString,
        )(rpb.ServerStatusRequest(), timeout=5)
        assert (status.seen_flows, status.max_flows, status.version) == (7, 256, "retina-tpu")
        stream = chan.unary_stream(
            "/peer.Peer/Notify", request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=rpb.ChangeNotification.FromString)(rpb.NotifyRequest(),
                                                                     timeout=5)
        first = next(iter(stream))
        assert (first.name, first.address, first.type) == ("node-b", "10.0.0.2:4244", 1)
        stream.cancel()
        assert len(list(_pb_get_flows(chan, rpb)(rpb.GetFlowsRequest(number=3),
                                                  timeout=10))) == 3
        text = exporter.get_exporter().gather_hubble_text().decode()
        assert 'hubble_get_flows_requests_total{surface="protobuf"} 1.0' in text
        assert "hubble_flows_processed_total{" in text
        assert "hubble_seen_flows 7.0" in text  # live via set_function
        assert "hubble_" not in exporter.get_exporter().gather_text().decode()
    finally:
        chan.close()
        srv.stop()


def test_fleet_ship_without_and_with_an_aggregator():
    _, plain = _serve(pserver)
    accepted = []
    _, fronting = _serve(pserver, fleet_ingest=lambda frame: accepted.append(frame) or True)
    try:
        assert not pserver.FleetShipClient(f"127.0.0.1:{plain.port}").ship(b"RFLT")
        client = rserver.FleetShipClient(f"127.0.0.1:{fronting.port}")
        assert client.ship(b"RFLT-frame") and accepted == [b"RFLT-frame"]
        client.close()
    finally:
        plain.stop()
        fronting.stop()


def _certs(tmp_path, name: str, ca=None):
    key, crt = tmp_path / f"{name}.key", tmp_path / f"{name}.crt"
    if ca is None:
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
             "-out", str(crt), "-days", "1", "-subj", f"/CN={name}",
             "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
            check=True, capture_output=True)
    else:
        csr = tmp_path / f"{name}.csr"
        subprocess.run(["openssl", "req", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
                        "-out", str(csr), "-subj", f"/CN={name}"],
                       check=True, capture_output=True)
        subprocess.run(["openssl", "x509", "-req", "-in", str(csr), "-CA", str(ca[1]),
                        "-CAkey", str(ca[0]), "-CAcreateserial", "-out", str(crt), "-days", "1"],
                       check=True, capture_output=True)
    return key, crt


def _status(chan):
    return chan.unary_unary(
        "/observer.Observer/ServerStatus",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=rpb.ServerStatusResponse.FromString,
    )(rpb.ServerStatusRequest(), timeout=10)


def test_tls_and_mutual_tls(tmp_path):
    key, crt = _certs(tmp_path, "server")
    _, srv = _serve(pserver, make_records(1, n=2), tls_cert=str(crt), tls_key=str(key))
    try:
        assert srv.tls
        creds = grpc.ssl_channel_credentials(crt.read_bytes())
        with grpc.secure_channel(f"localhost:{srv.port}", creds) as chan:
            assert _status(chan).seen_flows == 2
        with grpc.insecure_channel(f"127.0.0.1:{srv.port}") as bad, \
                pytest.raises(grpc.RpcError):
            _status(bad)
    finally:
        srv.stop()
    # Mutual TLS: the client must present a certificate the client CA signed.
    ca = _certs(tmp_path, "client-ca")
    ckey, ccrt = _certs(tmp_path, "client", ca=ca)
    _, srv = _serve(pserver, make_records(2, n=3), tls_cert=str(crt), tls_key=str(key),
                    tls_client_ca=str(ca[1]))
    try:
        good = grpc.ssl_channel_credentials(crt.read_bytes(), ckey.read_bytes(),
                                            ccrt.read_bytes())
        with grpc.secure_channel(f"localhost:{srv.port}", good) as chan:
            assert _status(chan).seen_flows == 3
        anon = grpc.ssl_channel_credentials(crt.read_bytes())
        with grpc.secure_channel(f"localhost:{srv.port}", anon) as chan, \
                pytest.raises(grpc.RpcError):
            _status(chan)
    finally:
        srv.stop()


@pytest.mark.parametrize("client_impl", ["port", "reference"])
def test_unix_socket_observe(tmp_path, client_impl):
    sock = str(tmp_path / "hubble.sock")
    recs = make_records(4, n=6)
    _, srv = _serve(pserver, recs, unix_socket=sock)
    client = IMPLS[client_impl].HubbleClient(f"unix:{sock}")
    try:
        assert list(client.get_flows(last=10, timeout=5)) == [
            rflow.record_to_flow(r) for r in recs]
        assert client.server_status()["seen_flows"] == 6
    finally:
        client.close()
        srv.stop()


def test_second_server_construction_does_not_raise():
    _, srv1 = _serve(pserver)
    srv1.stop()
    obs2, srv2 = _serve(pserver, make_records(0, n=2))
    try:
        assert "hubble_seen_flows 2.0" in exporter.get_exporter().gather_hubble_text().decode()
    finally:
        srv2.stop()


def test_msgpack_follow_lost_markers():
    obs, srv = _serve(pserver)
    client = rserver.HubbleClient(f"127.0.0.1:{srv.port}")
    try:
        it = iter(client.get_flows(follow=True, lost_markers=True, timeout=15))
        recs = make_records(5, n=1)
        obs.consume(recs)
        assert next(it) == rflow.record_to_flow(recs[0])
        obs.consume(np.concatenate([make_records(6, n=64)] * 16))  # laps 256 slots at once
        marker = next((f for f in it if "lost_events" in f and "ip" not in f), None)
        assert marker is not None and marker["lost_events"] > 0
    finally:
        client.close()
        srv.stop()


@pytest.mark.parametrize("peer_impl", ["port", "reference"])
def test_relay_accounts_peer_reported_loss(peer_impl):
    """Loss reported BY a peer (its ring lapped the relay's follower) shows
    at the relay as hubble_lost_events_total{source="PEER_STREAM"}, and the
    flows it did get keep the peer's node_name."""
    mod = IMPLS[peer_impl]
    obs = (pobserver if mod is pserver else robserver).FlowObserver(capacity=1 << 3)
    srv = mod.HubbleServer(obs, addr="127.0.0.1:0", node_name="node-a")
    srv.start()
    relay = HubbleRelay(peers=[{"name": "node-a", "address": f"127.0.0.1:{srv.port}"}],
                        addr="127.0.0.1:0", node_name="relay-test", retry_s=0.2)
    relay.start()
    try:
        recs = make_records(8, n=64)

        def lapped() -> bool:
            obs.consume(recs)  # laps the 8-slot ring every time
            return relay.peer_lost > 0

        assert wait_until(lapped, deadline_s=60.0, poll_s=0.2), "peer LostEvent not accounted"
        text = exporter.get_exporter().gather_hubble_text().decode()
        assert 'hubble_lost_events_total{source="PEER_STREAM"}' in text
        assert relay.observer.flows_seen > 0
        flows, _ = relay.observer.snapshot_flows()
        assert {f["node_name"] for f in flows} == {"node-a"}
        assert relay.peer_list() == [{"name": "node-a", "address": f"127.0.0.1:{srv.port}"}]
    finally:
        relay.stop()
        srv.stop()


# ---------------------------------------------------- the external channel
def test_plugin_channel_broadcast_feeds_the_monitor_agent():
    """PluginManager.setup_channel hands the monitor agent's channel to
    every plugin; ``emit`` mirrors each block there and counts a full
    channel's drop under stage="external" without blocking."""
    from retina_tpu_torch.config import Config
    from retina_tpu_torch.managers.pluginmanager import PluginManager
    from retina_tpu_torch.plugins.api import QueueSink

    cfg = Config(enabled_plugins=["mock", "dropreason"], device_platform="cpu")
    pm = PluginManager(cfg, QueueSink(1 << 10))
    ma = MonitorAgent(channel_depth=2)
    pm.setup_channel(ma.channel)
    assert pm.plugins and all(p.external is ma.channel for p in pm.plugins.values())
    plugin = next(iter(pm.plugins.values()))
    recs = make_records(9, n=4)
    for _ in range(3):
        assert plugin.emit(recs) == 4
    lost = metrics.get_metrics().lost_events.labels(stage="external", plugin=plugin.name)
    assert lost._value == 4 and plugin._external_lost == 4
    got: list = []
    done = threading.Event()
    ma.register_consumer(lambda block: (got.append(block), len(got) == 2 and done.set()))
    stop = threading.Event()
    ma.start(stop)
    try:
        assert done.wait(10.0)
        assert [len(b) for b in got] == [4, 4]
        with pytest.raises(queue.Empty):
            ma.channel.get_nowait()
    finally:
        stop.set()
