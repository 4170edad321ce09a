"""The port's lease election (``retina_tpu_torch/operator/leaderelection.py``)
against the reference's, each on its own fake apiserver
(``chip_smoke.FakeKube``, whose PUT answers a stale resourceVersion with
409): acquisition, a follower held off by renewals, a takeover after
expiry timed on the follower's own clock, the graceful release, the renew
grace through transient errors, and the 409 that a stale takeover loses.
Each scenario's trace (who leads, the lease's holder and transitions, the
writes' methods and answers) is equal on both packages."""

from __future__ import annotations

import copy
import time

import pytest

from _torch_kube import IMPLS, mod
from chip_smoke import FakeKube

LEASES = "/apis/coordination.k8s.io/v1/leases"
NAME = "kube-system/retina-tpu-operator"
DURATION_S = 1.0  # the Lease holds whole seconds


def lease(kube: FakeKube) -> dict:
    doc = kube.objects.get(LEASES, {}).get(NAME)
    return {} if doc is None else {k: doc["spec"].get(k) for k in (
        "holderIdentity", "leaseDurationSeconds", "leaseTransitions")}


def electors(impl: str, kube: FakeKube, tmp_path, *names: str, **kw):
    le = mod(impl, "operator.leaderelection")
    kc = kube.kubeconfig(tmp_path / f"{impl}.kc")
    client = mod(impl, "operator.kubeclient").KubeClient
    return [le.LeaderElector(client(kc), identity=n, lease_duration_s=DURATION_S,
                             renew_period_s=0.1, **kw) for n in names]


def run_pair(scenario, tmp_path) -> list:
    """``scenario(impl, kube, tmp_path) -> trace`` on both packages; the
    traces must be equal. Returns the port's."""
    traces = []
    for impl in IMPLS:
        kube = FakeKube()
        try:
            traces.append(scenario(impl, kube, tmp_path))
        finally:
            kube.close()
    assert traces[1] == traces[0]
    return traces[1]


def acquire(impl, kube, tmp_path):
    (a,) = electors(impl, kube, tmp_path, "op-a")
    a.run_once()
    return [a.is_leader(), lease(kube), [m for m, _, _ in kube.writes]]


def test_a_single_elector_acquires(tmp_path):
    assert run_pair(acquire, tmp_path) == [
        True, {"holderIdentity": "op-a", "leaseDurationSeconds": 1, "leaseTransitions": 0},
        ["POST"]]


def follow(impl, kube, tmp_path):
    a, b = electors(impl, kube, tmp_path, "op-a", "op-b")
    trace = []
    for _ in range(4):
        a.run_once()
        b.run_once()
        trace.append((a.is_leader(), b.is_leader()))
        time.sleep(DURATION_S / 3)
    return trace + [lease(kube)]


def test_a_follower_does_not_lead_while_the_leader_renews(tmp_path):
    trace = run_pair(follow, tmp_path)
    assert trace[:4] == [(True, False)] * 4
    assert trace[4]["holderIdentity"] == "op-a"


def failover(impl, kube, tmp_path):
    calls = []
    a, b = electors(impl, kube, tmp_path, "op-a", "op-b",
                    on_started_leading=lambda: calls.append("start"),
                    on_stopped_leading=lambda: calls.append("stop"))
    trace = []
    a.run_once()
    b.run_once()  # b's first sight of a's lease starts b's clock
    trace.append((a.is_leader(), b.is_leader()))
    time.sleep(DURATION_S + 0.3)  # a never renews
    b.run_once()
    trace.append((a.is_leader(), b.is_leader(), lease(kube)))
    a.run_once()  # a sees b's live lease and follows
    trace.append((a.is_leader(), b.is_leader()))
    b.stop()  # graceful release: the holder zeroed
    trace.append((b.is_leader(), lease(kube)))
    a.run_once()
    trace.append((a.is_leader(), lease(kube), calls))
    return trace


def test_takeover_after_expiry_and_the_graceful_release(tmp_path):
    trace = run_pair(failover, tmp_path)
    assert trace[0] == (True, False)
    assert trace[1][:2] == (True, True) and trace[1][2]["holderIdentity"] == "op-b"
    assert trace[1][2]["leaseTransitions"] == 1
    assert trace[2] == (False, True)
    assert trace[3] == (False, {"holderIdentity": "", "leaseDurationSeconds": 1,
                                "leaseTransitions": 1})
    assert trace[4][0] and trace[4][1]["holderIdentity"] == "op-a"
    assert trace[4][1]["leaseTransitions"] == 2
    # a: start, stop (at its next round); b: start, stop; a: start.
    assert trace[4][2] == ["start", "start", "stop", "stop", "start"]


def grace(impl, kube, tmp_path):
    (a,) = electors(impl, kube, tmp_path, "op-a")
    a.run_once()
    server = a.client.server
    a.client.server = "http://127.0.0.1:1"  # connection refused
    a.run_once()
    trace = [a.is_leader()]  # within the lease it last wrote: still leading
    time.sleep(DURATION_S + 0.2)
    a.run_once()
    trace.append(a.is_leader())  # the renew deadline passed: demoted
    a.client.server = server
    a.run_once()
    trace.append((a.is_leader(), lease(kube)))
    return trace


def test_renew_grace_through_transient_errors(tmp_path):
    assert run_pair(grace, tmp_path) == [True, False, (True, {
        "holderIdentity": "op-a", "leaseDurationSeconds": 1, "leaseTransitions": 0})]


def race(impl, kube, tmp_path):
    a, b, c = electors(impl, kube, tmp_path, "op-a", "op-b", "op-c")
    a.run_once()
    b.run_once()
    c.run_once()
    time.sleep(DURATION_S + 0.3)
    stale = copy.deepcopy(c._get_lease())
    b.run_once()  # wins the takeover: the lease's resourceVersion moves on
    c._get_lease = lambda: copy.deepcopy(stale)  # c read before b wrote
    c.run_once()
    return [(a.is_leader(), b.is_leader(), c.is_leader()), lease(kube),
            [(m, p.rsplit("/", 1)[-1]) for m, p, _ in kube.writes]]


def test_a_stale_takeover_loses_the_409_race(tmp_path):
    trace = run_pair(race, tmp_path)
    assert trace[0] == (True, True, False)  # a has not run since: it still thinks it leads
    assert trace[1]["holderIdentity"] == "op-b" and trace[1]["leaseTransitions"] == 1
    assert trace[2] == [("POST", "leases"), ("PUT", "retina-tpu-operator"),
                        ("PUT", "retina-tpu-operator")]


@pytest.mark.parametrize("impl", IMPLS)
def test_the_election_loop_runs_and_releases_on_stop(impl, tmp_path):
    kube = FakeKube()
    try:
        (a,) = electors(impl, kube, tmp_path, "op-a")
        a.start()
        deadline = time.monotonic() + 10
        while not a.is_leader():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        a.stop()
        assert not a.is_leader() and lease(kube)["holderIdentity"] == ""
    finally:
        kube.close()
