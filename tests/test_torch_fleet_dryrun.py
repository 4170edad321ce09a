"""The port's dryruns against the reference's (CPU), each at its reference
defaults and seed: the time-travel closed loop (``run_query_dryrun``), the
fleet rollup with a killed node (``run_dryrun``), the invertible key
recovery through a SHEDDING episode (``run_invertible_dryrun``) and the
64-node query storm with the detector trio (``run_fleetquery_dryrun``).

Each port scorecard must hold ``ok`` and the reference's recall figures.
Which nodes an epoch merges (and so which epochs straggle) follows the
threads' timing in both packages, so the recall is compared, not the node
lists; the latencies inside each scorecard's ``ok`` are the dryruns' own
gates. The query storm runs at 16 nodes in both packages (the reference's
default is 64): the CPU's plain fold of 64 node snapshots takes ~0.2 s,
and the storm's p99 gate is 0.1 s. ``chip_smoke.py`` runs all four at
their defaults on the card.
"""

from __future__ import annotations

import pytest

from retina_tpu.fleet.dryrun import run_dryrun as jrun_dryrun
from retina_tpu.fleet.dryrun import run_invertible_dryrun as jrun_invertible_dryrun
from retina_tpu.fleetquery.dryrun import run_fleetquery_dryrun as jrun_fleetquery_dryrun
from retina_tpu.timetravel.dryrun import run_query_dryrun as jrun_query_dryrun
from retina_tpu_torch import exporter, metrics
from retina_tpu_torch.fleet.dryrun import run_dryrun, run_invertible_dryrun
from retina_tpu_torch.fleetquery.dryrun import run_fleetquery_dryrun
from retina_tpu_torch.timetravel.dryrun import run_query_dryrun


@pytest.fixture(autouse=True)
def fresh_port_metrics():
    exporter.reset_for_tests()
    metrics.reset_for_tests()
    yield


def test_query_dryrun_matches_the_reference():
    got = run_query_dryrun(device="cpu")
    want = jrun_query_dryrun()
    assert got["ok"], got["checks"]
    assert want["ok"], want["checks"]
    for key in ("burst_epoch", "detected_epoch", "detected_dims", "n_attack_keys", "recall"):
        assert got[key] == want[key], key
    assert got["capture"]["only_attributed"] and got["capture"]["attack_rows"] > 0


def test_fleet_dryrun_matches_the_reference():
    got = run_dryrun(device="cpu")
    want = jrun_dryrun()
    assert got["ok"] and want["ok"], (got, want)
    assert got["recall_min"] == want["recall_min"] == 1.0
    assert got["epochs_merged"] == want["epochs_merged"] == 5
    assert got["frames_shipped"] == want["frames_shipped"]
    assert got["killed_node"] == want["killed_node"]
    assert all(n <= 7 for n in got["post_kill_nodes"]) and got["trace_lineage_ok"]
    assert got["tenant_series_max_observed"] <= got["tenant_series_bound"]


def test_invertible_dryrun_matches_the_reference():
    got = run_invertible_dryrun(device="cpu")
    want = jrun_invertible_dryrun()
    assert got["ok"] and want["ok"], (got, want)
    for key in ("recall_min", "hi_recall_min", "shed_epochs_scored", "frames_shipped",
                "raw_keys_on_wire"):
        assert got[key] == want[key], key
    for key in ("recall_per_epoch", "hi_recall_per_epoch"):
        assert {int(e): v for e, v in got[key].items()} == {
            int(e): v for e, v in want[key].items()}, key


def test_fleetquery_dryrun_matches_the_reference():
    got = run_fleetquery_dryrun(nodes=16, device="cpu")
    want = jrun_fleetquery_dryrun(nodes=16)
    assert got["ok"], ({k: v for k, v in got["checks"].items() if not v}, got["storm"])
    assert want["ok"], ({k: v for k, v in want["checks"].items() if not v}, want["storm"])
    assert got["storm"]["queries"] == want["storm"]["queries"] == 1000
    assert got["storm"]["killed"] == want["storm"]["killed"] == 1
    # The survivors over the roster, in both (a node that misses its deadline
    # under load adds a transient coverage of its own).
    steady = [15, 16]
    assert steady in [list(c) for c in got["storm"]["partial_coverages"]]
    assert steady in [list(c) for c in want["storm"]["partial_coverages"]]
    for name, sc in want["detectors"].items():
        mine = got["detectors"][name]
        for key in ("attack_epoch", "fired", "n_attack_keys", "recall"):
            assert mine[key] == sc[key], (name, key)
        for det, score in sc["final_scores"].items():
            assert mine["final_scores"][det] == pytest.approx(score, abs=2e-3), (name, det)
    assert got["benign"] == want["benign"]
