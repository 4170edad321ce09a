"""The lanes probes (``retina_tpu_torch/lanes_probe.py``) on the CPU at small
shapes: the proxy's host time a step from the lanes fed by two producers,
and the fleet-role agent child answering ``/fleet/query``."""

from __future__ import annotations

from test_torch_daemon import SMALL

from retina_tpu_torch import lanes_probe


def test_proxy_probe_reports_the_proxys_host_time_a_step():
    small = {k: v for k, v in SMALL.items() if k != "feed_workers"}
    got = lanes_probe.proxy(1, seconds=1.0, device="cpu", n_blocks=4, block=256,
                            n_flows=400, **small)
    assert got["steps"] > 0 and got["ms_a_step"] > 0 and got["events_per_s"] > 0
    assert got["lost"] == {}


def test_fleet_child_probe_answers_from_the_childs_merged_epochs():
    sets = ("device_platform=cpu", "synthetic_rate=20000", "synthetic_flows=1000",
            *(f"{k}={v}" for k, v in SMALL.items()))
    got = lanes_probe.fleet_child(limit_s=120.0, extra_sets=sets)
    assert got["code"] == 200, got
    assert got["exit"] == 0 and got["merged_s"] <= got["wall_s"]
    assert set(got["states"]) <= {"SHEDDING", "DEGRADED", "SAMPLING"}
    assert got["feed"]["workers"] == SMALL["feed_workers"] or got["feed"]["mode"] == "inline"
