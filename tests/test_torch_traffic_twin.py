"""PyTorch port against the JAX package, the traffic driver and the chaos
search: the same spec and seed through the JAX ``TrafficEngine`` and the
port's (engines on the host) must give byte-equal workload traces and
equal summaries, exactly (the summary reads no clock); the same search
seed from copies of the committed corpus must give byte-equal search logs
and equal corpora. Both packages' registries are zeroed before each run
(``torch_parity.fresh_registries``), so what ran earlier in the process
does not leak into a summary.
"""

from __future__ import annotations

import asyncio
import os
import shutil

import pytest

from josefine_tpu.chaos.search import ChaosSearch as JaxChaosSearch
from josefine_tpu.chaos.search import Corpus as JaxCorpus
from josefine_tpu.chaos.search import SearchLimits as JaxSearchLimits
from josefine_tpu.workload.driver import TrafficEngine as JaxTrafficEngine
from josefine_tpu.workload.model import WorkloadSpec as JaxWorkloadSpec
from josefine_tpu_torch.chaos.search import ChaosSearch, Corpus, SearchLimits
from josefine_tpu_torch.workload.driver import TrafficEngine
from josefine_tpu_torch.workload.model import WorkloadSpec

from torch_parity import fresh_registries

# ``tests/test_workload.py``'s small multi-tenant spec.
SMALL = dict(tenants=3, partitions_per_topic=2, produce_per_tick=5.0, consumers_per_tenant=2,
             churn_every_ticks=8, payload_bytes=40)
CORPUS_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "chaos_corpus")


def traffic_twin(spec: dict, seed: int, ticks: int, **kw):
    """The traffic soak through both packages; the port's driver and
    summary, after asserting equal traces and summaries. The summary reads
    the engine's commit-latency histogram from the process-global registry,
    so both runs start on fresh registries."""
    fresh_registries()
    want_drv = JaxTrafficEngine(JaxWorkloadSpec(**spec), seed, backend="jax", **kw)
    want = asyncio.run(want_drv.run(ticks))
    fresh_registries()
    got_drv = TrafficEngine(WorkloadSpec(**spec), seed, device="cpu", **kw)
    got = asyncio.run(got_drv.run(ticks))
    assert got_drv.trace.jsonl() == want_drv.trace.jsonl()
    assert set(got) == set(want)
    for key in sorted(want):
        assert got[key] == want[key], f"summary {key}: port {got[key]!r:.300} jax {want[key]!r:.300}"
    return got_drv, got


@pytest.mark.parametrize("kw", [
    pytest.param({}, id="default"),
    pytest.param(dict(replication=3), id="replication-3"),
    pytest.param(dict(replication=3, device_route=True, payload_ring=True), id="routed-ring"),
    pytest.param(dict(active_set=True, window=4, hb_ticks=4), id="active-set-window-4"),
])
def test_traffic_twin(kw):
    drv, s = traffic_twin(SMALL, 11, 40, **kw)
    assert s["committed"] > 0 and s["committed"] == s["path_stats"]["replicated"]
    assert s["backpressure"]["errors"] == 0
    assert s["latency_ticks"]["n"] == s["committed"]
    if kw.get("device_route"):
        assert s["route_stats"]["routed_msgs"] > 0
    assert drv.trace.counts()["produce_ok"] == s["committed"]


def test_chaos_search_twin(tmp_path):
    """Two search iterations from the committed corpus, seed 21: byte-equal
    search logs, equal admitted entries (signatures, features, schedules)."""
    runs = []
    for side, search, corpus, limits, extra in (
            ("jax", JaxChaosSearch, JaxCorpus, JaxSearchLimits, {}),
            ("port", ChaosSearch, Corpus, SearchLimits, {"device": "cpu"})):
        fresh_registries()
        path = str(tmp_path / f"corpus_{side}")
        shutil.copytree(CORPUS_FIXTURE, path)
        s = search(21, corpus(path), limits=limits(max_horizon=160, max_heal=60),
                   minimize=False, log_path=str(tmp_path / f"log_{side}.jsonl"), **extra)
        s.run(budget_iters=2)
        runs.append(s)
    want, got = runs
    log = (tmp_path / "log_port.jsonl").read_bytes()
    assert log and log == (tmp_path / "log_jax.jsonl").read_bytes()
    assert got.corpus.entries == want.corpus.entries
    assert got.summary() == want.summary()
