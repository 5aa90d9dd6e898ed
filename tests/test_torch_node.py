"""PyTorch port, the node and its entry points (``josefine_tpu_torch/node.py``,
``josefine``, ``python -m josefine_tpu_torch``): the cases of the JAX
package's node suites run against the port, each engine on the host
(``device="cpu"``):

* ``test_integration``: full nodes over localhost sockets (ApiVersions,
  CreateTopics, Produce and Fetch, leader failover);
* ``test_partition_groups``: one consensus group per partition, restarts;
* ``test_reset_safety``: the vote parole of a reset replica, scripted;
* ``test_entrypoint``: ``josefine()`` from the port's example TOMLs;
* ``test_metrics`` and ``test_events_endpoint``: the node's HTTP endpoints.

The suites that import ``NodeManager`` and ``make_batch`` from
``test_integration``, or ``_metadata`` and ``_produce_one`` from
``test_node_chaos``, get the port's through ``torch_parity``; a case that
builds a node of the JAX package fails (``only_port_nodes``). The fixed
ports of the JAX suites move to their own 20,000s, so both can run at once.

Then the port's own cases: the CLI in a subprocess, a node whose config
names the card on a host without one, and a node sharded over a device
mesh (two shards of the host; too few cards raise).
"""

import asyncio
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

import torch_parity
from josefine_tpu_torch import Shutdown, josefine_with_config, load_config
from josefine_tpu_torch import node as port_node
from josefine_tpu_torch.kafka import client as kafka_client
from josefine_tpu_torch.kafka.codec import ApiKey
from torch_parity import HOST, INTEGRATION_EDITS, only_port_nodes, repointed  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "josefine_tpu_torch", "examples")
_ON_THE_HOST = [HOST["step_params"], HOST["RaftEngine"]]


def _moved(*texts: str, digits: int) -> list[tuple[str, str]]:
    """Edits moving every fixed port of ``digits`` digits in ``texts`` up to
    its own 20,000s (7861 -> 27861, 16692 -> 26692)."""
    import re

    return [(t, re.sub(r"\b([0-9]{%d})\b" % digits,
                       lambda m: str(int(m.group(1)) % 10_000 + 20_000), t)) for t in texts]


_cases = [
    repointed("test_integration", edits=INTEGRATION_EDITS),
    repointed("test_partition_groups", edits=[HOST["NodeManager"]]),
    repointed("test_reset_safety", edits=[
        ("from test_integration import NodeManager, make_batch",
         "from torch_parity import NodeManager, make_batch"),
        ("from test_node_chaos import _metadata, _produce_one",
         "from torch_parity import _metadata, _produce_one"),
        *_ON_THE_HOST,
    ]),
    repointed("test_entrypoint", edits=[
        ('EXAMPLE = pathlib.Path(__file__).parent.parent / "examples"',
         'EXAMPLE = pathlib.Path(__file__).parent.parent / "josefine_tpu_torch" / "examples"'),
        ("toml = EXAMPLE.read_text()",
         "toml = EXAMPLE.read_text().replace('device = \"cuda\"', 'device = \"cpu\"')"),
        ("""toml = (ex / f"node-{i}.toml").read_text()""",
         """toml = (ex / f"node-{i}.toml").read_text().replace('device = "cuda"',
                                                             'device = "cpu"')"""),
        ("""re.sub(r'"/tmp/josefine-tpu/single'""", """re.sub(r'"/tmp/josefine-tpu-torch/single'"""),
        ("""re.sub(r'"/tmp/josefine-tpu/multi/node-(\\d)'""",
         """re.sub(r'"/tmp/josefine-tpu-torch/multi/node-(\\d)'"""),
        *_moved('toml.replace("port = 6669", "port = 16692")',
                'toml.replace("port = 8844", "port = 18862")',
                'kafka_client.connect("127.0.0.1", 18862)',
                "raft_ports = {6669: 16791, 6670: 16792, 6671: 16793}",
                "broker_ports = {8844: 18871, 8845: 18872, 8846: 18873}",
                'kafka_client.connect("127.0.0.1", 18871)', digits=5),
    ]),
    repointed("test_metrics", edits=[
        *_ON_THE_HOST,
        ("cfg.broker.metrics_port = 7863", 'cfg.broker.metrics_port = 7863\n        '
                                           'cfg.engine.device = "cpu"'),
        *_moved("cfg.raft.port = 7861", "cfg.broker.port = 7862",
                "cfg.broker.metrics_port = 7863", '_http_get(7863, "/metrics")',
                '_http_get(7863, "/state")', digits=4),
    ]),
    repointed("test_events_endpoint", edits=[
        ("cfg.broker.metrics_port = 7873", 'cfg.broker.metrics_port = 7873\n        '
                                           'cfg.engine.device = "cpu"'),
        *_moved("cfg.raft.port = 7871", "cfg.broker.port = 7872",
                "cfg.broker.metrics_port = 7873", '_get(7873, "/events?kind=election_won")',
                '_get(7873, "/metrics")', digits=4),
    ]),
]
_names = [set(c) for c in _cases]
assert sum(map(len, _names)) == len(set().union(*_names)), "two suites share a case name"
for _c in _cases:
    globals().update(_c)


def test_node_manager_builds_port_nodes(tmp_path, only_port_nodes):
    """The ``NodeManager`` every re-pointed node suite uses builds the
    port's ``Node``, with its engine on the host."""
    mgr = torch_parity.NodeManager(3, tmp_path, partitions=2)
    assert only_port_nodes == mgr.nodes and len(mgr.nodes) == 3
    for n in mgr.nodes:
        assert type(n) is port_node.Node
        assert n.raft.engine.state.term.device == torch.device("cpu")
        n.kv.close()


def _example(tmp_path, device: str, raft_port: int, broker_port: int) -> str:
    """The port's single-node example TOML with its ports, directories and
    device rewritten; returns its path."""
    with open(os.path.join(EXAMPLES, "single-node", "node-1.toml")) as f:
        toml = f.read()
    for old, new in (('device = "cuda"', f'device = "{device}"'),
                     ("port = 6669", f"port = {raft_port}"),
                     ("port = 8844", f"port = {broker_port}"),
                     ("/tmp/josefine-tpu-torch/single", str(tmp_path / "n1"))):
        assert old in toml, old
        toml = toml.replace(old, new)
    path = tmp_path / "node-1.toml"
    path.write_text(toml)
    return str(path)


def test_cli_serves_kafka_and_exits_on_sigterm(tmp_path):
    """``python -m josefine_tpu_torch <toml>`` with ``device = "cpu"``
    answers ApiVersions over TCP and exits with code 0 on SIGTERM."""
    cfg = _example(tmp_path, "cpu", 26701, 28701)
    proc = subprocess.Popen([sys.executable, "-m", "josefine_tpu_torch", cfg], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    async def api_versions():
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                c = await kafka_client.connect("127.0.0.1", 28701)
                break
            except OSError:
                assert time.monotonic() < deadline, "the broker port never came up"
                await asyncio.sleep(0.2)
        try:
            return await asyncio.wait_for(c.send(ApiKey.API_VERSIONS, 2, {
                "client_software_name": "t", "client_software_version": "1"}), 30)
        finally:
            await c.close()

    try:
        r = asyncio.run(api_versions())
        assert r["error_code"] == 0 and len(r["api_keys"]) >= 16
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "starting node from" in out and "Traceback" not in out, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.skipif(torch.cuda.is_available(), reason="shows the refusal on a host "
                    "without a card")
def test_config_naming_the_card_raises_without_one(tmp_path):
    """A node whose TOML keeps the default ``device = "cuda"`` raises on a
    host without a card; it does not carry on on the CPU."""
    cfg = load_config(_example(tmp_path, "cuda", 26702, 28702))
    assert cfg.engine.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_node.Node(cfg, in_memory=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(josefine_with_config(cfg, Shutdown()))


def test_node_with_a_device_mesh_raises(tmp_path):
    """``engine.mesh_shards = 2``: on the CPU the node shards its engine
    over two shards of the host, starts and serves Kafka; asked for the
    card with too few cards it raises the JAX node's ValueError, naming the
    count, before it builds the engine."""
    cfg = load_config(_example(tmp_path, "cpu", 26703, 28703))
    cfg.engine.mesh_shards = 2
    cfg.engine.partitions = 4
    node = port_node.Node(cfg, in_memory=True)
    engine = node.raft.engine
    assert (engine._shards, engine._shard_rows) == (2, 2)
    assert [str(p.device) for p in engine.member.parts] == ["cpu", "cpu"]

    async def serve():
        shutdown = Shutdown()
        task = asyncio.create_task(josefine_with_config(cfg, shutdown.clone()))
        c = None
        try:
            for _ in range(240):
                if task.done():
                    task.result()
                try:
                    c = await kafka_client.connect("127.0.0.1", 28703)
                    break
                except OSError:
                    await asyncio.sleep(0.25)
            assert c is not None, "broker port never came up"
            r = await asyncio.wait_for(c.send(ApiKey.API_VERSIONS, 2, {
                "client_software_name": "t", "client_software_version": "1"}), 30)
            assert r["error_code"] == 0
            await c.close()
        finally:
            shutdown.shutdown()
            await asyncio.wait_for(task, 60)

    asyncio.run(serve())
    if torch.cuda.device_count() < 2:
        cfg.engine.device = "cuda"
        with pytest.raises(ValueError, match=f"engine.mesh_shards=2 but only "
                                             f"{torch.cuda.device_count()} devices"):
            port_node.Node(cfg, in_memory=True)
