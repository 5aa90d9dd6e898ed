"""Drift guard for the host-only modules the PyTorch port copies.

These modules import no JAX, but the port may not import the JAX package
at all, so it carries its own copies. Each copy must stay the JAX module's
source with ``josefine_tpu`` rewritten to ``josefine_tpu_torch`` on its
import lines, and nothing else but the differences recorded below: a fix to
either side that is not made to the other fails here. The native sources
are copied byte for byte.
"""

import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
MODULES = [
    "utils/tracing.py", "utils/kv.py", "utils/metrics.py", "utils/profiling.py",
    "utils/flight.py", "utils/spans.py", "utils/health.py", "utils/shutdown.py",
    "utils/net.py",
    "raft/membership.py", "raft/chain.py", "raft/rpc.py", "raft/fsm.py",
    "raft/result.py", "raft/migration.py", "raft/lease.py", "raft/pacer.py",
    "raft/client.py", "raft/tcp.py",
    "kafka/__init__.py", "kafka/client.py", "kafka/codec.py",
    "broker/__init__.py", "broker/state.py", "broker/fsm.py", "broker/records.py",
    "broker/log.py", "broker/fetch_frame.py", "broker/replica.py",
    "broker/partition_fsm.py", "broker/groups.py", "broker/handlers.py",
    "broker/server.py",
    "node.py", "__main__.py",
    "utils/coverage.py",
    "chaos/__init__.py", "chaos/faults.py", "chaos/invariants.py", "chaos/nemesis.py",
    "chaos/harness.py", "chaos/soak.py", "chaos/wire.py", "chaos/wire_soak.py",
    "chaos/search.py",
    "workload/__init__.py", "workload/model.py", "workload/schedule.py",
    "workload/trace.py", "workload/genome.py", "workload/chaos_traffic.py",
    "workload/driver.py", "workload/wire.py",
]
NATIVE_SOURCES = ["native/src/kafka_codec.cpp", "native/src/seglog.cpp"]

_CODEC_AT_IMPORT = '''_codec = native.load("kafka_codec")

decode_request = _codec.decode_request
encode_response = _codec.encode_response
encode_request = _codec.encode_request
decode_response = _codec.decode_response
supported_apis = _codec.supported_apis
'''
_CODEC_AT_FIRST_CALL = '''# The native codec is built and loaded at its first call, not at import:
# importing the port builds nothing.
_codec = None


def _native(name: str):
    def call(*args):
        global _codec
        if _codec is None:
            _codec = native.load("kafka_codec")
        return getattr(_codec, name)(*args)
    call.__name__ = call.__qualname__ = name
    return call


decode_request = _native("decode_request")
encode_response = _native("encode_response")
encode_request = _native("encode_request")
decode_response = _native("decode_response")
supported_apis = _native("supported_apis")
'''
_MESH_BRANCH = '''        mesh = None
        if config.engine.mesh_shards:
            # Shard the consensus-group axis over local devices (pure data
            # parallelism — groups are independent; see RaftEngine mesh).
            import jax
            from jax.sharding import Mesh

            import numpy as _np

            devs = jax.devices()
            k = config.engine.mesh_shards
            if len(devs) < k:
                raise ValueError(
                    f"engine.mesh_shards={k} but only {len(devs)} devices")
            mesh = Mesh(_np.array(devs[:k]), ("p",))
'''
_PORT_MESH_BRANCH = '''        mesh = None
        if config.engine.mesh_shards:
            # Shard the consensus-group axis over local devices (pure data
            # parallelism — groups are independent; see RaftEngine mesh):
            # distinct cards, or shards of the host where the engine runs on
            # the CPU.
            import torch

            from josefine_tpu_torch.parallel.sharded import make_mesh

            k = config.engine.mesh_shards
            if config.engine.device == "cpu":
                devs = [torch.device("cpu")] * k
            else:
                devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if len(devs) < k:
                raise ValueError(
                    f"engine.mesh_shards={k} but only {len(devs)} devices")
            mesh = make_mesh(k, devices=devs)
'''
_BACKEND = '''            backend=config.engine.backend,
'''
_BACKEND_AND_DEVICE = '''            backend=config.engine.backend,
            # The engine's state lives on the configured device: the card
            # unless the config says "cpu" (no card: it raises).
            device=config.engine.device,
'''
# Deliberate differences between a copy and its original, by module: for
# each, the reason, the original's text and the copy's in its place.
DIFFERENCES: dict[str, list[tuple[str, str, str]]] = {
    "kafka/codec.py": [(
        "The JAX codec builds and loads its extension when the module is imported; "
        "the port's does so at the first call, because importing the port must build "
        "nothing (tests/test_torch_independence.py).",
        _CODEC_AT_IMPORT, _CODEC_AT_FIRST_CALL)],
    "node.py": [
        ("The JAX node builds a jax.sharding.Mesh over jax.devices() when "
         "engine.mesh_shards is set; the port builds its own Mesh "
         "(josefine_tpu_torch.parallel.sharded.make_mesh) over distinct cards, or over "
         "shards of the host where engine.device is \"cpu\", and raises the same "
         "ValueError when there are too few.",
         _MESH_BRANCH, _PORT_MESH_BRANCH),
        ("The port's JosefineRaft also takes the engine's device: the card by default, "
         "the host where the config says \"cpu\".",
         _BACKEND, _BACKEND_AND_DEVICE),
    ],
    "__main__.py": [
        ("The port's CLI is run as python -m josefine_tpu_torch.",
         '"""CLI: ``python -m josefine_tpu <config.toml>``.',
         '"""CLI: ``python -m josefine_tpu_torch <config.toml>``.'),
        ("The port's program name and description.",
         '''        prog="josefine-tpu",
        description="TPU-native distributed event stream (Kafka wire protocol, "
        "batched Chained-Raft consensus on device)",''',
         '''        prog="josefine-tpu-torch",
        description="Distributed event stream (Kafka wire protocol, batched "
        "Chained-Raft consensus on an NVIDIA card through PyTorch)",'''),
    ],
}
# The chaos and workload planes: the port's entry points take the engines'
# device (the card unless told otherwise) and build their step params on
# the host, because the port's ``step_params`` allocates on the card by
# default and a module-level call would need a card at import; every
# engine moves its params to its own device.
_HOST_PARAMS = ("Module-level step params are built on the host: importing the port "
                "allocates nothing on a device, and RaftEngine moves params to its own "
                "device.")
_SOAK_HOST_PARAMS = ("The soak's step params are built on the host; the engines move "
                     "them to their device.")
_CHAOS_DEVICE = ("The port's chaos harness takes the engines' device: the card by "
                 "default, the host where the caller says \"cpu\".")
_TRAFFIC_DEVICE = ("The port's traffic driver takes the engines' device (the card by "
                   "default) and builds its step params on the host.")
_TRAFFIC_PEER_PARAMS = """                       params=step_params(timeout_min=1 << 20,
                                          timeout_max=(1 << 20) + 8,
                                          hb_ticks=hb_ticks),
                       base_seed=seed + nid, backend=backend)"""
_NO_CHANGE_NUMBERS = "The port's copies name no change numbers from the reference's history."
DIFFERENCES.update({
    "chaos/wire.py": [
        (_NO_CHANGE_NUMBERS,
         "PR 1's :class:`~josefine_tpu.chaos.faults.FaultPlane` injects faults into",
         "The :class:`~josefine_tpu.chaos.faults.FaultPlane` injects faults into"),
    ],
    "chaos/harness.py": [
        (_NO_CHANGE_NUMBERS,
         "where the plane applies its fates, exactly like PR 6 kinds).",
         "where the plane applies its fates, exactly like payload-free kinds)."),
        (_HOST_PARAMS,
         "DEFAULT_PARAMS = step_params(timeout_min=3, timeout_max=8, hb_ticks=1)",
         'DEFAULT_PARAMS = step_params(timeout_min=3, timeout_max=8, hb_ticks=1,\n'
         '                             device="cpu")'),
        (_HOST_PARAMS,
         "LEASE_PARAMS = step_params(timeout_min=4, timeout_max=8, hb_ticks=1)",
         'LEASE_PARAMS = step_params(timeout_min=4, timeout_max=8, hb_ticks=1,\n'
         '                           device="cpu")'),
        (_CHAOS_DEVICE,
         "                 health: bool = True):\n        self.plane = plane or",
         '                 health: bool = True, device="cuda"):\n'
         "        # The engines' device: the card unless the caller says \"cpu\".\n"
         "        self.device = device\n        self.plane = plane or"),
        (_CHAOS_DEVICE,
         "            flight_lease=self.leases,\n        )",
         "            flight_lease=self.leases,\n            device=self.device,\n        )"),
        (_CHAOS_DEVICE,
         "    def __init__(self, seed: int, groups: int = 2):\n",
         '    def __init__(self, seed: int, groups: int = 2, device="cuda"):\n'
         "        self.device = device\n"),
        (_CHAOS_DEVICE,
         "            snapshot_threshold=5, max_nodes=self.MAX,\n",
         "            snapshot_threshold=5, max_nodes=self.MAX, device=self.device,\n"),
    ],
    "chaos/soak.py": [
        (_CHAOS_DEVICE,
         "                         health: bool = True) -> dict:",
         '                         health: bool = True, device="cuda") -> dict:'),
        (_SOAK_HOST_PARAMS,
         "                             hb_ticks=hb)",
         '                             hb_ticks=hb, device="cpu")'),
        (_SOAK_HOST_PARAMS,
         "            timeout_min=3, timeout_max=8, hb_ticks=hb_ticks)",
         '            timeout_min=3, timeout_max=8, hb_ticks=hb_ticks, device="cpu")'),
        (_CHAOS_DEVICE,
         "                           health=health)",
         "                           health=health, device=device)"),
    ],
    "chaos/wire_soak.py": [
        ("Without a card the default device raises before the soak binds sockets or "
         "makes its directory.",
         "    sched = resolve_wire_schedule(schedule, n_nodes)\n"
         "    plane = FaultPlane(seed, n_nodes, net=NetFaults.quiet())\n",
         "    resolve_device(device)  # no card: raise before any socket or directory\n"
         "    sched = resolve_wire_schedule(schedule, n_nodes)\n"
         "    plane = FaultPlane(seed, n_nodes, net=NetFaults.quiet())\n"),
        ("Without a card the default device raises before the soak binds sockets or "
         "makes its directory.",
         "from josefine_tpu_torch.chaos.wire import NodeShim, WirePlane\n",
         "from josefine_tpu_torch.chaos.wire import NodeShim, WirePlane\n"
         "from josefine_tpu_torch.models.types import resolve_device\n"),
        (_CHAOS_DEVICE,
         "                 broker_overrides: dict | None = None):",
         '                 broker_overrides: dict | None = None, device="cuda"):'),
        (_CHAOS_DEVICE,
         "                engine=EngineConfig(partitions=partitions),",
         "                engine=EngineConfig(partitions=partitions, device=device),"),
        (_CHAOS_DEVICE,
         "                              health: bool = True) -> dict:",
         '                              health: bool = True,\n'
         '                              device="cuda") -> dict:'),
        (_CHAOS_DEVICE,
         "                          tick_ms=tick_ms, request_spans=request_spans)",
         "                          tick_ms=tick_ms, request_spans=request_spans,\n"
         "                          device=device)"),
    ],
    "chaos/search.py": [
        (_CHAOS_DEVICE,
         "                 migration: bool = False, leases: bool = False):\n"
         "        self.seed = seed",
         "                 migration: bool = False, leases: bool = False,\n"
         '                 device="cuda"):\n'
         "        # Every candidate soak runs its engines on this device (not in\n"
         "        # soak_config: the card and the host give equal runs). Without\n"
         "        # a card the default raises here, not at the first soak.\n"
         "        self.device = str(resolve_device(device))\n"
         "        self.seed = seed"),
        (_CHAOS_DEVICE,
         "from josefine_tpu_torch.chaos.soak import run_soak\n",
         "from josefine_tpu_torch.chaos.soak import run_soak\n"
         "from josefine_tpu_torch.models.types import resolve_device\n"),
        (_CHAOS_DEVICE,
         "                artifact_path=os.devnull, **self.wire_opts)",
         "                artifact_path=os.devnull, device=self.device,\n"
         "                **self.wire_opts)"),
        (_CHAOS_DEVICE,
         "            leases=self.leases,\n            # Search runs",
         "            leases=self.leases, device=self.device,\n            # Search runs"),
    ],
    "workload/driver.py": [
        (_NO_CHANGE_NUMBERS,
         "measurement PR 12 records in BENCH_traffic.json. Replica leadership is",
         "measurement recorded in BENCH_traffic.json. Replica leadership is"),
        (_NO_CHANGE_NUMBERS,
         "        # Live migration (ISSUE 16): the metadata FSM's reassignment",
         "        # Live migration: the metadata FSM's reassignment"),
        (_NO_CHANGE_NUMBERS,
         "at the same receiver tick (the PR 6\n            # byte-identity barrier;",
         "at the same receiver tick (the fabric's\n            # byte-identity barrier;"),
        ("The port's engines take only the \"torch\" and \"python\" backends: the "
         "default is \"torch\", and \"jax\" is refused by the engine, as by the port's "
         "config.",
         'hb_ticks: int = 1, backend: str = "jax",',
         'hb_ticks: int = 1, backend: str = "torch",'),
        (_TRAFFIC_DEVICE,
         "                 health: bool = False):\n        self.spec = spec.validate()",
         '                 health: bool = False, device="cuda"):\n'
         "        self.spec = spec.validate()"),
        (_TRAFFIC_DEVICE,
         "                               hb_ticks=hb_ticks),\n"
         "            base_seed=seed, backend=backend, active_set=active_set,",
         '                               hb_ticks=hb_ticks, device="cpu"),\n'
         "            base_seed=seed, backend=backend, active_set=active_set,"),
        (_TRAFFIC_DEVICE,
         "            flight_lease=flight_lease)\n",
         "            flight_lease=flight_lease, device=device)\n"),
        (_TRAFFIC_DEVICE, _TRAFFIC_PEER_PARAMS,
         _TRAFFIC_PEER_PARAMS.replace("hb_ticks=hb_ticks),", 'hb_ticks=hb_ticks, device="cpu"),')
         .replace("backend=backend)", "backend=backend,\n                       device=device)")),
    ],
})
# ``josefine_tpu`` as a whole name on an import line: ``josefine_tpu.x``
# and ``from josefine_tpu import x``.
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)josefine_tpu(?=[.\s])", re.M)


@pytest.mark.parametrize("module", MODULES)
def test_copy_equals_original_with_imports_repointed(module):
    original = (REPO / "josefine_tpu" / module).read_text()
    copy = (REPO / "josefine_tpu_torch" / module).read_text()
    want = _IMPORT.sub(r"\1josefine_tpu_torch", original)
    for _, old, new in DIFFERENCES.get(module, ()):
        assert want.count(old) == 1, f"josefine_tpu/{module} no longer holds the recorded text"
        want = want.replace(old, new)
    assert copy == want, (
        f"josefine_tpu_torch/{module} has drifted from josefine_tpu/{module}")


@pytest.mark.parametrize("source", NATIVE_SOURCES)
def test_native_source_is_a_byte_copy(source):
    assert (REPO / "josefine_tpu_torch" / source).read_bytes() == \
        (REPO / "josefine_tpu" / source).read_bytes(), (
        f"josefine_tpu_torch/{source} has drifted from josefine_tpu/{source}")
