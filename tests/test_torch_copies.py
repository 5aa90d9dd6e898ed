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
_NO_MESH = '''        # No device mesh: config.validate() above raises for
        # engine.mesh_shards > 0, which the PyTorch engine does not take yet.
        mesh = None
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
        ("The JAX node builds a jax.sharding.Mesh when engine.mesh_shards is set; the "
         "port imports no JAX, and its EngineConfig.validate (called first) raises "
         "NotImplementedError for mesh_shards > 0 (ROADMAP item 10), so the branch goes.",
         _MESH_BRANCH, _NO_MESH),
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
