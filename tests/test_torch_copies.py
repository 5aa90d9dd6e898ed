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
# Deliberate differences between a copy and its original, by module: the
# reason, the original's text and the copy's in its place.
DIFFERENCES: dict[str, tuple[str, str, str]] = {
    "kafka/codec.py": (
        "The JAX codec builds and loads its extension when the module is imported; "
        "the port's does so at the first call, because importing the port must build "
        "nothing (tests/test_torch_independence.py).",
        _CODEC_AT_IMPORT, _CODEC_AT_FIRST_CALL),
}
# ``josefine_tpu`` as a whole name on an import line: ``josefine_tpu.x``
# and ``from josefine_tpu import x``.
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)josefine_tpu(?=[.\s])", re.M)


@pytest.mark.parametrize("module", MODULES)
def test_copy_equals_original_with_imports_repointed(module):
    original = (REPO / "josefine_tpu" / module).read_text()
    copy = (REPO / "josefine_tpu_torch" / module).read_text()
    want = _IMPORT.sub(r"\1josefine_tpu_torch", original)
    if module in DIFFERENCES:
        _, old, new = DIFFERENCES[module]
        assert want.count(old) == 1, f"josefine_tpu/{module} no longer holds the recorded text"
        want = want.replace(old, new)
    assert copy == want, (
        f"josefine_tpu_torch/{module} has drifted from josefine_tpu/{module}")


@pytest.mark.parametrize("source", NATIVE_SOURCES)
def test_native_source_is_a_byte_copy(source):
    assert (REPO / "josefine_tpu_torch" / source).read_bytes() == \
        (REPO / "josefine_tpu" / source).read_bytes(), (
        f"josefine_tpu_torch/{source} has drifted from josefine_tpu/{source}")
