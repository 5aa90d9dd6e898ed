"""PyTorch port, Kafka wire layer and native code.

The cases of ``tests/test_kafka_codec.py``, ``test_kafka_golden.py`` and
``test_kafka_fuzz.py`` run against the port's ``kafka`` package, whose codec
is the port's own build of its copy of ``native/src/kafka_codec.cpp``. Then
the port against the JAX package: every encode of the golden fixtures byte
for byte, every decode of them and of the fuzz inputs (garbage,
truncations, bit flips) equal in result or in the error raised, with each
successful decode re-encoded byte-equal; the segment log's ``crc32c`` on
random bytes, and a segment written through each package's extension
byte-equal on disk. Last, the port loads only its own extensions, built
into its build directory, and importing the codec builds nothing.
"""

from __future__ import annotations

import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from josefine_tpu import native as jax_native
from josefine_tpu.kafka import codec as jax_codec
from josefine_tpu_torch import native
from josefine_tpu_torch.kafka import codec
from josefine_tpu_torch.ops import _build

from torch_parity import repointed

sys.path.insert(0, str(Path(__file__).parent / "fixtures"))

import kafka_golden as G  # noqa: E402

_cases = [repointed(m) for m in ("test_kafka_codec", "test_kafka_golden", "test_kafka_fuzz")]
assert not set(_cases[0]) & set(_cases[1]) and not set(_cases[1]) & set(_cases[2])
for _c in _cases:
    globals().update(_c)

IDS = [f"api{f['api_key']}v{f['api_version']}" for f in G.FIXTURES]


def outcome(fn, *args):
    """A call's result, or the type and message of what it raised."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return "raised", type(e).__name__, str(e)


@pytest.mark.parametrize("fx", G.FIXTURES, ids=IDS)
def test_encodes_byte_equal_to_the_jax_codec(fx):
    req = (fx["api_key"], fx["api_version"], fx["correlation_id"], fx["client_id"],
           fx["request_body"])
    resp = (fx["api_key"], fx["api_version"], fx["correlation_id"], fx["response_body"])
    assert codec.encode_request(*req) == jax_codec.encode_request(*req)
    assert codec.encode_response(*resp) == jax_codec.encode_response(*resp)
    assert codec.decode_request(fx["request_frame"]) == \
        jax_codec.decode_request(fx["request_frame"])
    dec = (fx["api_key"], fx["api_version"], fx["response_frame"])
    assert codec.decode_response(*dec) == jax_codec.decode_response(*dec)
    assert codec.supported_apis() == jax_codec.supported_apis()


def _fuzz_requests(fx):
    """The request frames ``test_truncations_and_bitflips_never_crash``
    feeds the decoder for one fixture (same seed, same order)."""
    rng = random.Random(fx["api_key"] * 31 + fx["api_version"])
    req = fx["request_frame"]
    yield from (req[:cut] for cut in range(len(req)))
    for _ in range(200):
        b = bytearray(req)
        b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        yield bytes(b)


def _same_decode_and_reencode(raw: bytes) -> bool:
    """Both codecs decode ``raw`` alike; where that succeeds, both encode
    the decoded request to the same bytes. Returns whether it decoded."""
    got, want = outcome(codec.decode_request, raw), outcome(jax_codec.decode_request, raw)
    assert got == want, raw.hex()
    if got[0] != "ok":
        return False
    d = got[1]
    args = (d["api_key"], d["api_version"], d["correlation_id"], d["client_id"], d["body"])
    assert outcome(codec.encode_request, *args) == outcome(jax_codec.encode_request, *args)
    return True


@pytest.mark.parametrize("fx", G.FIXTURES, ids=IDS)
def test_fuzzed_frames_decode_and_reencode_as_the_jax_codec(fx):
    decoded = sum(_same_decode_and_reencode(raw) for raw in _fuzz_requests(fx))
    resp = fx["response_frame"]
    for cut in range(len(resp)):
        args = (fx["api_key"], fx["api_version"], resp[:cut])
        assert outcome(codec.decode_response, *args) == \
            outcome(jax_codec.decode_response, *args)
    assert decoded > 0, "no fuzzed frame decoded: nothing re-encoded"


def test_garbage_decodes_as_the_jax_codec():
    rng = random.Random(0)
    for _ in range(1500):
        raw = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 64)))
        _same_decode_and_reencode(raw)


def test_crc32c_and_crc32_equal_the_jax_extension():
    port, ref = native.load("seglog"), jax_native.load("seglog")
    rng = np.random.default_rng(6)
    for n in (0, 1, 7, 64, 4095, 1 << 16):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert port.crc32c(data) == ref.crc32c(data), n
        assert port.crc32(data) == ref.crc32(data), n


def test_segments_written_by_each_extension_are_byte_equal(tmp_path):
    """The same appends (random blobs from a seed, small segments so the
    log rolls) through each package's ``seglog``: every file on disk equal
    byte for byte, and every read equal."""
    rng = np.random.default_rng(7)
    blobs = [(rng.integers(0, 256, int(rng.integers(1, 3000)), dtype=np.uint8).tobytes(),
              int(rng.integers(1, 5))) for _ in range(200)]
    logs = {}
    for name, mod in (("port", native.load("seglog")), ("jax", jax_native.load("seglog"))):
        log = mod.open(str(tmp_path / name), max_segment_bytes=64 << 10,
                       index_bytes=16 << 10)
        offsets = [log.append(b, count=c) for b, c in blobs]
        reads = [log.read(o) for o in range(0, log.next_offset(), 3)]
        tail = log.read_from(offsets[100], 50_000)
        log.flush()
        logs[name] = (offsets, reads, tail, log.segment_count())
        log.close()
    assert logs["port"] == logs["jax"]
    assert logs["port"][3] > 1, "the log never rolled a segment"
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


@pytest.mark.parametrize("name", ["kafka_codec", "seglog"])
def test_the_port_loads_only_its_own_extensions(name):
    """Both packages' extensions export the same ``PyInit__<name>``: each
    package must get its own module object, from its own file, and the
    port's is built from its own copy of the source into its build
    directory."""
    mod, ref = native.load(name), jax_native.load(name)
    assert mod is not ref
    assert mod.__spec__.name == f"josefine_tpu_torch.native._{name}"
    assert sys.modules[f"josefine_tpu_torch.native._{name}"] is mod
    assert sys.modules[f"josefine_tpu.native._{name}"] is ref
    assert os.path.dirname(mod.__file__) == _build.BUILD_DIR
    assert mod.__file__ == native.so_path(name) != ref.__file__
    assert native.ensure_built(name) == mod.__file__
    src = Path(native.SRC) / f"{name}.cpp"
    assert src.parent.parent == Path(native.__file__).parent
    if name == "kafka_codec":
        assert codec.decode_request.__name__ == "decode_request"
        assert codec._codec is mod


def test_importing_the_codec_loads_no_extension():
    """The codec loads its extension at the first call, not at import."""
    probe = ("import sys, josefine_tpu_torch.kafka, josefine_tpu_torch.kafka.client; "
             "print(sorted(m for m in sys.modules if '.native._' in m))")
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parent.parent, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
