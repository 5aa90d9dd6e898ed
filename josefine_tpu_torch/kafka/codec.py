"""Kafka wire codec: Python face of the native schema-driven codec.

Parity: reference ``src/kafka/codec.rs`` — server-side request decode /
response encode (:31-149), client-side request encode / response decode
(:151-276), 4-byte length framing with an i32 max frame (:22-29). The
codec itself is C++ (``native/src/kafka_codec.cpp``); this module adds the
enums, framing helpers and asyncio stream IO.

Upgrade over the reference (SURVEY.md quirk 8): LeaderAndIsr, Produce and
Fetch are decodable on the server side, so the data plane is reachable over
the wire.
"""

from __future__ import annotations

import asyncio
import enum
import struct

from josefine_tpu_torch import native

# The native codec is built and loaded at its first call, not at import:
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

MAX_FRAME = (1 << 31) - 1  # reference codec.rs:22-29


class ApiKey(enum.IntEnum):
    PRODUCE = 0
    FETCH = 1
    LIST_OFFSETS = 2
    METADATA = 3
    LEADER_AND_ISR = 4
    OFFSET_COMMIT = 8
    OFFSET_FETCH = 9
    FIND_COORDINATOR = 10
    JOIN_GROUP = 11
    HEARTBEAT = 12
    LEAVE_GROUP = 13
    SYNC_GROUP = 14
    DESCRIBE_GROUPS = 15
    LIST_GROUPS = 16
    API_VERSIONS = 18
    CREATE_TOPICS = 19
    DELETE_TOPICS = 20
    INIT_PRODUCER_ID = 22


class ErrorCode(enum.IntEnum):
    """The subset of Kafka protocol error codes the broker emits."""

    NONE = 0
    OFFSET_OUT_OF_RANGE = 1
    UNKNOWN_TOPIC_OR_PARTITION = 3
    LEADER_NOT_AVAILABLE = 5
    NOT_LEADER_OR_FOLLOWER = 6
    REQUEST_TIMED_OUT = 7
    CORRUPT_MESSAGE = 2
    INVALID_TOPIC = 17
    COORDINATOR_NOT_AVAILABLE = 15
    NOT_COORDINATOR = 16
    ILLEGAL_GENERATION = 22
    INCONSISTENT_GROUP_PROTOCOL = 23
    INVALID_GROUP_ID = 24
    UNKNOWN_MEMBER_ID = 25
    INVALID_SESSION_TIMEOUT = 26
    REBALANCE_IN_PROGRESS = 27
    UNSUPPORTED_VERSION = 35
    TOPIC_ALREADY_EXISTS = 36
    INVALID_PARTITIONS = 37
    INVALID_REPLICATION_FACTOR = 38
    INVALID_REQUEST = 42
    OUT_OF_ORDER_SEQUENCE_NUMBER = 45
    DUPLICATE_SEQUENCE_NUMBER = 46
    INVALID_PRODUCER_EPOCH = 47
    INVALID_RECORD = 87
    # Produce admission backpressure: the partition's consensus-group
    # proposal queue is over the broker's inflight cap. Retryable (Kafka
    # semantics: the client backs off and resends), and distinct from
    # NOT_LEADER so clients do not re-route off a healthy leader.
    THROTTLING_QUOTA_EXCEEDED = 89
    UNKNOWN_SERVER_ERROR = -1


def frame(payload: bytes) -> bytes:
    """Length-prefix a codec payload for the wire."""
    if len(payload) > MAX_FRAME:
        raise ValueError(f"frame exceeds i32 max: {len(payload)}")
    return struct.pack(">i", len(payload)) + payload


async def read_frame(reader: asyncio.StreamReader,
                     max_frame: int | None = None,
                     body_timeout: float | None = None) -> bytes | None:
    """Read one length-prefixed frame.

    Returns None only on a clean EOF (connection closed exactly on a frame
    boundary). A connection dropped mid-frame raises ConnectionError so
    callers can tell truncation from an orderly close.

    ``max_frame`` caps the acceptable frame size below the protocol's i32
    max (the broker passes its configured bound, so an absurd length
    prefix is rejected with ValueError — a clean close — instead of an
    unbounded read). ``body_timeout`` bounds the wait for the frame BODY
    once the header has arrived (a torn frame whose tail never comes must
    not hold the connection's buffers forever); the header wait stays
    unbounded — an idle connection is healthy.
    """
    try:
        hdr = await reader.readexactly(4)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise ConnectionError("connection dropped mid frame header") from None
    except ConnectionResetError:
        return None
    (size,) = struct.unpack(">i", hdr)
    if size < 0 or size > (MAX_FRAME if max_frame is None else max_frame):
        raise ValueError(f"invalid frame length {size}")
    try:
        body = reader.readexactly(size)
        if body_timeout is not None:
            try:
                return await asyncio.wait_for(body, body_timeout)
            except asyncio.TimeoutError:
                raise ConnectionError(
                    f"frame body ({size} bytes) not delivered within "
                    f"{body_timeout}s") from None
        return await body
    except asyncio.IncompleteReadError:
        raise ConnectionError("connection dropped mid frame body") from None
    # A mid-body ConnectionResetError propagates as itself (it is already
    # a ConnectionError, so every existing caller's handling holds) — the
    # broker's reset telemetry needs to tell an RST from a plain drop.
