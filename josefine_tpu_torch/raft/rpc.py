"""Wire message types for the cluster transport.

Parity: reference ``src/raft/rpc.rs`` (``Message{from,to,command}`` with
logical ``Address``es) — here flattened to explicit (group, src, dst) node
indices because one process hosts one node of *many* consensus groups (the
(partitions x nodes) tensor), not one group.

Consensus messages (VOTE_REQ/VOTE_RESP/APPEND/APPEND_RESP) mirror the device
tensor fields exactly; AE additionally carries the variable-length payload
span (the host-side half of the north-star split). CLIENT_REQ/CLIENT_RESP
implement follower->leader proposal proxying (reference
``src/raft/follower.rs:258-282``); they never touch the device.
"""

from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field

import numpy as np

from josefine_tpu_torch.raft.chain import Block

# Device message kinds: single source of truth is the device model.
from josefine_tpu_torch.models.types import (  # noqa: E402
    MSG_NONE,
    MSG_VOTE_REQ,
    MSG_VOTE_RESP,
    MSG_APPEND,
    MSG_APPEND_RESP,
    MSG_PREVOTE_REQ,
    MSG_PREVOTE_RESP,
)

# Host-only kinds (never enter the device inbox).
MSG_CLIENT_REQ = 10
MSG_CLIENT_RESP = 11
# InstallSnapshot chunk: x = snapshot block id, y = chunk byte offset,
# z = total export length, payload = this chunk's bytes, aux (final chunk
# only, group 0) = serialized member table. Large state dumps ship as a
# sequence of bounded chunks — never one frame-cap-breaking message — each
# acked by the receiver (MSG_SNAPSHOT_ACK) to advance the sender's pointer.
# Handled entirely host-side; the follower's device row is re-pointed at
# the snapshot id after the final chunk installs (the reference's
# never-constructed Progress<Snapshot> path, src/raft/progress.rs:182-203,
# made real).
MSG_SNAPSHOT = 12
# Columnar consensus batch: ALL of one node's consensus traffic to one peer
# for one tick in a single binary frame (see MsgBatch).
MSG_BATCH = 13
# Snapshot transfer ack: x = snapshot block id, y = bytes staged so far,
# ok = 1 once the snapshot installed (sender drops its transfer pointer).
MSG_SNAPSHOT_ACK = 14
# Transport keepalive: sent once per tick to any peer that would otherwise
# receive nothing this tick. Feeds the receiver's per-slot liveness vector
# (peer_fresh), which stands in for per-group heartbeats so a leader of
# 100k groups can stagger its AE broadcasts (hb_ticks >> 1) without every
# follower group's election timer firing in between. src is the sender's
# slot; no other fields are meaningful.
MSG_PING = 15


@dataclass
class WireMsg:
    kind: int
    group: int = 0
    src: int = 0          # sender node index
    dst: int = 0          # destination node index
    term: int = 0
    x: int = 0            # packed block id (see chain.pack_id)
    y: int = 0
    z: int = 0
    ok: int = 0
    blocks: list[Block] = field(default_factory=list)  # AE payload span (x, y]
    req_id: str = ""      # CLIENT_* correlation
    inc: int = 0          # data-group row incarnation (release/reuse guard:
                          # a frame from a recycled row's previous life must
                          # never be applied to its successor)
    payload: bytes = b""  # CLIENT_* / SNAPSHOT body
    aux: bytes = b""      # SNAPSHOT: serialized member table (conf blocks
                          # below the truncation floor are gone, so cluster
                          # shape must ride the snapshot)

    def encode(self) -> bytes:
        d = {
            "k": self.kind, "g": self.group, "s": self.src, "d": self.dst,
            "t": self.term, "x": self.x, "y": self.y, "z": self.z, "o": self.ok,
        }
        if self.blocks:
            d["b"] = [
                [b.id, b.parent, base64.b64encode(b.data).decode()] for b in self.blocks
            ]
        if self.req_id:
            d["r"] = self.req_id
        if self.inc:
            d["i"] = self.inc
        if self.payload:
            d["p"] = base64.b64encode(self.payload).decode()
        if self.aux:
            d["a"] = base64.b64encode(self.aux).decode()
        return json.dumps(d, separators=(",", ":")).encode()

    @classmethod
    def decode(cls, raw: bytes) -> "WireMsg":
        d = json.loads(raw)
        return cls(
            kind=d["k"], group=d.get("g", 0), src=d.get("s", 0), dst=d.get("d", 0),
            term=d.get("t", 0), x=d.get("x", 0), y=d.get("y", 0), z=d.get("z", 0),
            ok=d.get("o", 0),
            blocks=[
                Block(id=i, parent=p, data=base64.b64decode(data))
                for i, p, data in d.get("b", [])
            ],
            req_id=d.get("r", ""),
            inc=d.get("i", 0),
            payload=base64.b64decode(d["p"]) if "p" in d else b"",
            aux=base64.b64decode(d["a"]) if "a" in d else b"",
        )

    def span_is_valid(self) -> bool:
        """An AE's payload must be a parent-linked chain from x to y; a
        malformed span is dropped before it can reach the device (keeps the
        device-accepts => host-can-extend invariant)."""
        if self.kind != MSG_APPEND:
            return True
        return _span_ok(self.x, self.y, self.blocks)


def _span_ok(x: int, y: int, blocks: list[Block]) -> bool:
    if x == y:
        return not blocks  # pure heartbeat
    prev = x
    for b in blocks:
        if b.parent != prev:
            return False
        prev = b.id
    return prev == y


_BATCH_MAGIC = 0x01  # JSON WireMsg frames start with '{' (0x7b); batches with 0x01
_BATCH_HDR = struct.Struct(">BBIIII")  # magic, ver, src, dst, count, nspans
_SPAN_HDR = struct.Struct(">II")       # group, nblocks
_BLOCK_HDR = struct.Struct(">QQI")     # id, parent, len


class MsgBatch:
    """Columnar consensus batch: every consensus message one node sends one
    peer in one tick, as seven parallel arrays plus the AE payload spans.

    This is the device outbox's natural wire form — the (9, P, N) tensor's
    dst-column, shipped as one binary frame instead of thousands of
    per-message JSON objects (the reference sends one serde-JSON frame per
    message, ``src/raft/tcp.rs:143-156``; at 10k+ groups per host that is
    the difference between one syscall and 20k object constructions per
    tick per peer). ``group`` is sorted ascending (np.nonzero order).
    """

    __slots__ = ("src", "dst", "group", "kind_col", "term", "x", "y", "z",
                 "ok", "inc", "blocks")
    kind = MSG_BATCH  # class-level: transport/server dispatch parity w/ WireMsg

    def __init__(self, src, dst, group, kind_col, term, x, y, z, ok,
                 blocks=None, inc=None):
        self.src = src
        self.dst = dst
        self.group = group        # np.intp[count], ascending
        self.kind_col = kind_col  # np.int32[count]
        self.term = term          # np.int64[count]
        self.x = x                # np.int64[count] packed block ids
        self.y = y
        self.z = z
        self.ok = ok              # np.int32[count]
        # Per-entry data-group row incarnation (release/reuse guard).
        self.inc = inc if inc is not None else np.zeros(len(group), np.int64)
        self.blocks = blocks if blocks is not None else {}  # group -> [Block]

    def __len__(self) -> int:
        return len(self.group)

    def encode(self) -> bytes:
        n = len(self.group)
        parts = [
            _BATCH_HDR.pack(_BATCH_MAGIC, 2, self.src, self.dst, n,
                            len(self.blocks)),
            np.ascontiguousarray(self.group, dtype=">u4").tobytes(),
            np.ascontiguousarray(self.kind_col, dtype=">u1").tobytes(),
            np.ascontiguousarray(self.term, dtype=">u4").tobytes(),
            np.ascontiguousarray(self.x, dtype=">u8").tobytes(),
            np.ascontiguousarray(self.y, dtype=">u8").tobytes(),
            np.ascontiguousarray(self.z, dtype=">u8").tobytes(),
            np.ascontiguousarray(self.ok, dtype=">u1").tobytes(),
            np.ascontiguousarray(self.inc, dtype=">u4").tobytes(),
        ]
        for g, blks in self.blocks.items():
            parts.append(_SPAN_HDR.pack(g, len(blks)))
            for b in blks:
                parts.append(_BLOCK_HDR.pack(b.id, b.parent, len(b.data)))
                parts.append(b.data)
        return b"".join(parts)

    @classmethod
    def decode(cls, raw: bytes) -> "MsgBatch":
        magic, ver, src, dst, n, nspans = _BATCH_HDR.unpack_from(raw, 0)
        if magic != _BATCH_MAGIC or ver != 2:
            # v1 frames (no incarnation column) would zero-fill inc and the
            # intake guard would silently drop every entry for claimed rows
            # — reject loudly instead of stalling the data plane.
            raise ValueError(f"bad batch frame (magic={magic} ver={ver})")
        o = _BATCH_HDR.size

        def col(dt, width, out_dt):
            nonlocal o
            a = np.frombuffer(raw, dtype=dt, count=n, offset=o).astype(out_dt)
            o += n * width
            return a

        group = col(">u4", 4, np.intp)
        kind_col = col(">u1", 1, np.int32)
        term = col(">u4", 4, np.int64)
        x = col(">u8", 8, np.int64)
        y = col(">u8", 8, np.int64)
        z = col(">u8", 8, np.int64)
        ok = col(">u1", 1, np.int32)
        inc = col(">u4", 4, np.int64)
        blocks: dict[int, list[Block]] = {}
        for _ in range(nspans):
            g, nb = _SPAN_HDR.unpack_from(raw, o)
            o += _SPAN_HDR.size
            lst = []
            for _ in range(nb):
                bid, parent, ln = _BLOCK_HDR.unpack_from(raw, o)
                o += _BLOCK_HDR.size
                if o + ln > len(raw):
                    # A short slice would yield a block whose ids still pass
                    # span validation but whose payload is silently cut —
                    # replica divergence. Fail loudly like the JSON path.
                    raise ValueError(
                        f"truncated block payload in batch frame "
                        f"(need {ln} bytes at {o}, have {len(raw) - o})")
                lst.append(Block(id=bid, parent=parent, data=raw[o:o + ln]))
                o += ln
            blocks[g] = lst
        if o != len(raw):
            raise ValueError(
                f"batch frame has {len(raw) - o} trailing bytes")
        return cls(src, dst, group, kind_col, term, x, y, z, ok, blocks,
                   inc=inc)

    def take(self, mask: np.ndarray) -> "MsgBatch":
        """Column-sliced copy keeping entries where ``mask`` is True (and
        their payload spans)."""
        blocks = self.blocks
        if blocks:
            kept = set(self.group[mask].tolist())
            blocks = {g: b for g, b in blocks.items() if g in kept}
        return MsgBatch(self.src, self.dst, self.group[mask],
                        self.kind_col[mask], self.term[mask], self.x[mask],
                        self.y[mask], self.z[mask], self.ok[mask], blocks,
                        inc=self.inc[mask])

    def messages(self):
        """Materialize per-entry WireMsgs (debug/tests; the hot path never
        does this)."""
        for i in range(len(self.group)):
            g = int(self.group[i])
            yield WireMsg(
                kind=int(self.kind_col[i]), group=g, src=self.src,
                dst=self.dst, term=int(self.term[i]), x=int(self.x[i]),
                y=int(self.y[i]), z=int(self.z[i]), ok=int(self.ok[i]),
                blocks=list(self.blocks.get(g, [])),
                inc=int(self.inc[i]),
            )


def decode_frame(raw: bytes):
    """Transport-level frame dispatch: binary consensus batch or JSON
    WireMsg."""
    if raw[:1] == bytes([_BATCH_MAGIC]):
        return MsgBatch.decode(raw)
    return WireMsg.decode(raw)
