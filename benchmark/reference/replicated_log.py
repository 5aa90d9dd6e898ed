"""Plain reference of a replicated log per consensus group.

Semantics held: every group's committed log is the same on every replica;
it holds each acknowledged proposal exactly once, in the order the client
proposed them, and nothing that was not proposed; each block's parent is
the block before it and its id's low 32 bits count the chain's length;
and each replica's state machine applied exactly its committed log's
payloads, in order. A proposal that was refused may still have committed
(Raft gives no answer either way), so it may appear once; one never
answered at all is a fault.

Payloads are the benchmark's own: ``PAYLOAD_HEAD`` (group, serial) and
bytes from the seed, so the group of an applied payload is read from it.
"""

from __future__ import annotations

import struct
from collections import defaultdict

PAYLOAD_HEAD = struct.Struct(">IQ")
CHECKS = ("unanswered", "missing", "duplicated", "altered", "out_of_order",
          "broken_links", "divergent", "misapplied")


def make_payload(group: int, serial: int, rest: bytes) -> bytes:
    return PAYLOAD_HEAD.pack(group, serial) + rest


def payload_group(data: bytes) -> int:
    return PAYLOAD_HEAD.unpack_from(data)[0] if len(data) >= PAYLOAD_HEAD.size else -1


def broken_links(chain: list[tuple[int, int, bytes]]) -> int:
    """Blocks whose parent is not the block before them (genesis, 0, for
    the first) or whose sequence is not their 1-based position."""
    bad, prev = 0, 0
    for k, (bid, parent, _) in enumerate(chain, 1):
        bad += parent != prev or (bid & 0xFFFFFFFF) != k
        prev = bid
    return bad


def compare(proposals: list[tuple[int, bytes, str]], replicas: list[dict]) -> dict[str, int]:
    """``proposals``: (group, payload, status) in the order they were made,
    status ``acked``, ``failed`` or ``open``. ``replicas``: per replica
    ``{"chains": {group: [(id, parent, data), ...]}, "applied": [data, ...]}``
    with the committed chain of every proposed-to group, oldest first, and
    every payload its state machine applied, in order. Returns a count per
    name of :data:`CHECKS`; a sound run reads 0 everywhere."""
    n = dict.fromkeys(CHECKS, 0)
    by_group: dict[int, list[tuple[bytes, str]]] = defaultdict(list)
    for g, p, s in proposals:
        by_group[g].append((p, s))
        n["unanswered"] += s == "open"
    for g, props in by_group.items():
        known = {p for p, _ in props}
        acked = [p for p, s in props if s == "acked"]
        chains = [r["chains"].get(g, []) for r in replicas]
        for chain in chains:
            n["broken_links"] += broken_links(chain)
            pos: dict[bytes, int] = {}
            for i, (_, _, d) in enumerate(b for b in chain if b[2]):
                if d not in known:
                    n["altered"] += 1
                elif d in pos:
                    n["duplicated"] += 1
                else:
                    pos[d] = i
            idx = [pos[p] for p in acked if p in pos]
            n["missing"] += len(acked) - len(idx)
            n["out_of_order"] += sum(b < a for a, b in zip(idx, idx[1:]))
        n["divergent"] += any(c != chains[0] for c in chains[1:])
    for r in replicas:
        applied: dict[int, list[bytes]] = defaultdict(list)
        for d in r["applied"]:
            applied[payload_group(d)].append(d)
        for g in set(applied) | set(by_group):
            logged = [d for _, _, d in r["chains"].get(g, []) if d]
            n["misapplied"] += applied.get(g, []) != logged
    return n
