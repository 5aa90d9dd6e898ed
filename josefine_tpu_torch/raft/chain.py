"""Host-side chain storage: the block DAG with payloads.

Parity: reference ``src/raft/chain.rs`` — genesis init (:139-153), leader
``append`` with monotone-id assertion (:160-175), follower ``extend`` with
parent-must-exist (:178-192), persisted ``commit`` pointer (:195-205),
``range`` iteration (:208-228), dead-branch ``compact`` (:239-253).

Deltas (deliberate, SURVEY.md quirks 2/3):
* Block ids are ``(mint_term << 32) | chain_length`` — two leaders can never
  mint the same id for different blocks (the reference's commit-seeded
  ``IdGenerator`` can). The device kernel mints ids; this store materializes
  them with payloads.
* ``commit()`` returns the newly committed half-open range ``(old, new]`` so
  every node applies each block exactly once (the reference's follower path
  has an off-by-one — SURVEY.md quirk 7b).
* Unknown blocks raise ``ChainError`` instead of panicking the event loop.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from josefine_tpu_torch.utils.kv import KV
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("raft.chain")

GENESIS = 0  # (term 0, seq 0)

_COMMIT_KEY = b"meta:commit"
_HEAD_KEY = b"meta:head"
_FLOOR_KEY = b"meta:floor"
_BLOCK_PREFIX = b"b:"


def pack_id(term: int, seq: int) -> int:
    return (term << 32) | (seq & 0xFFFFFFFF)


def id_term(bid: int) -> int:
    return bid >> 32


def id_seq(bid: int) -> int:
    return bid & 0xFFFFFFFF


class ChainError(Exception):
    pass


@dataclass(frozen=True)
class Block:
    """A chain block. ``parent`` is an explicit pointer (the DAG edge);
    ``data`` is the opaque payload the FSM will apply (empty = no-op)."""

    id: int
    parent: int
    data: bytes = b""

    @property
    def term(self) -> int:
        return id_term(self.id)

    @property
    def seq(self) -> int:
        return id_seq(self.id)


def _block_key(bid: int) -> bytes:
    return _BLOCK_PREFIX + struct.pack(">Q", bid)


def _encode_block(b: Block) -> bytes:
    return struct.pack(">Q", b.parent) + b.data


def _decode_block(bid: int, raw: bytes) -> Block:
    (parent,) = struct.unpack_from(">Q", raw)
    return Block(id=bid, parent=parent, data=raw[8:])


class Chain:
    """One group's block DAG on a KV store.

    All mutation goes through append/extend/commit; head and commit pointers
    are durably persisted so a restart resumes exactly where the chain left
    off (reference restart path ``src/raft/chain.rs:117-137``).
    """

    def __init__(self, kv: KV, prefix: bytes = b""):
        self._kv = kv
        self._pfx = prefix
        raw_head = kv.get(prefix + _HEAD_KEY)
        raw_commit = kv.get(prefix + _COMMIT_KEY)
        if raw_head is None:
            # Genesis init (reference chain.rs:139-153).
            genesis = Block(id=GENESIS, parent=GENESIS)
            kv.put(prefix + _block_key(GENESIS), _encode_block(genesis))
            kv.put(prefix + _HEAD_KEY, struct.pack(">Q", GENESIS))
            kv.put(prefix + _COMMIT_KEY, struct.pack(">Q", GENESIS))
            self.head = GENESIS
            self.committed = GENESIS
        else:
            (self.head,) = struct.unpack(">Q", raw_head)
            (self.committed,) = struct.unpack(">Q", raw_commit)
        raw_floor = kv.get(prefix + _FLOOR_KEY)
        # Snapshot floor: blocks at or below this id (except the floor block
        # itself, kept as the branch anchor) have been truncated away. The
        # reference only has config knobs for this (vestigial snapshotting,
        # src/raft/config.rs:38-40, Progress<Snapshot> never constructed —
        # SURVEY.md aux notes); here it is real.
        self.floor = GENESIS if raw_floor is None else struct.unpack(">Q", raw_floor)[0]

    # ------------------------------------------------------------- reads

    def get(self, bid: int) -> Block | None:
        raw = self._kv.get(self._pfx + _block_key(bid))
        return None if raw is None else _decode_block(bid, raw)

    def has(self, bid: int) -> bool:
        return self._kv.get(self._pfx + _block_key(bid)) is not None

    def range(self, from_id: int, to_id: int) -> list[Block]:
        """Blocks on the branch ending at ``to_id``, exclusive of ``from_id``,
        oldest first (reference chain.rs:208-228 but branch-walking: the id
        keyspace may contain dead branches, so we follow parent pointers).
        Delegates to :meth:`range_many` so the walk and its error semantics
        live in exactly one place."""
        return self.range_many([(from_id, to_id)])[0]

    def range_many(self, spans: list[tuple[int, int]]) -> list[list[Block]]:
        """Bulk :meth:`range`: materialize several ``(from_id, to_id]`` spans
        in one call, reading each distinct block from the KV exactly once.

        The hot caller is the outbox decoder attaching AE payload spans: a
        leader replicating to k followers requests k spans that share the
        top of the branch (same head, different per-follower bottoms), so a
        per-span ``range()`` walk re-reads the shared suffix k times. Here a
        block cache shared across the spans makes the whole call O(distinct
        blocks) KV reads. Per-span errors carry ``range``'s exact semantics
        (below-floor, missing block, not-an-ancestor all raise ChainError).
        """
        cache: dict[int, Block] = {}
        out: list[list[Block]] = []
        for from_id, to_id in spans:
            blks: list[Block] = []
            cur = to_id
            while cur != from_id:
                if cur < self.floor:
                    raise ChainError(
                        f"range: {cur:#x} below snapshot floor {self.floor:#x}"
                    )
                b = cache.get(cur)
                if b is None:
                    b = self.get(cur)
                    if b is None:
                        raise ChainError(f"range: missing block {cur:#x}")
                    cache[cur] = b
                blks.append(b)
                if cur == GENESIS or cur == self.floor:
                    raise ChainError(
                        f"range: {from_id:#x} not an ancestor of {to_id:#x}")
                cur = b.parent
            blks.reverse()
            out.append(blks)
        return out

    # ------------------------------------------------------------ writes

    def append(self, term: int, data: bytes) -> Block:
        """Leader mint: new block extending head at ``term``.

        Monotone-id guarantee holds by construction (id embeds term and
        chain length; reference asserts it at chain.rs:160-175).
        """
        new_id = pack_id(term, id_seq(self.head) + 1)
        if new_id <= self.head:
            raise ChainError(
                f"append would not advance head: {new_id:#x} <= {self.head:#x}"
            )
        blk = Block(id=new_id, parent=self.head, data=data)
        self._kv.put(self._pfx + _block_key(new_id), _encode_block(blk))
        self._set_head(new_id)
        return blk

    def extend(self, block: Block) -> None:
        """Follower adopt: parent must exist (reference chain.rs:178-192);
        head moves to the block (fork choice = id order, which is term-major
        — a new leader's branch always wins)."""
        if not self.has(block.parent):
            raise ChainError(f"extend: parent {block.parent:#x} of {block.id:#x} unknown")
        self._kv.put(self._pfx + _block_key(block.id), _encode_block(block))
        # Fork choice is pure id order: ids are term-major, so a new leader's
        # branch always outranks a dead one, and an equal id IS the same
        # block (one leader per term). Late-arriving dead-branch blocks never
        # regress head.
        if block.id > self.head:
            self._set_head(block.id)

    def extend_many(self, blocks: list[Block]) -> None:
        """Batched :meth:`extend`: adopt an oldest-first parent-linked run
        of blocks with ONE KV transaction for the block records plus the
        head pointer, instead of 2 puts per block. Validation is identical
        to per-block extend (the first block's parent must already exist;
        each subsequent block must chain onto its predecessor), and blocks
        are ordered before the head pointer in the batch so a torn batch on
        a non-transactional KV can never persist a head the blocks don't
        back."""
        if not blocks:
            return
        if not self.has(blocks[0].parent):
            raise ChainError(
                f"extend: parent {blocks[0].parent:#x} of {blocks[0].id:#x} unknown")
        prev = blocks[0].parent
        for b in blocks:
            if b.parent != prev:
                raise ChainError(
                    f"extend_many: {b.id:#x} does not chain onto {prev:#x}")
            prev = b.id
        puts = [(self._pfx + _block_key(b.id), _encode_block(b))
                for b in blocks]
        top = blocks[-1].id
        if top > self.head:
            puts.append((self._pfx + _HEAD_KEY, struct.pack(">Q", top)))
            self._kv.put_many(puts)
            self.head = top
        else:
            self._kv.put_many(puts)

    def commit(self, bid: int) -> list[Block]:
        """Advance the commit pointer; returns newly committed blocks
        ``(old_commit, new_commit]`` oldest-first for FSM application.

        Unknown block -> ChainError (the reference panics, chain.rs:201).
        """
        if bid == self.committed:
            return []
        if not self.has(bid):
            raise ChainError(f"commit: unknown block {bid:#x}")
        if bid < self.committed:
            raise ChainError(f"commit: would regress {self.committed:#x} -> {bid:#x}")
        blocks = self.range(self.committed, bid)
        self.committed = bid
        self._kv.put(self._pfx + _COMMIT_KEY, struct.pack(">Q", bid))
        return blocks

    def compact(self) -> int:
        """GC blocks not on the live branch (dead branches from deposed
        leaders — the Chained-Raft model, reference chain.rs:239-253 and
        module doc mod.rs:8-23). Returns number of blocks removed."""
        live: set[int] = set()
        cur = self.head
        while True:
            live.add(cur)
            if cur == GENESIS or cur == self.floor:
                break
            b = self.get(cur)
            if b is None:
                break
            cur = b.parent
        dead = []
        for k, _ in list(self._kv.scan_prefix(self._pfx + _BLOCK_PREFIX)):
            (bid,) = struct.unpack(">Q", k[len(self._pfx) + len(_BLOCK_PREFIX):])
            if bid not in live:
                dead.append(k)
        for k in dead:
            self._kv.delete(k)
        if dead:
            log.debug("compacted %d dead blocks", len(dead))
        return len(dead)

    def truncate(self, upto: int) -> int:
        """Log compaction after a snapshot at committed block ``upto``:
        delete every block with id below ``upto`` and strip ``upto``'s
        payload (it is captured by the snapshot), keeping it as the branch
        anchor so children's parent-exists checks still pass. Returns the
        number of blocks deleted.

        The reference never implements this (snapshot knobs are vestigial);
        here the id keyspace makes it a prefix scan: ids are (term << 32) |
        seq and anything below the committed id is either an ancestor or a
        dead branch.
        """
        if upto <= self.floor:
            return 0
        if upto > self.committed:
            raise ChainError(
                f"truncate: {upto:#x} beyond commit {self.committed:#x}"
            )
        anchor = self.get(upto)
        if anchor is None:
            raise ChainError(f"truncate: unknown block {upto:#x}")
        removed = 0
        for k, _ in list(self._kv.scan_prefix(self._pfx + _BLOCK_PREFIX)):
            (bid,) = struct.unpack(">Q", k[len(self._pfx) + len(_BLOCK_PREFIX):])
            if bid < upto:
                self._kv.delete(k)
                removed += 1
        if anchor.data:
            self._kv.put(self._pfx + _block_key(upto),
                         _encode_block(Block(id=upto, parent=GENESIS)))
        self.floor = upto
        self._kv.put(self._pfx + _FLOOR_KEY, struct.pack(">Q", upto))
        log.debug("truncated %d blocks below %#x", removed, upto)
        return removed

    def install_snapshot(self, snap_id: int) -> None:
        """Replace the entire chain with a snapshot anchor at ``snap_id``
        (follower catch-up when the leader has truncated past our head).
        After this: head = commit = floor = snap_id, no other blocks."""
        if snap_id <= self.committed and self.committed != GENESIS:
            raise ChainError(
                f"install_snapshot: {snap_id:#x} not ahead of commit "
                f"{self.committed:#x}"
            )
        for k, _ in list(self._kv.scan_prefix(self._pfx + _BLOCK_PREFIX)):
            self._kv.delete(k)
        self._kv.put(self._pfx + _block_key(snap_id),
                     _encode_block(Block(id=snap_id, parent=GENESIS)))
        self.committed = snap_id
        self._kv.put(self._pfx + _COMMIT_KEY, struct.pack(">Q", snap_id))
        self.floor = snap_id
        self._kv.put(self._pfx + _FLOOR_KEY, struct.pack(">Q", snap_id))
        self._set_head(snap_id)

    def reset(self) -> None:
        """Wipe the group back to genesis — a brand-new replica. Used when
        local durable state is unrecoverable (e.g. the data-plane log lost
        its prefix below the truncation floor): presenting as empty makes
        the leader re-sync us from scratch instead of trusting pointers the
        data no longer backs."""
        for k, _ in list(self._kv.scan_prefix(self._pfx + _BLOCK_PREFIX)):
            self._kv.delete(k)
        genesis = Block(id=GENESIS, parent=GENESIS)
        self._kv.put(self._pfx + _block_key(GENESIS), _encode_block(genesis))
        self.committed = GENESIS
        self._kv.put(self._pfx + _COMMIT_KEY, struct.pack(">Q", GENESIS))
        self.floor = GENESIS
        self._kv.put(self._pfx + _FLOOR_KEY, struct.pack(">Q", GENESIS))
        self._set_head(GENESIS)

    def force_head(self, bid: int) -> None:
        """Point head at a stored block (engine reconciliation after the
        device adopts a branch whose blocks were already present)."""
        if not self.has(bid):
            raise ChainError(f"force_head: unknown block {bid:#x}")
        self._set_head(bid)

    # ----------------------------------------------------------- helpers

    def _set_head(self, bid: int) -> None:
        self.head = bid
        self._kv.put(self._pfx + _HEAD_KEY, struct.pack(">Q", bid))
