"""FSM protocol and driver: decouple commit from apply.

Parity: reference ``src/raft/fsm.rs`` — the ``Fsm`` trait (:15-17), the
``Instruction::{Apply, Notify}`` split (:20-29), skipping payload-less
blocks (genesis/no-op, :61-63), and routing the FSM result back to the
awaiting client through a notification map (:64-81).

Delta (deliberate, SURVEY.md quirk 7b): the engine hands the driver the
half-open committed range ``(old, new]`` on **every** node, so each block is
applied exactly once everywhere — the reference's follower path re-applies
the old commit block and skips the new one.
"""

from __future__ import annotations

import asyncio
from typing import Protocol

from josefine_tpu_torch.raft.chain import Block
from josefine_tpu_torch.utils.tracing import TRACE, get_logger

log = get_logger("raft.fsm")


class ReplicaDiverged(Exception):
    """Raised by an FSM whose local durable state provably cannot be the
    fold of the committed sequence (e.g. a torn-append skip found a foreign
    blob at the tail). The engine reacts by resetting the group to an empty
    replica (with vote parole) and letting the leader re-sync it — the
    divergence is local and unrecoverable, never something to paper over."""


class Fsm(Protocol):
    """Apply one committed payload, return the response bytes.

    Must be deterministic: every node applies the same committed sequence.

    An FSM may additionally implement the snapshot pair::

        def snapshot(self) -> bytes        # full-state dump at this commit
        def restore(self, data: bytes)     # replace state with a dump;
                                           # b"" resets to the initial state

    which enables log compaction (the engine truncates the chain below the
    snapshot point) and snapshot-install catch-up for followers that fell
    behind the truncation floor. The reference declares snapshot config
    knobs but never implements any of this (``src/raft/config.rs:38-40``,
    ``src/raft/progress.rs:182-203`` — SURVEY.md aux notes).
    """

    def transition(self, data: bytes) -> bytes: ...


def supports_snapshot(fsm) -> bool:
    return callable(getattr(fsm, "snapshot", None)) and callable(
        getattr(fsm, "restore", None)
    )


class Driver:
    """Applies committed blocks to the FSM and resolves client futures.

    ``notify(block_id, future)`` registers interest (leader side, at propose
    time); ``apply(blocks)`` runs transitions and fulfills any registered
    future with the FSM's result (the Notify/Apply correlation of reference
    fsm.rs:64-81).
    """

    def __init__(self, fsm: Fsm):
        self.fsm = fsm
        self._waiters: dict[int, asyncio.Future] = {}

    def notify(self, block_id: int, fut: asyncio.Future) -> None:
        self._waiters[block_id] = fut

    def drop_waiters(self, exc: Exception | None = None) -> None:
        """On leadership loss: fail outstanding proposals so clients retry
        (the reference leaks these — SURVEY.md quirk 6)."""
        for fut in self._waiters.values():
            if not fut.done():
                if exc is None:
                    fut.cancel()
                else:
                    fut.set_exception(exc)
        self._waiters.clear()

    def apply(self, blocks: list[Block]) -> None:
        # FSMs that need the block identity for idempotent re-apply (the
        # data-plane PartitionFsm's exact-once log append) expose
        # transition_block(blk); plain FSMs get the payload only.
        tb = getattr(self.fsm, "transition_block", None)
        trace = log.isEnabledFor(TRACE)
        for blk in blocks:
            if not blk.data:  # genesis / no-op blocks carry no payload
                result = b""
            elif tb is not None:
                result = tb(blk)
            else:
                result = self.fsm.transition(blk.data)
            if trace:
                # Per-apply span (the reference instruments every method
                # with #[tracing::instrument]; here the apply seam is the
                # one whose history answers "what did this replica fold").
                log.log(TRACE, "apply %s blk=%#x len=%d -> %d waiters=%d",
                        type(self.fsm).__name__, blk.id, len(blk.data),
                        len(result), len(self._waiters))
            fut = self._waiters.pop(blk.id, None)
            if fut is not None and not fut.done():
                fut.set_result(result)
