"""In-process Raft client handle.

Parity: reference ``src/raft/client.rs:26-38`` — ``propose(Vec<u8>) ->
Vec<u8>`` over an mpsc + oneshot pair. Here the "channel" is a direct
reference to the server's propose coroutine; the await IS the oneshot.
"""

from __future__ import annotations


class RaftClient:
    def __init__(self, server):
        self._server = server

    async def propose(self, payload: bytes, group: int = 0, timeout: float = 5.0) -> bytes:
        """Submit a state-machine transition; resolves with the FSM result
        once committed (routing through the current leader transparently)."""
        return await self._server.propose(payload, group=group, timeout=timeout)

    async def propose_local(self, payload: bytes, group: int = 0,
                            timeout: float = 5.0) -> bytes:
        """Propose only if this node leads ``group`` (raises NotLeader
        otherwise — Kafka data-plane semantics: the client re-routes)."""
        return await self._server.propose_local(payload, group=group, timeout=timeout)

    def has_group(self, group: int) -> bool:
        """Whether the device tensor actually has this group row (a store
        created under a larger engine.partitions may reference rows this
        process does not have)."""
        return self._server.engine.has_group(group)

    def proposal_backlog(self, group: int) -> int:
        """Queued-but-unminted proposals for ``group`` (the broker's
        produce-admission gate — see handlers._produce_replicated)."""
        return self._server.engine.proposal_backlog(group)

    def is_leader(self, group: int = 0) -> bool:
        return self._server.engine.is_leader(group)

    def leader_id(self, group: int = 0) -> int | None:
        """Node id currently leading ``group`` (None = unknown/electing)."""
        return self._server.engine.leader_id(group)

    def in_sync_ids(self, group: int = 0) -> list[int] | None:
        """Node ids currently in sync with the group leader's log (live ISR
        from Raft match pointers); None if this node is not the leader."""
        return self._server.engine.in_sync_ids(group)

    def in_sync_ids_map(self, groups) -> dict[int, list[int]]:
        """Bulk form of :meth:`in_sync_ids` — ONE device fetch for all
        requested groups (use for Metadata requests spanning many
        partitions); groups this node does not lead are absent."""
        return self._server.engine.in_sync_ids_map(groups)

    def lease_serve(self, group: int = 0) -> tuple[bool, str]:
        """Whether a read on ``group`` may be served leader-local right now
        under the tick-denominated leader lease (raft.leases); ``(ok,
        reason)`` — see RaftEngine.lease_serve. Counts the decision in
        raft_reads_leased_total / raft_reads_fallback_total."""
        return self._server.engine.lease_serve(group)

    def read_barrier(self, group: int = 0):
        """Awaitable quorum read barrier (ReadIndex-style): resolves True
        once a quorum acknowledged this leader's traffic from the current
        tick onward — local committed state is then at least as fresh as
        any write acknowledged before the barrier started. False = lost
        leadership; the caller answers a retryable NotLeader."""
        return self._server.engine.read_barrier(group)
