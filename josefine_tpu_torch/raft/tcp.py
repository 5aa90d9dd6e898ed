"""Full-mesh cluster transport: length-delimited JSON frames over TCP.

Parity: reference ``src/raft/tcp.rs`` — inbound accept loop spawning a
reader per connection (:16-38), one outbound connect-loop task per peer
(:53-103) with exponential backoff reconnect (:110-137) and a bounded
per-peer queue of 1000 messages with drop-on-full (:63, :90-96); frames are
length-delimited serde-JSON (:40-51, :143-156) — here 4-byte big-endian
length + the :mod:`josefine_tpu.raft.rpc` JSON encoding.

Delta: broadcast expansion (reference ``Address::Peers``, tcp.rs:81-87)
lives in the engine's outbox decode (one WireMsg per destination), so the
transport only ever sees unicast messages.
"""

from __future__ import annotations

import asyncio
from typing import Callable

from josefine_tpu_torch.raft.rpc import MSG_BATCH, MsgBatch, WireMsg, decode_frame
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.shutdown import Shutdown
from josefine_tpu_torch.utils.tracing import get_logger

# Queue sentinel: "deliver whatever is newest in the batch mailbox".
_BATCH_TOKEN = object()

log = get_logger("raft.tcp")

_m_received = REGISTRY.counter("raft_transport_frames_received_total",
                               "Decoded inbound transport frames")
_m_dropped = REGISTRY.counter("raft_transport_dropped_total",
                              "Messages dropped on a full per-peer queue")
_m_reconnects = REGISTRY.counter("raft_transport_reconnects_total",
                                 "Outbound peer reconnect attempts after failure")

MAX_FRAME = 1 << 30
SEND_QUEUE_DEPTH = 1000  # reference tcp.rs:63
BACKOFF_BASE_S = 0.2     # reference reconnect backoff (tcp.rs:110-137)
BACKOFF_MAX_S = 5.0


async def read_frame(reader: asyncio.StreamReader) -> bytes:
    hdr = await reader.readexactly(4)
    n = int.from_bytes(hdr, "big")
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n}")
    return await reader.readexactly(n)


def write_frame(writer: asyncio.StreamWriter, body: bytes) -> None:
    writer.write(len(body).to_bytes(4, "big") + body)


class Transport:
    """Owns the inbound listener and the per-peer outbound connect loops."""

    def __init__(
        self,
        self_id: int,
        bind_addr: tuple[str, int],
        peers: dict[int, tuple[str, int]],  # node id -> (ip, port)
        on_message: Callable[[WireMsg], None],
        shutdown: Shutdown,
        intercept_send: Callable[[int, object], bool] | None = None,
        intercept_recv: Callable[[object], bool] | None = None,
        sock=None,
    ):
        # Chaos hook points (josefine_tpu/chaos/faults.py): predicates
        # consulted per outbound (peer_id, msg) / inbound (msg); returning
        # False swallows the message (injected loss / partition). Both are
        # None by default — the production hot path pays one is-None check.
        self._intercept_send = intercept_send
        self._intercept_recv = intercept_recv
        # Pre-bound listening socket (test harnesses bind port 0 and keep
        # the socket open, closing the pick-then-rebind race).
        self._sock = sock
        self.self_id = self_id
        self.bind_addr = bind_addr
        self.peers = peers
        self.on_message = on_message
        self.shutdown = shutdown
        self._queues: dict[int, asyncio.Queue] = {
            nid: asyncio.Queue(SEND_QUEUE_DEPTH) for nid in peers
        }
        # Per-peer 1-slot mailbox for consensus batches. A batch is this
        # tick's snapshot of everything we owe the peer — queueing history
        # to a dead peer only makes its recovery slower: on reconnect the
        # receiver would chew through N stale frames at one inbox slot per
        # tick (carry-over) before any fresh AE lands, adding N ticks of
        # replication latency per outage. Newest-wins instead; Raft's own
        # retry covers anything a dropped frame carried. The queue carries
        # the _BATCH_TOKEN sentinel (resolved by _materialize) in the
        # batch's original position.
        self._latest_batch: dict[int, MsgBatch] = {}
        self._peer_tasks: dict[int, asyncio.Task] = {}
        self._conn_tasks: set[asyncio.Task] = set()
        self._server: asyncio.Server | None = None
        self._started = False
        self.dropped = 0  # drop-on-full counter (observability)
        # Peers whose outbound connection is currently up. Observability
        # plus the wire soak's deterministic-reporting gate (an un-meshed
        # run would mis-report startup dial races as invariant trips);
        # consensus traffic minted while a dial is still in its reconnect
        # backoff is lost to the newest-wins mailbox, and the protocol
        # repairs that on its own — the NACK'd span survives the window
        # outbox merge (packed_step._merge_outbox), so harnesses no longer
        # gate first tick grants on full-mesh connectivity.
        self.connected: set[int] = set()

    async def start(self) -> tuple[str, int]:
        if self._sock is not None:
            self._server = await asyncio.start_server(
                self._handle_conn, sock=self._sock)
        else:
            self._server = await asyncio.start_server(
                self._handle_conn, self.bind_addr[0], self.bind_addr[1]
            )
        self._started = True
        for nid in self.peers:
            self._peer_tasks[nid] = asyncio.create_task(self._send_loop(nid))
        addr = self._server.sockets[0].getsockname()[:2]
        log.debug("node %d transport listening on %s", self.self_id, addr)
        return addr

    def add_peer(self, peer_id: int, addr: tuple[str, int]) -> None:
        """Runtime membership: start (or re-point) the outbound connect loop
        for a peer. The reference's peer set is startup-frozen config
        (``src/raft/config.rs:26``); here the cluster can grow live."""
        if peer_id == self.self_id:
            return
        self.peers[peer_id] = addr
        if peer_id not in self._queues:
            self._queues[peer_id] = asyncio.Queue(SEND_QUEUE_DEPTH)
        if self._started and peer_id not in self._peer_tasks:
            self._peer_tasks[peer_id] = asyncio.create_task(self._send_loop(peer_id))
            log.info("node %d transport: added peer %d at %s", self.self_id, peer_id, addr)

    def remove_peer(self, peer_id: int) -> None:
        """Runtime membership: tear down a removed peer's connect loop."""
        task = self._peer_tasks.pop(peer_id, None)
        if task is not None:
            task.cancel()
        self._queues.pop(peer_id, None)
        # The dropped queue may hold this mailbox's token; clearing the
        # mailbox too keeps the token<->mailbox invariant, else a re-added
        # peer would never be sent another consensus batch (send() would
        # see stale content and skip the token forever).
        self._latest_batch.pop(peer_id, None)
        self.peers.pop(peer_id, None)

    def send(self, peer_id: int, msg: WireMsg | MsgBatch) -> None:
        """Enqueue; full queue drops the message (reference tcp.rs:90-96 —
        Raft tolerates loss, retry comes from the protocol itself).
        Consensus batches coalesce into a 1-slot newest-wins mailbox."""
        if self._intercept_send is not None and not self._intercept_send(peer_id, msg):
            return  # injected loss (chaos): the fault plane counts it
        q = self._queues.get(peer_id)
        if q is None:
            log.warning("send to unknown peer %d", peer_id)
            return
        if msg.kind == MSG_BATCH:
            had = self._latest_batch.get(peer_id) is not None
            self._latest_batch[peer_id] = msg
            if had:
                return  # a token is already queued; newest content wins
            msg = _BATCH_TOKEN
        try:
            q.put_nowait(msg)
        except asyncio.QueueFull:
            if msg is _BATCH_TOKEN:
                self._latest_batch.pop(peer_id, None)
            self.dropped += 1
            _m_dropped.inc(node=self.self_id)

    async def stop(self) -> None:
        tasks = list(self._peer_tasks.values()) + list(self._conn_tasks)
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------ internals

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        try:
            while not self.shutdown.is_shutdown:
                body = await read_frame(reader)
                try:
                    msg = decode_frame(body)
                except Exception:
                    log.warning("undecodable frame (%d bytes); closing conn", len(body))
                    break
                _m_received.inc(node=self.self_id)
                if self._intercept_recv is not None and not self._intercept_recv(msg):
                    continue  # injected inbound loss (chaos)
                self.on_message(msg)
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        except ValueError as e:
            log.warning("closing connection: %s", e)
        finally:
            if task is not None:
                self._conn_tasks.discard(task)
            writer.close()

    def _materialize(self, peer_id: int, msg) -> bytes | None:
        """Resolve a queue item to frame bytes: a batch token takes the
        newest mailbox content (None if already taken)."""
        if msg is _BATCH_TOKEN:
            msg = self._latest_batch.pop(peer_id, None)
            if msg is None:
                return None
        return msg.encode()

    async def _send_loop(self, peer_id: int):
        """Connect-with-backoff loop draining this peer's queue
        (reference tcp.rs:110-137)."""
        backoff = BACKOFF_BASE_S
        q = self._queues[peer_id]
        while not self.shutdown.is_shutdown:
            writer = None
            try:
                host, port = self.peers[peer_id]
                _, writer = await asyncio.open_connection(host, port)
                backoff = BACKOFF_BASE_S
                self.connected.add(peer_id)
                log.debug("node %d connected to peer %d", self.self_id, peer_id)
                while True:
                    msg = await q.get()
                    body = self._materialize(peer_id, msg)
                    if body is not None:
                        write_frame(writer, body)
                    # Coalesce whatever else is queued into one flush.
                    while not q.empty():
                        body = self._materialize(peer_id, q.get_nowait())
                        if body is not None:
                            write_frame(writer, body)
                    await writer.drain()
            except asyncio.CancelledError:
                self.connected.discard(peer_id)
                if writer is not None:
                    writer.close()
                return
            except (ConnectionError, OSError):
                self.connected.discard(peer_id)
                if writer is not None:
                    writer.close()
                _m_reconnects.inc(node=self.self_id)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, BACKOFF_MAX_S)
