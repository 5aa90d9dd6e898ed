"""The Raft server: tick loop + transport + proposal routing.

The PyTorch port of the JAX package's ``raft/server.py``. The runtime is the
same host code; the engine's state lives on ``device`` (the card unless the
caller asks for the CPU), and ``backend`` picks the PyTorch engine
(``"torch"``, the default) or the scalar one (``"python"``). Two deliberate
differences, both about forwarded proposals under load:

* A forward's wait for its ``CLIENT_RESP`` and the leader's wait for the
  commit stretch with the ticks: they are the JAX server's 2 s and 5 s at
  the configured ``tick_ms``, times the largest factor by which a cycle of
  the tick loop ran slower than that while they wait
  (:attr:`JosefineRaft.slowdown`). With fixed waits, once a tick takes
  more than about a third of 2 s every forward is sent again before its
  commit can arrive; the copies fill the per-peer queues, which drop on
  full, and the backlog pushes live requests out of the dedup map, whose
  re-forwards then mint a second block.
* Bounding the leader's dedup map (:meth:`JosefineRaft._evict_served`)
  costs what it visits, not a scan and a sort of the whole map per
  forwarded request, and past its cap it drops finished entries before
  live ones, where the JAX server drops the oldest entries, live or not.

Parity: reference ``src/raft/server.rs`` — bind listener, spawn tcp
send/recv + fsm driver + event loop (:48-100), 100 ms tick (:25), select
over {tick, peer messages, client proposals} (:120-161), client-request
correlation map (:115-118).

The big structural difference: there is no role state here at all. The
event loop's only jobs are (a) calling ``engine.tick()`` on the cadence and
moving wire messages between the transport and the engine, and (b) routing
client proposals to whichever node currently leads (the reference's
follower proxy path, ``follower.rs:258-282``, with an explicit correlation
map instead of the reference's leaky dangling-oneshot scheme — SURVEY.md
quirk 6).
"""

from __future__ import annotations

import asyncio
import functools
import itertools
import uuid

from josefine_tpu_torch.config import RaftConfig
from josefine_tpu_torch.models.types import StepParams, step_params
from josefine_tpu_torch.raft import membership, rpc
from josefine_tpu_torch.raft.engine import NotLeader, RaftEngine
from josefine_tpu_torch.raft.fsm import Fsm
from josefine_tpu_torch.raft.pacer import WallClockPacer
from josefine_tpu_torch.raft.tcp import Transport
from josefine_tpu_torch.utils.kv import KV
from josefine_tpu_torch.utils.shutdown import Shutdown
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("raft.server")


class ProposalTimeout(Exception):
    pass


# Forwarded-request dedup window: must cover a client's retry loop (propose
# timeout default 5 s + forward round trips), after which a req_id is
# forgotten and a re-forward is served fresh.
SERVED_TTL_S = 30.0
SERVED_SOFT_CAP = 4096
# How long a forward waits for its CLIENT_RESP before sending the request
# again, and how long the leader waits for the commit before answering a
# failure, when ticks run at the configured tick_ms; both stretch by
# JosefineRaft.slowdown.
FORWARD_TIMEOUT_S = 2.0
SERVE_TIMEOUT_S = 5.0


class JosefineRaft:
    """One node's Raft runtime (reference ``JosefineRaft::new + run``,
    ``src/raft/mod.rs:78-133``)."""

    def __init__(
        self,
        config: RaftConfig,
        kv: KV,
        fsms: dict[int, Fsm],
        groups: int = 1,
        params: StepParams | None = None,
        shutdown: Shutdown | None = None,
        backend: str = "torch",
        mesh=None,
        pacer=None,
        intercept_send=None,
        intercept_recv=None,
        sock=None,
        device="cuda",
    ):
        self.config = config
        self.shutdown = shutdown or Shutdown()
        # Tick source. Default: wall clock, the reference's 100 ms-loop
        # semantics (server.rs:25). Tests/simulation inject a
        # LockstepPacer so tick counts decouple from host load.
        self.pacer = pacer if pacer is not None else WallClockPacer()
        node_ids = [config.id] + [n.id for n in config.nodes]
        self.engine = RaftEngine(
            kv,
            node_ids,
            config.id,
            groups=groups,
            fsms=fsms,
            params=params
            or step_params(
                timeout_min=max(2, config.election_timeout_min_ms // config.tick_ms),
                timeout_max=max(3, config.election_timeout_max_ms // config.tick_ms),
                hb_ticks=max(1, config.heartbeat_timeout_ms // config.tick_ms),
                device=device,
            ),
            base_seed=config.id,
            snapshot_threshold=config.snapshot_threshold,
            snapshot_interval_ticks=max(
                1, config.snapshot_interval_s * 1000 // config.tick_ms
            ),
            max_nodes=config.max_nodes,
            backend=backend,
            max_append_entries=config.max_append_entries,
            active_set=config.active_set,
            mesh=mesh,
            flight_ring=getattr(config, "flight_ring", 4096),
            flight_wire=getattr(config, "flight_wire", False),
            flight_ring_spill=getattr(config, "flight_ring_spill", False),
            request_spans=getattr(config, "request_spans", False),
            leases=getattr(config, "leases", False),
            flight_lease=getattr(config, "flight_lease", False),
            health=getattr(config, "health", False),
            device=device,
        )
        # Peer addresses: configured nodes, plus any members the durable
        # member table knows that config does not (nodes added at runtime
        # before our last shutdown).
        addr_by_id = {n.id: n.addr for n in config.nodes}
        for m in self.engine.members.by_id.values():
            if m.active and m.node_id != config.id and m.node_id not in addr_by_id:
                if m.ip and m.port:
                    addr_by_id[m.node_id] = (m.ip, m.port)
        self.transport = Transport(
            config.id,
            (config.ip, config.port),
            addr_by_id,
            self._on_message,
            self.shutdown,
            intercept_send=intercept_send,
            intercept_recv=intercept_recv,
            sock=sock,
        )
        self._inbound_client: list[rpc.WireMsg] = []
        self._forwarded: dict[str, asyncio.Future] = {}
        # Leader-side dedup of forwarded requests: req_id -> (future, born),
        # so a follower's re-forward of the same request (after a response
        # was lost/slow) does not mint a second block. Entries age out after
        # SERVED_TTL_S (the client retry window) — a cached result can never
        # answer a re-forward from a later leadership era — and the map is
        # hard-bounded (oldest evicted first) so slow proposals cannot grow
        # it without limit.
        self._served: dict[str, tuple[asyncio.Future, float]] = {}
        # The map is kept in age order (a re-served request moves to the
        # end), and the keys whose future failed or was cancelled are
        # recorded as they fail, so an eviction need not visit every entry.
        self._served_dead: set[str] = set()
        self._bg_tasks: set[asyncio.Task] = set()
        # How many times longer than tick_ms (times its ticks) the tick
        # loop's last cycle took, at least 1: the wall time between the
        # starts of two windows, waits for the pacer's grant included.
        self.slowdown = 1.0
        self._tick_task: asyncio.Task | None = None
        self.bound_addr: tuple[str, int] | None = None

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        self.bound_addr = await self.transport.start()
        self.pacer.attach(self)
        self._tick_task = asyncio.create_task(self._tick_loop())

    async def run(self) -> None:
        """Start and block until shutdown (reference run() semantics)."""
        await self.start()
        await self.shutdown.wait()
        await self.stop()

    async def stop(self) -> None:
        self.shutdown.shutdown()
        if self._tick_task:
            self._tick_task.cancel()
            await asyncio.gather(self._tick_task, return_exceptions=True)
        await self.transport.stop()

    # ------------------------------------------------------------ proposals

    async def propose(self, payload: bytes, group: int = 0, timeout: float = 5.0) -> bytes:
        """Propose with leader routing: try locally; on NotLeader forward to
        the hinted leader and await its CLIENT_RESP; retry across leader
        churn until ``timeout``.

        Semantics are at-least-once across *leader failover* (as in the
        reference); within one call, re-forwards reuse a stable request id
        and the serving leader dedups on it, so a slow or lost response does
        not mint a duplicate block.
        """
        deadline = asyncio.get_running_loop().time() + timeout
        # graftlint: allow(det-uuid) — request-dedup identity; a seeded RNG would repeat after restart and falsely dedup fresh proposals
        req_id = uuid.uuid4().hex  # stable across retries of this call
        while True:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                raise ProposalTimeout(f"propose timed out after {timeout}s")
            try:
                fut = self.engine.propose(group, payload)
                return await asyncio.wait_for(fut, remaining)
            except asyncio.TimeoutError:
                raise ProposalTimeout(f"propose timed out after {timeout}s")
            except NotLeader:
                leader_id = self.engine.leader_id(group)
                if leader_id is None or leader_id == self.config.id:
                    await asyncio.sleep(self.config.tick_ms / 1000)
                    continue
                try:
                    return await self._forward(group, payload, leader_id, remaining, req_id)
                except (ProposalTimeout, asyncio.TimeoutError):
                    continue
                except NotLeader:
                    await asyncio.sleep(self.config.tick_ms / 1000)
                    continue

    async def propose_local(self, payload: bytes, group: int = 0,
                            timeout: float = 5.0) -> bytes:
        """Propose WITHOUT leader forwarding: raises NotLeader immediately if
        this node cannot mint for ``group``. The Kafka data plane uses this —
        a Produce landing on a non-leader must get NOT_LEADER_OR_FOLLOWER so
        the client re-routes from metadata, not a silent server-side proxy."""
        try:
            fut = self.engine.propose(group, payload)
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            raise ProposalTimeout(f"propose timed out after {timeout}s")

    async def _forward(
        self, group: int, payload: bytes, leader_id: int, timeout: float, req_id: str
    ) -> bytes:
        fut = asyncio.get_running_loop().create_future()
        self._forwarded[req_id] = fut
        try:
            self.transport.send(
                leader_id,
                rpc.WireMsg(
                    kind=rpc.MSG_CLIENT_REQ,
                    group=group,
                    src=self.engine.me,
                    dst=self.engine.node_ids.index(leader_id),
                    req_id=req_id,
                    payload=payload,
                ),
            )
            return await self._await_stretched(fut, FORWARD_TIMEOUT_S, timeout)
        finally:
            self._forwarded.pop(req_id, None)

    async def _await_stretched(self, fut: asyncio.Future, base_s: float,
                               limit_s: float = float("inf")):
        """Await ``fut`` for ``base_s`` times the largest ``slowdown`` seen
        while waiting, and at most ``limit_s``; then raise
        ``asyncio.TimeoutError``. The JAX server waits ``base_s`` flat. A
        wait that starts while ticks are fast and outlives the load's
        arrival stretches with it."""
        loop = asyncio.get_running_loop()
        start = loop.time()
        scale = self.slowdown
        while True:
            left = min(limit_s, base_s * scale) - (loop.time() - start)
            if left <= 0:
                raise asyncio.TimeoutError
            try:
                return await asyncio.wait_for(asyncio.shield(fut), left)
            except asyncio.TimeoutError:
                scale = max(scale, self.slowdown)

    # ----------------------------------------------------------- membership

    async def add_node(self, node_id: int, ip: str, port: int,
                       timeout: float = 10.0) -> None:
        """Add (or re-add) a node to the cluster at runtime. Routed to the
        leader like any proposal; resolves when the conf change commits.
        Start the new node afterwards with the full member list in its
        config — it will catch up by log replay or snapshot install."""
        change = membership.ConfChange(op=membership.ADD, node_id=node_id,
                                       ip=ip, port=port)
        await self.propose(change.encode(), group=0, timeout=timeout)

    async def remove_node(self, node_id: int, timeout: float = 10.0) -> None:
        """Remove a node: its column is masked out of every group's quorum
        once the change commits. Shut the removed process down afterwards."""
        change = membership.ConfChange(op=membership.REMOVE, node_id=node_id)
        await self.propose(change.encode(), group=0, timeout=timeout)

    # ------------------------------------------------------------ internals

    def _on_message(self, msg: rpc.WireMsg) -> None:
        if msg.kind == rpc.MSG_CLIENT_REQ:
            t = asyncio.get_running_loop().create_task(self._serve_forwarded(msg))
            self._bg_tasks.add(t)
            t.add_done_callback(self._bg_tasks.discard)
        elif msg.kind == rpc.MSG_CLIENT_RESP:
            # Unknown correlation ids are ignored (the reference panics the
            # event loop here — SURVEY.md quirk 6).
            fut = self._forwarded.get(msg.req_id)
            if fut is not None and not fut.done():
                if msg.ok:
                    fut.set_result(msg.payload)
                else:
                    fut.set_exception(NotLeader(msg.group, -1))
        else:
            self.engine.receive(msg)

    def _evict_served(self, now: float) -> None:
        """Bound the dedup map: age out expired/failed entries; if the map
        is still past its cap, drop the oldest finished entries, and live
        in-flight ones, oldest first, only when no finished entry is left
        (losing dedup for them: a re-forward would propose again).

        The map is in age order, so the expired entries are a prefix, and
        the failed ones are recorded in ``_served_dead`` as they fail, so
        the cost is that of the entries visited. A future that failed in
        this loop turn, before its done-callback ran, is finished and
        goes before any live entry. The JAX server scans every entry,
        sorts by age and drops the oldest past the cap, live or not: at a
        few hundred forwarded requests per tick that took more host time
        than the tick itself, and a backlog of live requests lost their
        dedup while finished ones stayed."""
        served = self._served
        if len(served) <= SERVED_SOFT_CAP:
            return
        for k in self._served_dead:
            f = served.get(k, (None, 0.0))[0]
            if f is not None and f.done() and (f.cancelled() or f.exception()):
                del served[k]
        self._served_dead.clear()
        expired = []
        for k, (_, born) in served.items():
            if now - born <= SERVED_TTL_S:
                break
            expired.append(k)
        for k in expired:
            del served[k]
        excess = len(served) - SERVED_SOFT_CAP
        if excess > 0:
            finished = []
            for k, (f, _) in served.items():
                if f.done():
                    finished.append(k)
                    if len(finished) == excess:
                        break
            for k in finished:
                del served[k]
            excess -= len(finished)
        if excess > 0:
            for k in list(itertools.islice(served, excess)):
                del served[k]

    def _served_done(self, req_id: str, fut: asyncio.Future) -> None:
        """Done-callback of a served future: record a failed one."""
        ent = self._served.get(req_id)
        if ent is not None and ent[0] is fut and (fut.cancelled() or fut.exception()):
            self._served_dead.add(req_id)

    async def _serve_forwarded(self, msg: rpc.WireMsg) -> None:
        """Leader side of the proxy: mint, await commit, answer the origin.
        Dedups on req_id so a re-forwarded request shares the original block
        instead of minting a new one."""
        try:
            now = asyncio.get_running_loop().time()
            ent = self._served.get(msg.req_id)
            fut = None
            if ent is not None:
                fut, born = ent
                if (now - born > SERVED_TTL_S
                        or (fut.done() and (fut.cancelled() or fut.exception()))):
                    fut = None  # expired or failed: serve fresh
            if fut is None:
                fut = self.engine.propose(msg.group, msg.payload)
                self._served.pop(msg.req_id, None)  # keep the map in age order
                self._served[msg.req_id] = (fut, now)
                fut.add_done_callback(functools.partial(self._served_done, msg.req_id))
                self._evict_served(now)
            result = await self._await_stretched(fut, SERVE_TIMEOUT_S)
            ok, payload = 1, result
        except Exception:
            ok, payload = 0, b""
        origin_id = self.engine.node_ids[msg.src]
        self.transport.send(
            origin_id,
            rpc.WireMsg(
                kind=rpc.MSG_CLIENT_RESP,
                group=msg.group,
                src=self.engine.me,
                dst=msg.src,
                ok=ok,
                req_id=msg.req_id,
                payload=payload,
            ),
        )

    async def _tick_loop(self) -> None:
        """The event loop (reference server.rs:120-161): fixed cadence, each
        iteration steps the engine once and flushes its outbox."""
        interval = self.config.tick_ms / 1000
        max_window = max(1, int(getattr(self.config, "window_ticks", 1)))
        # Double-buffered tick pipeline (raft.pipeline_ticks): keep one
        # device dispatch in flight and do tick t's host work while the
        # device computes t+1. res then describes the PREVIOUS tick — its
        # outbound flushes one loop iteration later, the +1-tick latency
        # the knob's docstring prices in.
        pipeline = bool(getattr(self.config, "pipeline_ticks", False))
        last = None  # (start, ticks) of the previous cycle
        try:
            while not self.shutdown.is_shutdown:
                t0 = asyncio.get_running_loop().time()
                if last is not None:
                    self.slowdown = max(1.0, (t0 - last[0]) / (interval * last[1]))
                # Steady-state clusters fold up to window_ticks ticks into
                # one device dispatch; elections/snapshots/parole drop back
                # to single ticks (engine.suggest_window). The pacer may
                # clamp further (a lockstep harness grants ticks one at a
                # time) or block until ticks are granted at all. acquire()
                # can park indefinitely (LockstepPacer), so the window hint
                # is evaluated AFTER it returns: a hint computed before
                # parking can be stale by grant time (e.g. a group went
                # leaderless while parked — a >1 window would quantize its
                # election timeouts to window boundaries and de-randomize
                # candidacy). Surplus granted ticks go back to the pacer.
                got = await self.pacer.acquire(self, max_window)
                w = min(got, self.engine.suggest_window(max_window))
                if got > w:
                    self.pacer.release(self, got - w)
                res = (self.engine.tick_pipelined(window=w) if pipeline
                       else self.engine.tick(window=w))
                for ch in res.conf_changes:
                    if ch.node_id == self.config.id:
                        continue
                    if ch.op == membership.ADD and ch.ip and ch.port:
                        self.transport.add_peer(ch.node_id, (ch.ip, ch.port))
                    elif ch.op == membership.REMOVE:
                        self.transport.remove_peer(ch.node_id)
                # Keepalive pings ride res.outbound — the engine emits them
                # itself (tick_finish), so every driver loop gets them.
                for m in res.outbound:
                    dst_id = self.engine.node_ids[m.dst]
                    if dst_id is not None:
                        self.transport.send(dst_id, m)
                last = (t0, w)
                elapsed = asyncio.get_running_loop().time() - t0
                # Wall pacer: a w-tick window covers w tick intervals of
                # wall time. Lockstep pacer: report this node parked.
                await self.pacer.pace(self, w, interval, elapsed)
        except asyncio.CancelledError:
            pass
        except Exception:
            log.exception("tick loop crashed")
            self.shutdown.shutdown()
        finally:
            if pipeline:
                # Complete the in-flight tick so pending proposal futures
                # resolve/fail deterministically instead of dangling.
                try:
                    self.engine.tick_drain()
                except Exception:
                    log.exception("pipeline drain failed")
            self.pacer.detach(self)
