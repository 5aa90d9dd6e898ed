"""A deterministic harness for in-process clusters of ``JosefineRaft``.

Three pieces take the host's speed out of a run, so two clusters given the
same script (a cluster on the card and one on the CPU, or the JAX server and
the port's) do the same thing on every tick:

* :class:`VirtualClockLoop`, an asyncio loop whose clock stands still while
  the loop has work and jumps to the next timer when it has none. Every
  wall-time wait in the server (a forward's 2 s, the leader's 5 s, a
  propose timeout) then counts idle turns of the loop, not host seconds, so
  a slow host cannot fire one on one side only. Run a coroutine on it with
  :func:`run`.
* :class:`Hop`, which stands in for the sockets. Each server's
  ``intercept_send`` captures its outbound ``(peer, msg)`` and swallows it;
  :meth:`Hop.deliver` then encodes each captured message, decodes it with
  the package's ``rpc.decode_frame`` as the TCP transport does, and hands
  it to the destination server's ``_on_message``, in a fixed order: by
  sender id, then by send order. Everything of the server runs but the
  socket itself: the tick loop, ``suggest_window``, forwarding,
  ``CLIENT_RESP``, the dedup cache and conf-change peer updates.
* :func:`run_script`, the traffic both clusters are given: proposals to
  random groups through random nodes once a group has a live leader (so
  about two thirds are forwarded), the leader of group 0 stopped at a set
  tick, and a check that nothing failed silently: no client call failed,
  no server's tick loop crashed (it logs "tick loop crashed" and shuts its
  server down, as the reference does) and no server shut down before the
  script stopped it.

The harness imports nothing of the servers it drives: a cluster of the JAX
package's servers is driven the same way, given that package's
``decode_frame``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import selectors

import numpy as np

from josefine_tpu_torch.models.types import LEADER
from josefine_tpu_torch.raft.client import RaftClient


class _JumpSelector(selectors.DefaultSelector):
    """Never waits for I/O while a timer is due: with nothing ready, the
    loop's clock jumps by the wait the loop asked for."""

    def __init__(self, clock: list[float]):
        super().__init__()
        self._clock = clock

    def select(self, timeout=None):
        events = super().select(None if timeout is None else 0)
        if not events and timeout:
            self._clock[0] += timeout
        return events


class VirtualClockLoop(asyncio.SelectorEventLoop):
    """An event loop on a virtual clock (see the module docstring)."""

    def __init__(self):
        self._clock = [0.0]
        super().__init__(_JumpSelector(self._clock))

    def time(self) -> float:
        return self._clock[0]


def run(coro):
    """Run ``coro`` to its end on a fresh :class:`VirtualClockLoop`."""
    with asyncio.Runner(loop_factory=VirtualClockLoop) as runner:
        return runner.run(coro)


class Hop:
    """Fixed-order delivery between in-process servers (see the module
    docstring). ``decode_frame`` is the servers' own package's."""

    def __init__(self, decode_frame):
        self._decode = decode_frame
        self._sent: dict[int, list] = {}
        self._req_ids: dict[str, int] = {}
        self.servers: dict[int, object] = {}

    def intercept(self, node_id: int):
        """The ``intercept_send`` of server ``node_id``."""
        box = self._sent.setdefault(node_id, [])

        def capture(peer_id, msg) -> bool:
            box.append((peer_id, msg))
            return False

        return capture

    def add(self, server) -> None:
        self.servers[server.config.id] = server

    def remove(self, node_id: int) -> None:
        """A stopped server: nothing more goes to it or comes from it."""
        self.servers.pop(node_id, None)
        self._sent.pop(node_id, None)

    def _canonical(self, msg, raw: bytes) -> bytes:
        """The frame with a client request id replaced by its order of first
        appearance: ids are ``uuid4`` and differ from run to run."""
        req_id = getattr(msg, "req_id", "")
        if not req_id:
            return raw
        k = self._req_ids.setdefault(req_id, len(self._req_ids))
        return dataclasses.replace(msg, req_id=f"#{k}").encode()

    def deliver(self) -> list[tuple[int, int, bytes]]:
        """Hand every captured message to its destination; returns the
        wire as ``(src id, dst id, frame bytes)`` in delivery order, client
        request ids canonicalized. Messages to a server not (or no longer)
        in the hop are on the wire but delivered nowhere."""
        wire = []
        for src in sorted(self._sent):
            box = self._sent[src]
            sent, box[:] = list(box), []
            for peer_id, msg in sent:
                raw = msg.encode()
                wire.append((src, peer_id, self._canonical(msg, raw)))
                dst = self.servers.get(peer_id)
                if dst is not None:
                    dst._on_message(self._decode(raw))
        return wire


# The script's cluster timing at 100 ms ticks: election timeouts of 6 to 15
# ticks and heartbeats every 16. With pipelined ticks a vote's round trip
# takes 4 ticks, and at 3 to 8 ticks pipelined elections barely converge.
TIMING = dict(tick_ms=100, heartbeat_timeout_ms=1600, election_timeout_min_ms=600,
              election_timeout_max_ms=1500)


def mesh_configs(ports: list[int], raft_config, node_addr, **extra) -> list:
    """The ``raft_config`` of each node of a full mesh on ``ports`` (node
    ids 1, 2, ...) with :data:`TIMING` and ``extra``; ``raft_config`` and
    ``node_addr`` are the classes of the servers' own package."""
    ids = range(1, len(ports) + 1)
    return [raft_config(id=nid, ip="127.0.0.1", port=ports[nid - 1],
                        nodes=[node_addr(id=o, ip="127.0.0.1", port=ports[o - 1])
                               for o in ids if o != nid], **TIMING, **extra)
            for nid in ids]


@dataclasses.dataclass
class Side:
    """One cluster of a script: its servers (index i holds node id i + 1),
    their hop, and their FSMs by node index, then group."""

    servers: list
    hop: Hop
    fsms: list[dict]
    stopped: set = dataclasses.field(default_factory=set)


class CrashWatch(logging.Handler):
    """Counts the records of a crashed tick loop (``josefine.raft.server``
    logs "tick loop crashed" and shuts its server down)."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.crashes: list[str] = []

    def emit(self, record) -> None:
        if "tick loop crashed" in record.getMessage():
            self.crashes.append(self.format(record))

    def __enter__(self):
        logging.getLogger("josefine.raft.server").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("josefine.raft.server").removeHandler(self)


def _leader_of(side: Side, g: int) -> int | None:
    """The live node leading group ``g``, if exactly one claims it."""
    ids = [s.config.id for s in side.servers
           if s.config.id not in side.stopped and s.engine.is_leader(g)]
    return ids[0] if len(ids) == 1 else None


# The script's schedule: proposals from tick START, the leader of group 0
# stopped from tick STOP_AT with none offered in the QUIET ticks before,
# at most DRAIN ticks after the last one for the answers, and a client
# timeout no run reaches.
START, STOP_AT, QUIET, DRAIN, CLIENT_TIMEOUT_S = 8, 30, 8, 200, 3600.0


async def run_script(sides: list[Side], pacer, ticks: int, seed: int, per_tick: int,
                     step: int = 1, on_tick=None) -> dict:
    """Start every side's servers and drive them alike for ``ticks`` ticks
    (all sides share ``pacer``): ``step`` ticks per ``pacer.advance`` while
    every group has a live leader on side 0, else one. The hop delivers
    between advances only, so a vote's round trip would span several ticks
    of a multi-tick advance and outlast the election timeout.

    From tick ``START``, before each advance, ``per_tick`` distinct random
    groups (from ``seed``) each get one proposal through
    ``RaftClient(node).propose``, ``node`` drawn at random among the live
    nodes, where side 0 shows a live leader for the group that ``node``
    also names. From ``QUIET`` ticks before ``STOP_AT`` none is offered
    until the leader of group 0 is stopped (on every side), at the first
    tick from ``STOP_AT`` on where group 0 has a leader and no proposal is
    in flight. After each advance every side's hop delivers, and
    ``on_tick(t, wires)`` gets the ticks run so far and each side's wire.
    After ``ticks``, the sides run on (at most ``DRAIN`` more ticks) until
    every proposal is answered and applied by every live node's FSM of its
    group and group 0 has a live leader again, then stop.

    Raises if a proposal failed or was left unanswered or unapplied, if a
    tick loop crashed or a server shut down before being stopped, or if the
    sides' answers differ. Returns the counts: proposals, forwarded ones,
    ticks, multi-tick advances, and the node stopped."""
    rng = np.random.default_rng(seed)
    calls: list[list[asyncio.Task]] = [[] for _ in sides]
    offered: list[tuple[int, bytes]] = []
    stats = {"proposed": 0, "forwarded": 0, "ticks": 0, "stopped": None, "strided": 0}
    base = sides[0]
    P = base.servers[0].engine.P

    def check_alive():
        for side in sides:
            for s in side.servers:
                if s.config.id not in side.stopped and s.shutdown.is_shutdown:
                    raise AssertionError(f"server {s.config.id} shut down on its own")

    def settled() -> bool:
        """Every proposal answered and applied on every live node, and a
        live leader of group 0."""
        if _leader_of(base, 0) is None or any(not c.done() for mine in calls for c in mine):
            return False
        return all(payload in side.fsms[n - 1][g].applied
                   for side in sides for g, payload in offered
                   for n in range(1, len(side.servers) + 1) if n not in side.stopped)

    def submit(t: int):
        live = [s.config.id for s in base.servers if s.config.id not in base.stopped]
        for g in rng.permutation(P)[:per_tick].tolist():
            via = int(rng.choice(live))
            lead = _leader_of(base, g)
            if lead is None or base.servers[via - 1].engine.leader_id(g) != lead:
                continue
            payload = b"t%d-g%d-n%d" % (t, g, via)
            for side, mine in zip(sides, calls):
                client = RaftClient(side.servers[via - 1])
                mine.append(asyncio.ensure_future(
                    client.propose(payload, group=g, timeout=CLIENT_TIMEOUT_S)))
            offered.append((g, payload))
            stats["proposed"] += 1
            stats["forwarded"] += via != lead

    def stride() -> int:
        if step == 1:
            return 1
        roles = [s.engine._h_role for s in base.servers if s.config.id not in base.stopped]
        return step if (np.sum([r == LEADER for r in roles], axis=0) == 1).all() else 1

    async def advance(t: int, n: int) -> None:
        await pacer.advance(n)
        stats["strided"] += n > 1
        wires = [side.hop.deliver() for side in sides]
        # Let the delivered client requests reach their engines.
        await asyncio.sleep(0)
        check_alive()
        if on_tick is not None:
            on_tick(t, wires)

    with CrashWatch() as watch:
        for side in sides:
            for s in side.servers:
                side.hop.add(s)
                await s.start()
        try:
            t = 0
            while t < ticks:
                to_stop = stats["stopped"] is None
                if to_stop and t >= STOP_AT:
                    lead = _leader_of(base, 0)
                    if lead is not None and not any(not c.done() for mine in calls
                                                    for c in mine):
                        if any(_leader_of(s, 0) != lead for s in sides):
                            raise AssertionError(f"tick {t}: the sides' leaders of group 0 "
                                                 "differ")
                        for side in sides:
                            side.stopped.add(lead)
                            side.hop.remove(lead)
                            await side.servers[lead - 1].stop()
                        stats["stopped"] = lead
                        to_stop = False
                    elif t >= STOP_AT + DRAIN:
                        raise AssertionError(f"tick {t}: no leader of group 0 to stop with "
                                             "nothing in flight")
                if t >= START and not (to_stop and t >= STOP_AT - QUIET):
                    submit(t)
                n = stride()
                t += n
                await advance(t, n)
            extra = 0
            while not settled() and extra < DRAIN:
                n = stride()
                t += n
                extra += n
                await advance(t, n)
            stats["ticks"] = t
        finally:
            for side in sides:
                for s in side.servers:
                    if s.config.id not in side.stopped:
                        await s.stop()
        if watch.crashes:
            raise AssertionError(f"a tick loop crashed: {watch.crashes[0]}")
    if not settled():
        raise AssertionError("proposals left unanswered or unapplied after the drain")
    answers = []
    for mine in calls:
        failed = [c.exception() for c in mine if c.exception() is not None]
        if failed:
            raise AssertionError(f"{len(failed)} proposals failed: {failed[0]!r}")
        answers.append([c.result() for c in mine])
    if any(a != answers[0] for a in answers):
        raise AssertionError("the sides answered the proposals differently")
    return stats
