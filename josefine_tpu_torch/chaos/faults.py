"""FaultPlane: seed-deterministic fault injection over a virtual clock.

One object owns every random draw and every armed fault for a chaos run.
Time is the plane's virtual tick (`advance()`), not the wall clock, so a
run is a pure function of its seed: the same seed yields the same fault
schedule, the same message fates, and a byte-identical event log —
"From Consensus to Chaos" (PAPERS.md) catalogs exactly these partition/
delay/duplication classes, and reproducibility is what makes a found
violation debuggable.

Fault classes:

* **network** — per-message drop / duplicate / delay / reorder (probabilistic
  knobs in :class:`NetFaults`), plus directed link blocks and symmetric or
  asymmetric partitions installed by directives.
* **process** — crash/restart directives the driving harness consumes
  (engines are host objects; only the harness can rebuild one).
* **disk** — KV write/fsync errors and torn seglog appends, armed per node
  and delivered through the product hook seams
  (:class:`josefine_tpu.utils.kv.InterceptedKV`, ``broker/log.py`` ``io_hook``,
  ``raft/tcp.py`` interceptors).
* **pacing** — per-node tick skew (a node steps every k-th tick), modeling
  slow disks/hosts without wall-clock sleeps.

Everything the plane does lands in ``self.events`` (structured, virtual-tick
stamped, JSON-serializable) and bumps the ``chaos_*`` metrics counters, so
an operator can see what the nemesis did from the ordinary observability
plane.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass

from josefine_tpu_torch.utils.kv import KV, DiskFault, InterceptedKV
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("chaos.faults")

_m_dropped = REGISTRY.counter("chaos_messages_dropped_total",
                              "Messages dropped by the fault plane")
_m_duplicated = REGISTRY.counter("chaos_messages_duplicated_total",
                                 "Messages duplicated by the fault plane")
_m_delayed = REGISTRY.counter("chaos_messages_delayed_total",
                              "Messages delayed by the fault plane")
_m_blocked = REGISTRY.counter("chaos_messages_blocked_total",
                              "Messages swallowed by a blocked link/partition")
_m_crashes = REGISTRY.counter("chaos_node_crashes_total",
                              "Node crash directives issued")
_m_disk = REGISTRY.counter("chaos_disk_faults_total",
                           "Disk faults injected (KV + seglog)")

#: Sentinel heal tick for "until explicitly healed".
FOREVER = 1 << 62


@dataclass
class NetFaults:
    """Probabilistic background network noise (all drawn from the plane's
    seeded RNG; zero everything for a directive-only run)."""

    drop_p: float = 0.10
    dup_p: float = 0.05
    delay_p: float = 0.20   # conditional on not dropped
    delay_min: int = 1
    delay_max: int = 5
    reorder_p: float = 0.0  # extra 1-tick defer, recorded as a reorder

    @classmethod
    def quiet(cls) -> "NetFaults":
        """No background noise: message fates come only from directives."""
        return cls(drop_p=0.0, dup_p=0.0, delay_p=0.0, reorder_p=0.0)


class FaultPlane:
    """The deterministic fault engine. See module docstring."""

    def __init__(self, seed: int, n_nodes: int, net: NetFaults | None = None,
                 record: bool = True):
        self.seed = seed
        self.n_nodes = n_nodes
        self.net = net or NetFaults()
        self.rng = random.Random(seed)
        self.tick = 0
        self.record = record
        self.events: list[dict] = []
        # Directed link blocks: (src, dst) -> heal tick (FOREVER = manual).
        self.blocked: dict[tuple[int, int], int] = {}
        # Crashed nodes: node -> restart tick (FOREVER = manual restart).
        self.crashed: dict[int, int] = {}
        # Disk fault arming: node -> {kind: (p, until_tick)}.
        self.disk: dict[int, dict[str, tuple[float, int]]] = {}
        # Tick skew: node -> stride (node steps when tick % stride == 0).
        self.skew: dict[int, int] = {}
        # Optional wire plane (chaos/wire.WirePlane): socket-level fates
        # for runs that front the cluster with real Kafka connections.
        # advance() keeps its virtual clock in lockstep; nemesis wire ops
        # arm windows on it (skipped-and-recorded when absent).
        self.wire = None

    # ------------------------------------------------------------- recording

    def _event(self, kind: str, **detail) -> None:
        if self.record:
            self.events.append({"tick": self.tick, "kind": kind, **detail})
        if not kind.startswith("msg_"):
            # Directives (partitions, crashes, disk arms, heals) are rare
            # and operator-relevant: surface them on the tracing plane too.
            # Per-message fates stay in the structured event log only.
            log.debug("tick %d: %s %s", self.tick, kind, detail)

    def event_log_jsonl(self) -> str:
        """The full structured event log, one JSON object per line. Byte-
        identical across runs with the same seed and schedule (nothing
        wall-clock-derived is ever recorded)."""
        return "\n".join(
            json.dumps(e, sort_keys=True, separators=(",", ":"))
            for e in self.events
        ) + ("\n" if self.events else "")

    # ----------------------------------------------------------- virtual time

    def advance(self, n: int = 1) -> list[int]:
        """Advance the virtual clock; expire timed faults. Returns nodes
        whose crash window just expired (the harness rebuilds their
        engines — restart is a host-side operation)."""
        revived: list[int] = []
        for _ in range(n):
            self.tick += 1
            for link, until in list(self.blocked.items()):
                if until <= self.tick:
                    del self.blocked[link]
                    self._event("link_healed", src=link[0], dst=link[1])
            for node, until in list(self.crashed.items()):
                if until <= self.tick:
                    del self.crashed[node]
                    revived.append(node)
                    self._event("node_restarted", node=node)
            for node, arms in list(self.disk.items()):
                for kind, (_p, until) in list(arms.items()):
                    if until <= self.tick:
                        del arms[kind]
                        self._event("disk_fault_disarmed", node=node, fault=kind)
                if not arms:
                    del self.disk[node]
            if self.wire is not None:
                self.wire.sync(self.tick)
        return revived

    def should_tick(self, node: int) -> bool:
        """Tick-skew gate: a skewed node only steps every ``stride`` ticks
        (slow host/disk model — it falls behind in protocol time)."""
        stride = self.skew.get(node, 1)
        return stride <= 1 or self.tick % stride == 0

    def is_down(self, node: int) -> bool:
        return node in self.crashed

    # ------------------------------------------------------------ directives

    def block_link(self, src: int, dst: int, until: int | None = None) -> None:
        """Kill the directed src->dst path (asymmetric loss: dst->src still
        delivers unless blocked separately)."""
        heal = FOREVER if until is None else until
        self.blocked[(src, dst)] = heal
        self._event("link_blocked", src=src, dst=dst,
                    until=None if heal == FOREVER else heal)

    def heal_link(self, src: int, dst: int) -> None:
        if self.blocked.pop((src, dst), None) is not None:
            self._event("link_healed", src=src, dst=dst)

    def partition(self, side_a: list[int], side_b: list[int],
                  until: int | None = None, symmetric: bool = True) -> None:
        """Block every a->b link (and b->a when symmetric)."""
        self._event("partition", a=sorted(side_a), b=sorted(side_b),
                    symmetric=symmetric,
                    until=until)
        for a in side_a:
            for b in side_b:
                if a == b:
                    continue
                heal = FOREVER if until is None else until
                self.blocked[(a, b)] = heal
                if symmetric:
                    self.blocked[(b, a)] = heal

    def isolate(self, node: int, until: int | None = None,
                symmetric: bool = True) -> None:
        """Partition one node away from everyone else."""
        others = [i for i in range(self.n_nodes) if i != node]
        self.partition([node], others, until=until, symmetric=symmetric)

    def heal_all(self) -> None:
        """Drop every network fault and disk arm; leave crashes to expire
        (the harness controls engine rebuilds)."""
        if self.blocked or self.disk or self.skew:
            self._event("heal_all")
        self.blocked.clear()
        self.disk.clear()
        self.skew.clear()
        if self.wire is not None:
            self.wire.heal()

    def crash(self, node: int, until: int | None = None) -> None:
        """Mark a node crashed until ``until`` (virtual tick). The harness
        must honor :meth:`is_down` (stop ticking it, drop its traffic) and
        rebuild the engine when :meth:`advance` reports the revival."""
        if node in self.crashed:
            return
        self.crashed[node] = FOREVER if until is None else until
        _m_crashes.inc()
        self._event("node_crashed", node=node,
                    until=None if until is None else until)

    def restart(self, node: int) -> None:
        """Explicitly lift a crash; the next advance() reports the node."""
        if node in self.crashed:
            self.crashed[node] = self.tick  # expires on next advance

    def arm_disk_fault(self, node: int, kind: str, p: float = 1.0,
                       until: int | None = None) -> None:
        """Arm a disk fault class on a node. Kinds: ``kv_write`` (put/delete
        raises), ``kv_flush`` (fsync fails), ``log_append`` (seglog append
        fails, nothing written), ``log_torn`` (seglog append writes a torn
        prefix then fails), ``log_flush``."""
        assert kind in ("kv_write", "kv_flush", "log_append", "log_torn",
                        "log_flush"), kind
        self.disk.setdefault(node, {})[kind] = (
            p, FOREVER if until is None else until)
        self._event("disk_fault_armed", node=node, fault=kind, p=p,
                    until=until)

    def set_skew(self, node: int, stride: int) -> None:
        """Slow a node down to one step per ``stride`` ticks (1 = normal)."""
        if stride <= 1:
            self.skew.pop(node, None)
        else:
            self.skew[node] = stride
        self._event("skew", node=node, stride=stride)

    # ------------------------------------------------------- message routing

    def link_routable(self, src: int, dst: int) -> bool:
        """Device-routing gate for the RouteFabric (harness.py): a link may
        deliver device-resident ONLY while the plane has no say over its
        messages — no block/partition between the endpoints, both up, the
        receiver not pacer-skewed (its consume cadence would batch routed
        ticks), and NO probabilistic noise armed at all (drop/dup/delay
        fates are drawn per host-routed message; traffic that bypasses
        :meth:`route` must not silently dodge them). Anything else forces
        the traffic back through the host residual path, where the plane
        applies its fates — the partition semantics the nemesis schedules
        are stated against."""
        n = self.net
        if n.drop_p or n.dup_p or n.delay_p or n.reorder_p:
            return False
        return ((src, dst) not in self.blocked
                and src not in self.crashed and dst not in self.crashed
                and self.skew.get(dst, 1) <= 1)

    def route(self, src: int, dst: int, msg) -> list[tuple[int, object]]:
        """Decide one message's fate. Returns ``[(deliver_tick, msg), ...]``
        — empty for a drop, two entries for a duplicate; a ``deliver_tick``
        equal to the current tick means "deliver now". The caller (harness)
        owns actual delivery; the plane only decides and records."""
        if (src, dst) in self.blocked:
            _m_blocked.inc()
            self._event("msg_blocked", src=src, dst=dst)
            return []
        if dst in self.crashed:
            return []  # down receivers just lose traffic; not an event per msg
        fates: list[tuple[int, object]] = []
        n = self.net
        copies = 1
        if n.dup_p and self.rng.random() < n.dup_p:
            copies = 2
            _m_duplicated.inc()
            self._event("msg_duplicated", src=src, dst=dst)
        for _ in range(copies):
            r = self.rng.random()
            if n.drop_p and r < n.drop_p:
                _m_dropped.inc()
                self._event("msg_dropped", src=src, dst=dst)
                continue
            if n.delay_p and r < n.drop_p + n.delay_p:
                d = self.rng.randint(n.delay_min, n.delay_max)
                _m_delayed.inc()
                self._event("msg_delayed", src=src, dst=dst, ticks=d)
                fates.append((self.tick + d, msg))
            elif n.reorder_p and self.rng.random() < n.reorder_p:
                _m_delayed.inc()
                self._event("msg_reordered", src=src, dst=dst)
                fates.append((self.tick + 1, msg))
            else:
                fates.append((self.tick, msg))
        return fates

    # ------------------------------------------------------------ disk hooks

    def _disk_roll(self, node: int, kind: str) -> bool:
        arm = self.disk.get(node, {}).get(kind)
        if arm is None:
            return False
        p, _until = arm
        if self.rng.random() >= p:
            return False
        _m_disk.inc()
        self._event("disk_fault_fired", node=node, fault=kind)
        return True

    def kv_hook(self, node: int):
        """Hook for :class:`InterceptedKV`: fails puts/deletes under
        ``kv_write``, flushes under ``kv_flush``."""
        def hook(op: str, _key: bytes) -> None:
            if op in ("put", "delete") and self._disk_roll(node, "kv_write"):
                raise DiskFault(f"injected KV {op} error (node {node})")
            if op == "flush" and self._disk_roll(node, "kv_flush"):
                raise DiskFault(f"injected KV fsync error (node {node})")
        return hook

    def wrap_kv(self, kv: KV, node: int) -> InterceptedKV:
        """Fault-wrap a node's KV store (only called when chaos is on)."""
        return InterceptedKV(kv, self.kv_hook(node))

    def log_hook(self, node: int):
        """``io_hook`` for :class:`josefine_tpu.broker.log.Log`: append
        errors, torn appends (a deterministic prefix of the blob lands,
        the caller still sees the failure), and failed flushes."""
        def hook(op: str, data: bytes):
            if op == "append":
                # Length guard BEFORE the roll: a 1-byte blob cannot tear,
                # and rolling first would record a fired fault that
                # injected nothing (phantom event in the repro log).
                if len(data) > 1 and self._disk_roll(node, "log_torn"):
                    cut = self.rng.randint(1, len(data) - 1)
                    self._event("torn_append", node=node, wrote=cut,
                                of=len(data))
                    return data[:cut]
                if self._disk_roll(node, "log_append"):
                    raise DiskFault(f"injected seglog append error (node {node})")
            elif op == "flush" and self._disk_roll(node, "log_flush"):
                raise DiskFault(f"injected seglog fsync error (node {node})")
            return None
        return hook

    # ------------------------------------------------ real-socket interceptors

    def transport_send_interceptor(self, node: int):
        """``intercept_send`` for :class:`josefine_tpu.raft.tcp.Transport`.
        Peer ids there are 1-based node ids; the plane indexes 0-based, so
        callers pass the plane node index and an id mapping is applied by
        convention (node id = index + 1, the repo-wide harness layout).
        Applies link blocks and the drop probability (real sockets cannot
        do virtual-tick delays)."""
        def intercept(peer_id: int, _msg) -> bool:
            dst = peer_id - 1
            if (node, dst) in self.blocked or node in self.crashed:
                _m_blocked.inc()
                self._event("msg_blocked", src=node, dst=dst, plane="tcp")
                return False
            if self.net.drop_p and self.rng.random() < self.net.drop_p:
                _m_dropped.inc()
                self._event("msg_dropped", src=node, dst=dst, plane="tcp")
                return False
            return True
        return intercept

    def transport_recv_interceptor(self, node: int):
        """``intercept_recv`` companion: enforces blocks on the receive side
        so an asymmetric partition also stops traffic already in flight."""
        def intercept(msg) -> bool:
            src = getattr(msg, "src", None)
            if src is not None and (src, node) in self.blocked:
                _m_blocked.inc()
                self._event("msg_blocked", src=src, dst=node, plane="tcp-recv")
                return False
            return True
        return intercept
