"""Nemesis: named, composable, JSON-serializable fault schedules.

A :class:`Schedule` is a list of virtual-tick-stamped steps — the repro
artifact for a chaos run (``Schedule.to_json()`` + the run seed fully
determine the fault history). A :class:`Nemesis` replays a schedule into a
:class:`josefine_tpu.chaos.faults.FaultPlane` as the harness's clock
advances, resolving dynamic targets ("the current leader of group 0")
against the live cluster at apply time.

Step ops (the DSL):

``block_link {src,dst,for}``        directed link loss
``heal_link {src,dst}``
``partition {a,b,for,symmetric}``   group A <-/-> group B
``isolate {node|target,for,symmetric,group}``  one node vs everyone
``heal_all {}``
``crash {node|target,for,group}``   whole-node crash (+auto restart)
``restart {node}``
``disk {node|target,fault,p,for,group}``  arm a disk fault class
``skew {node|target,stride}``       slow a node's pacer

``node`` is a 0-based index; ``target`` may be ``"leader"`` or
``"follower"`` (resolved per group at apply time; unresolvable targets are
skipped and recorded, never fatal — a leaderless tick simply has no leader
to shoot).

Wire-plane ops (applied to the plane's attached
:class:`josefine_tpu.chaos.wire.WirePlane`; on an in-process soak, which
has no wire plane, they are skipped-and-recorded like an unresolvable
target):

``conn_reset {role,p,for}``    matching connections reset once per window
``conn_stall {role,for}``      matching connections black-hole their I/O
``torn_frames {role,p,for}``   writes tear at seeded split points
``accept_refuse {for}``        the broker accept path refuses connections

``role`` scopes a wire fault to ``"client"`` (the wire driver's sockets),
``"broker"`` (the broker's side of accepted connections), or ``"any"``.

The bundled schedules (:data:`SCHEDULES`) cover the classic nemeses:
``leader-partition``, ``minority-partition``, ``flapping-link``,
``slow-disk``, ``crash-loop``, ``skewed-pacer``. Every one must pass the
full invariant suite — ``tools/chaos_soak.py`` enforces that, and the CI
smoke runs one end-to-end.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from josefine_tpu_torch.chaos.faults import FaultPlane

#: Wire-plane ops: they arm fate windows on the FaultPlane's attached
#: WirePlane (chaos/wire.py) instead of touching the message plane.
WIRE_OPS = ("conn_reset", "conn_stall", "torn_frames", "accept_refuse")

#: Migration ops: they drive the cluster's MigrationCoordinator (live
#: group handoff between engine rows) instead of the fault plane. On a
#: cluster without the migration plane armed — or when the coordinator
#: declines (migration already in flight, stream out of range, nothing to
#: abort) — they are skipped-and-recorded like an unresolvable target.
MIGRATION_OPS = ("migrate", "migrate_abort")

_OPS = ("block_link", "heal_link", "partition", "isolate", "heal_all",
        "crash", "restart", "disk", "skew") + WIRE_OPS + MIGRATION_OPS

#: Connection roles a wire op may scope to.
ROLES = ("client", "broker", "any")

#: Disk fault classes arm_disk_fault accepts (mirrored here so the DSL
#: boundary can reject a bad ``fault`` before a soak ever starts).
DISK_FAULTS = ("kv_write", "kv_flush", "log_append", "log_torn", "log_flush")

#: Dynamic targets _resolve understands.
TARGETS = ("leader", "follower")

#: Per-op argument catalog: the single source of truth for BOTH schedule
#: validation (Schedule.validate / from_json — mutation can generate
#: garbage, and the boundary must reject it loudly instead of failing deep
#: inside Nemesis.apply mid-soak) and the search mutator's generative
#: grammar (chaos/search.py draws ops and args from this table).
OP_ARGS: dict[str, dict[str, tuple[str, ...]]] = {
    "block_link": {"required": ("src", "dst"), "optional": ("for",)},
    "heal_link":  {"required": ("src", "dst"), "optional": ()},
    "partition":  {"required": ("a", "b"),
                   "optional": ("for", "symmetric")},
    "isolate":    {"required": (),
                   "optional": ("node", "target", "for", "symmetric",
                                "group")},
    "heal_all":   {"required": (), "optional": ()},
    "crash":      {"required": (), "optional": ("node", "target", "for",
                                                "group")},
    "restart":    {"required": ("node",), "optional": ()},
    "disk":       {"required": ("fault",),
                   "optional": ("node", "target", "p", "for", "group")},
    "skew":       {"required": ("stride",),
                   "optional": ("node", "target", "group")},
    "conn_reset":    {"required": (), "optional": ("role", "p", "for")},
    "conn_stall":    {"required": ("for",), "optional": ("role",)},
    "torn_frames":   {"required": ("for",), "optional": ("role", "p")},
    "accept_refuse": {"required": ("for",), "optional": ()},
    "migrate":       {"required": (), "optional": ("stream",)},
    "migrate_abort": {"required": (), "optional": ()},
}


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _check_arg(name: str, v) -> str | None:
    """One argument's domain check; returns an error string or None."""
    if name in ("src", "dst", "node", "group", "stream"):
        if not _is_int(v) or v < 0:
            return f"{name}={v!r} must be a node/group index >= 0"
    elif name in ("a", "b"):
        if (not isinstance(v, (list, tuple)) or not v
                or not all(_is_int(x) and x >= 0 for x in v)):
            return f"{name}={v!r} must be a non-empty list of node indices"
    elif name == "for":
        if not _is_int(v) or v < 1:
            return f"for={v!r} must be a duration >= 1 tick"
    elif name == "p":
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not 0.0 <= float(v) <= 1.0:
            return f"p={v!r} must be a probability in [0, 1]"
    elif name == "stride":
        if not _is_int(v) or v < 1:
            return f"stride={v!r} must be an integer >= 1"
    elif name == "fault":
        if v not in DISK_FAULTS:
            return f"fault={v!r} not one of {DISK_FAULTS}"
    elif name == "target":
        if v not in TARGETS:
            return f"target={v!r} not one of {TARGETS}"
    elif name == "role":
        if v not in ROLES:
            return f"role={v!r} not one of {ROLES}"
    elif name == "symmetric":
        if not isinstance(v, bool):
            return f"symmetric={v!r} must be a bool"
    return None


def validate_step(index: int, at, op, args: dict,
                  n_nodes: int | None = None) -> None:
    """Validate one raw (at, op, args) triple, raising :class:`ValueError`
    that names the offending step index — the loud boundary between the
    schedule DSL (which mutation and operators hand us) and the soak."""
    def bad(msg: str):
        raise ValueError(f"schedule step {index}: {msg}")

    if not _is_int(at) or at < 0:
        bad(f"negative or non-integer at={at!r}")
    if op not in _OPS:
        bad(f"unknown op {op!r} (known: {', '.join(_OPS)})")
    spec = OP_ARGS[op]
    known = set(spec["required"]) | set(spec["optional"])
    for name in sorted(args):
        if name not in known:
            bad(f"op {op!r} does not take arg {name!r} "
                f"(takes: {', '.join(sorted(known)) or 'nothing'})")
        err = _check_arg(name, args[name])
        if err:
            bad(f"op {op!r}: {err}")
    for name in spec["required"]:
        if name not in args:
            bad(f"op {op!r} missing required arg {name!r}")
    if n_nodes is not None:
        for name in ("src", "dst", "node"):
            if name in args and args[name] >= n_nodes:
                bad(f"{name}={args[name]} out of range for "
                    f"{n_nodes}-node cluster")
        for name in ("a", "b"):
            for x in args.get(name, ()):
                if x >= n_nodes:
                    bad(f"{name} contains node {x}, out of range for "
                        f"{n_nodes}-node cluster")


@dataclass
class Step:
    at: int
    op: str
    args: dict = field(default_factory=dict)

    def __post_init__(self):
        assert self.op in _OPS, f"unknown nemesis op {self.op!r}"


@dataclass
class Schedule:
    """A named fault plan: steps over a run of ``horizon`` chaos ticks,
    then ``heal_ticks`` of clean network to convergence."""

    name: str
    steps: list[Step]
    horizon: int
    heal_ticks: int = 140

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "horizon": self.horizon,
            "heal_ticks": self.heal_ticks,
            "steps": [{"at": s.at, "op": s.op, **s.args} for s in self.steps],
        }, sort_keys=True, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Schedule":
        """Parse and VALIDATE the DSL. A malformed step — unknown op,
        negative at, unknown/ill-typed/missing args — raises a
        :class:`ValueError` naming the step index, instead of surfacing as
        a KeyError/TypeError deep inside ``Nemesis.apply`` mid-soak."""
        d = json.loads(text)
        if not isinstance(d.get("steps"), list):
            raise ValueError("schedule JSON needs a 'steps' list")
        steps = []
        for i, raw in enumerate(d["steps"]):
            if not isinstance(raw, dict):
                raise ValueError(f"schedule step {i}: not an object")
            raw = dict(raw)
            at, op = raw.pop("at", None), raw.pop("op", None)
            validate_step(i, at, op, raw)
            steps.append(Step(at=at, op=op, args=raw))
        sched = cls(name=d["name"], steps=steps, horizon=d["horizon"],
                    heal_ticks=d.get("heal_ticks", 140))
        return sched.validate()

    def validate(self, n_nodes: int | None = None) -> "Schedule":
        """Whole-schedule validation (every step via :func:`validate_step`,
        plus horizon/heal bounds and — when ``n_nodes`` is given — node
        ranges). Returns self, so builders can end with ``.validate()``."""
        if not _is_int(self.horizon) or self.horizon < 1:
            raise ValueError(f"schedule horizon={self.horizon!r} "
                             "must be an integer >= 1")
        if not _is_int(self.heal_ticks) or self.heal_ticks < 0:
            raise ValueError(f"schedule heal_ticks={self.heal_ticks!r} "
                             "must be an integer >= 0")
        for i, s in enumerate(self.steps):
            validate_step(i, s.at, s.op, s.args, n_nodes=n_nodes)
        return self

    def then(self, other: "Schedule", gap: int = 40) -> "Schedule":
        """Compose sequentially: other's steps shifted past this horizon."""
        shifted = [Step(at=s.at + self.horizon + gap, op=s.op,
                        args=dict(s.args)) for s in other.steps]
        return Schedule(
            name=f"{self.name}+{other.name}",
            steps=self.steps + shifted,
            horizon=self.horizon + gap + other.horizon,
            heal_ticks=max(self.heal_ticks, other.heal_ticks),
        )


class Nemesis:
    """Replays a schedule into a fault plane against a live cluster.

    ``cluster`` only needs two lookups for dynamic targets:
    ``leader_node(group) -> node index | None`` and
    ``live_nodes() -> list[int]``.
    """

    def __init__(self, schedule: Schedule, plane: FaultPlane, cluster=None):
        self.schedule = schedule
        self.plane = plane
        self.cluster = cluster
        # Steps whose dynamic target did not resolve at apply time (e.g.
        # "leader" during a leaderless window): skipped-and-recorded per
        # the module contract, and surfaced in the soak summary so a
        # search scorer can see a candidate's wasted steps.
        self.skipped: list[dict] = []
        self._by_tick: dict[int, list[Step]] = {}
        for s in schedule.steps:
            self._by_tick.setdefault(s.at, []).append(s)

    def done(self) -> bool:
        return self.plane.tick >= self.schedule.horizon

    def apply(self) -> None:
        """Apply every step scheduled at the plane's current tick. Call once
        per harness tick, right after the clock advances."""
        for step in self._by_tick.get(self.plane.tick, ()):
            self._apply(step)

    # ------------------------------------------------------------- internals

    def _resolve(self, args: dict) -> int | None:
        if "node" in args:
            return int(args["node"])
        target = args.get("target", "leader")
        group = int(args.get("group", 0))
        if self.cluster is None:
            return None
        leader = self.cluster.leader_node(group)
        if target == "leader":
            return leader
        if target == "follower":
            for i in self.cluster.live_nodes():
                if i != leader:
                    return i
        return None

    def _until(self, args: dict) -> int | None:
        dur = args.get("for")
        return None if dur is None else self.plane.tick + int(dur)

    def _apply(self, step: Step) -> None:
        p, a = self.plane, step.args
        if step.op in MIGRATION_OPS:
            coord = getattr(self.cluster, "migrator", None)
            ok = False
            if coord is not None:
                if step.op == "migrate":
                    ok = coord.begin(int(a.get("stream", 1)))
                else:
                    ok = coord.abort()
            if not ok:
                # No migration plane on this cluster, or the coordinator
                # declined (one-in-flight rule / pinned stream / nothing
                # to abort): skip-and-record so a mutated genome carrying
                # migration ops stays runnable everywhere.
                p._event("nemesis_skipped", op=step.op, at=step.at)
                self.skipped.append({"at": step.at, "op": step.op,
                                     "target": "migration"})
            return
        if step.op in WIRE_OPS:
            wire = getattr(p, "wire", None)
            if wire is None:
                # In-process soaks have no wire plane: skip-and-record,
                # exactly like an unresolvable dynamic target, so a search
                # genome carrying wire ops stays runnable everywhere.
                p._event("nemesis_skipped", op=step.op, at=step.at)
                self.skipped.append({"at": step.at, "op": step.op,
                                     "target": a.get("role", "any")})
                return
            until = self._until(a)
            end = p.tick + 1 if until is None else until
            wire.arm(step.op, role=a.get("role", "any"),
                     p=float(a.get("p", 1.0)), until=end)
            p._event("wire_armed", fault=step.op,
                     role=a.get("role", "any"), p=float(a.get("p", 1.0)),
                     until=end)
            return
        if step.op == "block_link":
            p.block_link(int(a["src"]), int(a["dst"]), until=self._until(a))
        elif step.op == "heal_link":
            p.heal_link(int(a["src"]), int(a["dst"]))
        elif step.op == "partition":
            p.partition(list(a["a"]), list(a["b"]), until=self._until(a),
                        symmetric=bool(a.get("symmetric", True)))
        elif step.op == "heal_all":
            p.heal_all()
        elif step.op in ("isolate", "crash", "disk", "skew"):
            node = self._resolve(a)
            if node is None:
                p._event("nemesis_skipped", op=step.op, at=step.at)
                self.skipped.append({"at": step.at, "op": step.op,
                                     "target": a.get("target", "leader")})
                return
            if step.op == "isolate":
                p.isolate(node, until=self._until(a),
                          symmetric=bool(a.get("symmetric", True)))
            elif step.op == "crash":
                p.crash(node, until=self._until(a))
            elif step.op == "disk":
                p.arm_disk_fault(node, a["fault"], p=float(a.get("p", 1.0)),
                                 until=self._until(a))
            elif step.op == "skew":
                p.set_skew(node, int(a["stride"]))
        elif step.op == "restart":
            p.restart(int(a["node"]))


# --------------------------------------------------------- bundled schedules

def leader_partition(n_nodes: int = 3) -> Schedule:
    """Repeatedly cut the CURRENT leader off (symmetric): the classic
    "deposed leader must step down, cluster must re-elect" nemesis."""
    steps = [Step(at=t, op="isolate", args={"target": "leader", "for": 45})
             for t in (60, 170, 280)]
    return Schedule("leader-partition", steps, horizon=380)


def minority_partition(n_nodes: int = 3) -> Schedule:
    """Wall off a minority (last node): the majority side must keep
    committing; the minority must never elect."""
    minority = [n_nodes - 1]
    majority = list(range(n_nodes - 1))
    steps = [
        Step(at=50, op="partition", args={"a": minority, "b": majority, "for": 70}),
        Step(at=200, op="partition", args={"a": minority, "b": majority, "for": 70}),
    ]
    return Schedule("minority-partition", steps, horizon=330)


def flapping_link(n_nodes: int = 3) -> Schedule:
    """One asymmetric link (0 -> 1) flaps every 20 ticks: the receiver
    hears heartbeats, the sender never hears responses — sustained one-way
    loss a random drop rate cannot model."""
    steps = [Step(at=t, op="block_link", args={"src": 0, "dst": 1, "for": 10})
             for t in range(40, 280, 20)]
    return Schedule("flapping-link", steps, horizon=320)


def slow_disk(n_nodes: int = 3) -> Schedule:
    """A follower's storage turns slow (stride-3 pacer skew: it steps one
    tick in three, falling behind in protocol time), then recovers and must
    catch back up without a term bump from its stale view."""
    steps = [
        Step(at=50, op="skew", args={"node": 1, "stride": 3}),
        Step(at=220, op="skew", args={"node": 1, "stride": 1}),
    ]
    return Schedule("slow-disk", steps, horizon=300)


def crash_loop(n_nodes: int = 3) -> Schedule:
    """Rolling whole-node crash/restart: every 70 ticks another node dies
    for 25 (fresh engine over the same durable KV on revival)."""
    steps = [Step(at=50 + 70 * i, op="crash",
                  args={"node": i % n_nodes, "for": 25})
             for i in range(4)]
    return Schedule("crash-loop", steps, horizon=380)


def skewed_pacer(n_nodes: int = 3) -> Schedule:
    """Every node ticks at a different rate for a stretch (strides 1/2/3):
    timeout math must stay safe when protocol time itself is skewed."""
    steps = [
        Step(at=40, op="skew", args={"node": 1, "stride": 2}),
        Step(at=40, op="skew", args={"node": 2, "stride": 3}),
        Step(at=200, op="skew", args={"node": 1, "stride": 1}),
        Step(at=200, op="skew", args={"node": 2, "stride": 1}),
    ]
    return Schedule("skewed-pacer", steps, horizon=300)


SCHEDULES = {
    "leader-partition": leader_partition,
    "minority-partition": minority_partition,
    "flapping-link": flapping_link,
    "slow-disk": slow_disk,
    "crash-loop": crash_loop,
    "skewed-pacer": skewed_pacer,
}


# ---------------------------------------------------- bundled wire schedules
#
# Kept OUT of SCHEDULES: the in-process search bootstraps and picks parents
# from sorted(SCHEDULES), and growing that dict would shift its seeded
# parent draws (breaking the committed corpus/search-log determinism
# contract). Wire-mode search uses this catalog instead.

def wire_storm(n_nodes: int = 1) -> Schedule:
    """The canonical wire nemesis: client connections reset and tear frames
    in waves while the accept path flaps — the client retry/backoff and the
    broker torn-frame path both get exercised, then everything heals."""
    steps = [
        Step(at=10, op="torn_frames", args={"role": "client", "p": 0.7,
                                            "for": 30}),
        Step(at=25, op="conn_reset", args={"role": "client", "p": 1.0,
                                           "for": 4}),
        # Reset right before the accept window: the reconnect lands on a
        # refusing accept path and must back off through it.
        Step(at=44, op="conn_reset", args={"role": "client", "p": 1.0,
                                           "for": 3}),
        Step(at=45, op="accept_refuse", args={"for": 10}),
        Step(at=60, op="torn_frames", args={"role": "broker", "p": 0.6,
                                            "for": 25}),
        Step(at=75, op="conn_reset", args={"role": "any", "p": 0.8,
                                           "for": 4}),
    ]
    return Schedule("wire-storm", steps, horizon=110, heal_ticks=40)


def wire_stall(n_nodes: int = 1) -> Schedule:
    """Black-hole stalls: connections hang mid-protocol until the client's
    per-request deadline trips and the reconnect-with-resume path runs."""
    steps = [
        Step(at=15, op="conn_stall", args={"role": "client", "for": 20}),
        Step(at=55, op="conn_stall", args={"role": "broker", "for": 15}),
        Step(at=80, op="conn_reset", args={"role": "client", "for": 3}),
    ]
    return Schedule("wire-stall", steps, horizon=110, heal_ticks=40)


def wire_leader_partition(n_nodes: int = 3) -> Schedule:
    """The acceptance stack: a leader partition on the consensus plane
    UNDER connection resets and torn frames on the Kafka wire — the two
    fault planes compose, and every acked produce must still be durable
    and readable after heal."""
    steps = [
        Step(at=12, op="torn_frames", args={"role": "any", "p": 0.5,
                                            "for": 40}),
        Step(at=20, op="isolate", args={"target": "leader", "for": 25}),
        Step(at=30, op="conn_reset", args={"role": "client", "p": 1.0,
                                           "for": 4}),
        Step(at=70, op="conn_reset", args={"role": "any", "p": 0.7,
                                           "for": 4}),
        Step(at=80, op="accept_refuse", args={"for": 8}),
    ]
    return Schedule("wire-leader-partition", steps, horizon=130,
                    heal_ticks=60)


def wire_reconnect_loss(n_nodes: int = 3) -> Schedule:
    """Reconnect-window block-batch loss — the schedule class that hunts
    the neighborhood of the windowed nack-repair wedge (found by the
    wire-plane PR, fixed engine-side in ``packed_step._merge_outbox``;
    pinned by tests/test_raft_server.py::
    test_windowed_nack_repair_over_sockets). Short REPEATED raft-plane
    cuts mean block-bearing AE batches are repeatedly minted into a
    transport dial's reconnect window and lost to the newest-wins
    mailbox, so the NACK -> rewind -> re-send repair must run again and
    again under window folding; client-plane resets compose so the
    Kafka socket layer reconnects through the same storm. The scored
    axis is liveness: commits must resume inside the probe window after
    every heal (pre-fix, this class starves commits forever)."""
    steps = []
    # Five cut/heal rounds at a cadence near the fold window: each heal
    # is a fresh dial whose reconnect backoff swallows the next block
    # batches, re-arming the loss the NACK path must repair.
    for i in range(5):
        at = 14 + 16 * i
        steps.append(Step(at=at, op="isolate",
                          args={"target": "leader", "for": 7}))
        if i % 2:
            steps.append(Step(at=at + 4, op="conn_reset",
                              args={"role": "client", "p": 1.0, "for": 3}))
    steps.append(Step(at=100, op="torn_frames",
                      args={"role": "any", "p": 0.4, "for": 15}))
    return Schedule("wire-reconnect-loss", steps, horizon=140,
                    heal_ticks=60)


WIRE_SCHEDULES = {
    "wire-storm": wire_storm,
    "wire-stall": wire_stall,
    "wire-leader-partition": wire_leader_partition,
    "wire-reconnect-loss": wire_reconnect_loss,
}


# ----------------------------------------------- bundled migration schedules
#
# Kept OUT of SCHEDULES for the same determinism reason as the wire
# catalog: the search bootstraps from sorted(SCHEDULES), and growing that
# dict would shift every committed corpus's seeded parent draws. Migration
# search mode merges this catalog in explicitly (chaos/search.py), and the
# soak CLIs resolve these names only alongside --migration. Stream 0 is
# never migrated (pinned to the metadata row — the coordinator refuses it),
# so the builders target stream 1, the first migratable stream on the
# default 2-stream soak shape.

def migrate_leader_partition(n_nodes: int = 3) -> Schedule:
    """The tentpole race: a live migration begins, then the SOURCE row's
    leader is cut off mid-handoff — the fence must re-propose on the new
    leader and the cutover roll forward; a second migration after heal
    moves the stream again (the freed source is the new spare), proving
    the row pool stays coherent across repeated handoffs."""
    steps = [
        Step(at=40, op="migrate", args={"stream": 1}),
        Step(at=55, op="isolate", args={"target": "leader", "group": 1,
                                        "for": 40}),
        Step(at=180, op="migrate", args={"stream": 1}),
    ]
    return Schedule("migrate-leader-partition", steps, horizon=320)


def migrate_under_election(n_nodes: int = 3) -> Schedule:
    """Leader crash right as the migration freezes the source: the fence
    must commit through the ensuing election, and a repeat round crashes
    the leader again mid-adoption — both resolve to a single owner."""
    steps = [
        Step(at=40, op="migrate", args={"stream": 1}),
        Step(at=42, op="crash", args={"target": "leader", "group": 1,
                                      "for": 25}),
        Step(at=170, op="migrate", args={"stream": 1}),
        Step(at=172, op="crash", args={"target": "leader", "group": 1,
                                       "for": 25}),
    ]
    return Schedule("migrate-under-election", steps, horizon=300)


def migrate_abort(n_nodes: int = 3) -> Schedule:
    """Abort path: a migration is rolled BACK mid-handoff (source stays
    the single owner, the adopted target rows recycle), then a fresh
    migration of the same stream runs to cutover — the aborted target
    row's stale life must be invisible to the new one."""
    steps = [
        Step(at=40, op="migrate", args={"stream": 1}),
        # Two ticks in: the fence is proposed but the handoff has not
        # reached quorum adoption — the abort lands mid-flight, not on an
        # already-resolved migration.
        Step(at=42, op="migrate_abort", args={}),
        Step(at=120, op="migrate", args={"stream": 1}),
    ]
    return Schedule("migrate-abort", steps, horizon=300)


MIGRATION_SCHEDULES = {
    "migrate-leader-partition": migrate_leader_partition,
    "migrate-under-election": migrate_under_election,
    "migrate-abort": migrate_abort,
}


# --------------------------------------------------- bundled lease schedules
#
# Kept OUT of SCHEDULES for the same determinism reason as the wire and
# migration catalogs (the search bootstraps from sorted(SCHEDULES)). Lease
# search mode merges this catalog in explicitly, and the soak CLIs resolve
# these names only alongside --leases. Lease soundness is scoped to the
# lockstep pacer and a non-duplicating transport (see raft/lease.py), so
# these builders never emit "skew" ops and lease soaks run with dup_p=0 —
# a duplicated APPEND_RESP is byte-identical to the next idle-heartbeat
# ack and would over-credit the evidence window.

def lease_expiry_under_partition(n_nodes: int = 3) -> Schedule:
    """The stale-read nemesis: the lease-holding leader is cut off
    (symmetric) for LONGER than the lease window — its lease must expire
    in place and leased reads flip to refusals BEFORE the majority side
    can elect (the non-overlap margin); after heal the deposed node
    rejoins, a fresh lease is granted, and a second round repeats the
    hand-off to prove re-grant after expiry. The 50-tick cuts dwarf
    timeout_min=4, so both rounds force a genuine expiry + re-election
    rather than a renewal blip."""
    steps = [Step(at=t, op="isolate", args={"target": "leader", "for": 50})
             for t in (60, 180)]
    return Schedule("lease-expiry-under-partition", steps, horizon=320)


LEASE_SCHEDULES = {
    "lease-expiry-under-partition": lease_expiry_under_partition,
}
