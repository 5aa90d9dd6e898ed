"""The Raft safety invariants, shared by tests, the soak CLI, and CI.

Extracted from the previously test-private checkers in
``tests/test_chaos.py`` / ``tests/test_node_chaos.py`` so every consumer
enforces ONE implementation:

* **election safety** — at most one leader per (group, term), across the
  whole run (a cross-tick ledger, not a point check);
* **durability** — every client-acknowledged payload survives on every
  node at the end;
* **log matching** — all nodes apply the same FSM sequence per group
  (prefix-closed during chaos, identical after healing);
* **convergence** — after the network heals: one agreed leader, identical
  chain heads/commits, identical FSM logs;
* **linearizability** — acked writes applied exactly once, respecting
  real-time precedence (an ack that happened before another's submission
  must be applied first);
* **replica log contract** (node-level byte logs) — acked records durable,
  first occurrences in ack order, identical bytes across replicas
  (at-least-once is the contract without idempotence, as in Kafka).

Violations raise :class:`InvariantViolation` (an AssertionError, so pytest
suites keep their semantics and the soak tool can catch one type).
"""

from __future__ import annotations


class InvariantViolation(AssertionError):
    """A Raft safety invariant failed under chaos."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise InvariantViolation(msg)


class ElectionSafetyLedger:
    """Cross-tick election-safety bookkeeping: remembers which node won
    each (group, term) and flags any second claimant — including one that
    appears many ticks later (a point-in-time check would miss a stale
    resurgent leader)."""

    def __init__(self):
        self.leaders_by_term: dict[tuple[int, int], int] = {}

    def check(self, live_engines, groups: int) -> None:
        """``live_engines``: iterable of (node_index, engine) for nodes
        currently up. Call every tick."""
        for i, e in live_engines:
            for g in range(groups):
                if e.is_leader(g):
                    key = (g, e.term(g))
                    prev = self.leaders_by_term.setdefault(key, i)
                    _require(prev == i,
                             f"two leaders for group {g} term {key[1]}: "
                             f"{prev} and {i}")


class LeaseSafetyLedger:
    """Tick-denominated leader-lease safety (raft/lease.py), checked every
    tick while the lease lane is armed:

    * **non-overlap** — at most one live engine may hold a valid lease per
      group at any tick, across partitions, elections, recycles and
      migration freezes (two simultaneous holders would both serve
      leader-local reads — split-brain on the read path);
    * **leader exclusion** — while an engine's lease on a group is valid,
      no OTHER live engine may lead the group at a term >= the holder's.
      This is the statement the serve path actually relies on: a valid
      lease means no newer-or-equal term can have committed anywhere, so
      the holder's local committed state is the freshest and a leased read
      is linearizable within the lease window. A *lower*-term leader
      belief is explicitly allowed — a partitioned ex-leader keeps its
      stale ``is_leader`` view until heal (prevote means nothing deposes
      it in isolation), which is harmless: its lease has expired by the
      time the majority elects, so it cannot SERVE (the stale-read probe
      in the harness asserts exactly that refusal every tick).

    The ledger also accumulates coverage telemetry (``held_ticks``,
    ``handovers``) so a soak summary can show the lease lane actually
    exercised grants and expiries, not just vacuous emptiness."""

    def __init__(self):
        self.held_ticks = 0     # (tick, group) pairs with a valid holder
        self.handovers = 0      # holder changed group-to-group across ticks
        self._last_holder: dict[int, int] = {}

    def check(self, live_engines, groups: int, tick: int,
              row_of=None) -> None:
        """``live_engines``: iterable of (node_index, engine) for nodes
        currently up; ``row_of`` maps a logical group to its owning engine
        row (identity when the migration plane is off)."""
        engines = dict(live_engines)
        for g in range(groups):
            row = row_of(g) if row_of is not None else g
            holders = [i for i, e in live_engines if e.lease_valid(row)]
            _require(len(holders) <= 1,
                     f"lease overlap on group {g} (row {row}) at tick "
                     f"{tick}: holders {holders}")
            if not holders:
                # Keep the last holder across the gap: every safe handover
                # goes through a no-holder window (leases never overlap),
                # and the handover count is about holder IDENTITY changing,
                # not tick adjacency.
                continue
            h = holders[0]
            ht = engines[h].term(row)
            usurpers = [i for i, e in live_engines
                        if i != h and e.is_leader(row) and e.term(row) >= ht]
            _require(not usurpers,
                     f"leader exclusion violated on group {g} (row {row}) "
                     f"at tick {tick}: node {h} holds a valid lease at term "
                     f"{ht} while {usurpers} lead at >= that term")
            self.held_ticks += 1
            prev = self._last_holder.get(g)
            if prev is not None and prev != h:
                self.handovers += 1
            self._last_holder[g] = h


def check_log_matching(logs_per_group: dict[int, list[list[bytes]]]) -> None:
    """``logs_per_group[g]`` = each live node's applied-FSM sequence for
    group g. All pairs must be prefix-compatible (divergence at any index
    breaks the log-matching property)."""
    for g, logs in logs_per_group.items():
        for a in logs:
            for b in logs:
                n = min(len(a), len(b))
                _require(a[:n] == b[:n],
                         f"divergent FSM sequences in group {g}")


def check_durability(acked: list[bytes], applied: list[bytes], group: int) -> None:
    """Every acked payload must appear in the (converged) applied log."""
    applied_set = set(applied)
    for payload in acked:
        _require(payload in applied_set,
                 f"acked payload {payload!r} lost after chaos (group {group})")


def check_linearizable(acked: list[bytes], applied: list[bytes],
                       submit_tick: dict[bytes, int],
                       ack_tick: dict[bytes, int], group: int) -> None:
    """Client-visible linearizability for the log FSM. Payloads are unique,
    every write goes through Raft commit, and the applied sequence IS the
    serialization — so linearizability reduces to (1) every acked payload
    applied exactly once, and (2) real-time precedence: a payload acked
    before another was even *submitted* must precede it in the applied
    order. Tick bounds are conservative (the recorded ack tick is the
    harvest tick, >= the true completion), so every pair this compares is a
    genuine happened-before — no false positives under reordering."""
    idx: dict[bytes, list[int]] = {}
    for i, p in enumerate(applied):
        idx.setdefault(p, []).append(i)
    for p in acked:
        _require(len(idx.get(p, ())) == 1,
                 f"acked payload {p!r} applied {len(idx.get(p, ()))}x "
                 f"(group {group})")
    for a in acked:
        for b in acked:
            if ack_tick[a] < submit_tick[b]:
                _require(idx[a][0] < idx[b][0],
                         f"real-time order violated (group {group}): {a!r} "
                         f"acked at tick {ack_tick[a]}, before {b!r} was "
                         f"submitted at tick {submit_tick[b]}, yet applies "
                         f"later")


def check_converged(engines_by_node, fsm_logs_by_node, acked: list[bytes],
                    submit_tick: dict[bytes, int], ack_tick: dict[bytes, int],
                    group: int) -> None:
    """The post-heal epilogue for one group: single agreed leader,
    identical chains and FSM logs, then durability + linearizability.
    ``engines_by_node``: list of (node_index, engine); ``fsm_logs_by_node``:
    the same nodes' applied sequences for this group."""
    leads = [i for i, e in engines_by_node if e.is_leader(group)]
    _require(len(leads) == 1, f"group {group}: leaders {leads}")
    heads = {e.chains[group].head for _, e in engines_by_node}
    commits = {e.chains[group].committed for _, e in engines_by_node}
    _require(len(heads) == 1 and len(commits) == 1,
             f"group {group} failed to converge: heads={heads} "
             f"commits={commits}")
    logs = fsm_logs_by_node
    _require(all(l == logs[0] for l in logs), f"group {group} logs differ")
    check_durability(acked, logs[0], group)
    check_linearizable(acked, logs[0], submit_tick, ack_tick, group)


def check_migration_state(cluster) -> None:
    """Migration-state invariant, called every tick while the migration
    plane is armed. While a migration is IN FLIGHT:

    * **freeze coverage** — every live engine holds the source row frozen
      (the dual-ownership window never admits a source-side mint);
    * **fence finality** — no node's source-row applied sequence carries a
      client payload after its first fence (the fence is the LAST source
      entry; anything later would be a write the target's carried prefix
      silently drops);
    * **fence opacity** — fence payloads never surface as client acks.

    ``cluster`` duck-type: ``migrator``, ``live_nodes()``, ``engines``,
    ``fsms``, ``acked``."""
    from josefine_tpu_torch.raft.migration import is_migration_fence
    m = cluster.migrator.mig
    if m is not None:
        src, fence = m["src"], m["fence"]
        for i in cluster.live_nodes():
            _require(cluster.engines[i].group_frozen(src),
                     f"migration {m['id']}: source row {src} not frozen "
                     f"on live node {i}")
            applied = cluster.fsms[i][src].applied
            if fence in applied:
                tail = applied[applied.index(fence) + 1:]
                stray = [p for p in tail if not is_migration_fence(p)]
                _require(not stray,
                         f"migration {m['id']}: node {i} applied client "
                         f"payloads {stray[:3]!r} after the fence on "
                         f"source row {src}")
    for g, payloads in cluster.acked.items():
        fences = [p for p in payloads if is_migration_fence(p)]
        _require(not fences,
                 f"migration fence acked as a client write on stream {g}: "
                 f"{fences[:3]!r}")


def check_migration_resolved(migrator) -> None:
    """Epilogue gate: after healing, no migration may still be in flight —
    the coordinator must have rolled it forward (cutover) or back (abort)
    to a single owner."""
    m = migrator.mig
    _require(m is None,
             f"migration {m and m['id']} unresolved after heal: "
             f"stream {m and m['stream']} still in the dual-ownership "
             f"window (src={m and m['src']}, dst={m and m['dst']}, "
             f"adopted={sorted(m['adopted']) if m else []})")


def duplicate_acked_count(acked: list[bytes], applied: list[bytes]) -> int:
    """Idempotent-produce verdict helper: how many ACKED payloads appear
    more than once in the applied log. The engine-level chaos/wire soaks
    promise exactly-once for acked client writes even across retry storms
    (retries re-propose under fresh payloads), so the expected count is 0;
    the soak summary records the measured verdict so a regression in the
    retry plumbing surfaces as a nonzero ``dup_acked`` instead of passing
    silently."""
    from collections import Counter
    counts = Counter(applied)
    return sum(1 for p in sorted(set(acked)) if counts.get(p, 0) > 1)


def check_replica_log_contract(per_node_bytes: list[bytes],
                               acked: list[bytes], part: int,
                               payload_pattern: bytes | None = None) -> None:
    """Node-level (whole-stack) contract over raw partition log bytes:
    identical across replicas; every acked record present with first
    occurrences in ack order. At-least-once is the contract (a timed-out
    attempt can commit and its retry commit again; Kafka without
    idempotence is the same) — every ACK must be durable, and first
    occurrences must respect ack order for a sequential producer."""
    first = per_node_bytes[0]
    if not all(d == first for d in per_node_bytes):
        detail = ""
        if payload_pattern is not None:
            import re
            orders = [re.findall(payload_pattern, d) for d in per_node_bytes]
            detail = f": orders={orders}"
        raise InvariantViolation(
            f"partition {part}: replica logs diverge "
            f"({[len(d) for d in per_node_bytes]} bytes){detail}")
    pos = -1
    for payload in acked:
        at = first.find(payload)
        _require(at != -1, f"ACKED record {payload!r} lost (p{part})")
        _require(at > pos, f"record {payload!r} out of ack order (p{part})")
        pos = at
