"""Coverage-guided chaos search: mutate nemesis schedules, score by
signature novelty, keep minimized repros.

"From Consensus to Chaos" (arxiv 2601.00273) argues Raft's interesting
failures live in *searched-for* fault schedules, not hand-written
classics. This module closes that loop over the pieces already in-tree:

* the **genome** is a :class:`Genome` — a nemesis :class:`Schedule` (the
  JSON step DSL of :mod:`~josefine_tpu.chaos.nemesis`) plus, optionally,
  the workload traffic knobs of
  :mod:`~josefine_tpu.workload.genome` (skew, churn, offered load,
  inflight pressure) — because the traffic shape co-determines what a
  fault schedule exercises;
* **mutation** (:class:`Mutator`) draws from the op catalog
  (``nemesis.OP_ARGS``): insert/delete/retime/retarget steps, perturb
  ``for``/``p``/``stride`` args, splice two corpus schedules at a cut
  tick, jitter the horizon, and mutate one workload knob;
* **scoring** runs every candidate through
  :func:`~josefine_tpu.chaos.soak.run_soak` and scores the run's
  :class:`~josefine_tpu.utils.coverage.CoverageMap` by
  :meth:`~josefine_tpu.utils.coverage.CoverageMap.novelty` against the
  corpus union — a candidate is admitted iff it covers features the
  corpus has never seen;
* the **corpus** (:class:`Corpus`) is a directory of
  ``{schedule, workload, seed, signature, class_counts, features}`` JSON
  entries (``tests/fixtures/chaos_corpus/`` ships a committed seed set).
  It is resumable — entries carry their covered-feature keys, so a fresh
  process rebuilds the exact union without re-running anything — and
  bounded: when over cap, stale lineages (search entries whose every
  feature is covered elsewhere) are retired, oldest first;
* any **invariant trip** runs :func:`ddmin` (delta debugging over the
  schedule's steps, one full soak per probe — determinism makes each
  probe exact) and keeps the minimized schedule + seed + soak config as
  a replayable repro JSON (``tools/chaos_search.py --replay`` re-runs it
  under the RECORDED seed and soak config, exit 0 iff the violation
  still trips; ``chaos_soak.py --schedule-file`` accepts the file too
  but only takes the schedule — you supply seed/flags yourself;
  ``tests/fixtures/chaos_repros/`` commits found ones with a regression
  test).

Determinism is the same contract as the rest of the chaos plane: one
``random.Random(seed)`` drives every mutation and parent choice, soak
seeds are derived arithmetically from (search seed, iteration), and the
per-iteration JSONL search log carries nothing wall-clock-derived — two
same-seed ``--budget-iters`` runs produce byte-identical logs and final
corpus signatures (pinned by tests/test_chaos_search.py and the CI
``chaos_search_smoke``).

``tools/chaos_search.py`` is the CLI; its long-soak mode
(``--budget-seconds``, resumable ``--corpus`` dir) is the ROADMAP's
scenario-diversity engine run at active-set + device-route + live tenant
traffic.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field

from josefine_tpu_torch.chaos.faults import NetFaults
from josefine_tpu_torch.chaos.nemesis import (
    DISK_FAULTS,
    LEASE_SCHEDULES,
    MIGRATION_SCHEDULES,
    ROLES,
    SCHEDULES,
    TARGETS,
    WIRE_OPS,
    WIRE_SCHEDULES,
    Schedule,
    Step,
)
from josefine_tpu_torch.chaos.soak import run_soak
from josefine_tpu_torch.models.types import resolve_device
from josefine_tpu_torch.utils.coverage import (
    CoverageMap,
    corpus_coverage,
    corpus_entry_filename,
    load_corpus_entries,
    save_corpus_entry,
)
from josefine_tpu_torch.utils.tracing import get_logger
from josefine_tpu_torch.workload.genome import clamp_workload, mutate_workload

log = get_logger("chaos.search")

__all__ = ["ChaosSearch", "Corpus", "Genome", "Mutator", "SearchLimits",
           "ddmin"]


# ------------------------------------------------------------------ genome

@dataclass
class SearchLimits:
    """Bounds the mutator clamps every candidate into — soak-scale guard
    rails, not product limits (a searched schedule must stay runnable in
    seconds, not minutes, or the search starves)."""

    max_steps: int = 24
    min_horizon: int = 60
    max_horizon: int = 600
    min_heal: int = 40
    max_heal: int = 140
    max_for: int = 80


@dataclass
class Genome:
    """One search candidate: a fault schedule plus (optionally) the
    workload knobs the soak drives traffic with."""

    schedule: Schedule
    workload: dict | None = None

    def copy(self) -> "Genome":
        s = self.schedule
        return Genome(
            schedule=Schedule(s.name,
                              [Step(at=st.at, op=st.op, args=dict(st.args))
                               for st in s.steps],
                              s.horizon, s.heal_ticks),
            workload=dict(self.workload) if self.workload else None,
        )

    def schedule_dict(self) -> dict:
        return json.loads(self.schedule.to_json())

    @classmethod
    def from_entry(cls, entry: dict) -> "Genome":
        return cls(
            schedule=Schedule.from_json(json.dumps(entry["schedule"])),
            workload=dict(entry["workload"]) if entry.get("workload")
            else None,
        )


# ----------------------------------------------------------------- mutator

#: Insert-op draw weights (duplicates = weight): structured network faults
#: dominate, because they are what the invariants are stated against.
_INSERT_OPS = (
    "partition", "partition", "isolate", "isolate", "block_link",
    "block_link", "crash", "crash", "skew", "disk", "heal_all",
    "heal_link", "restart",
)

#: Wire-mode insert catalog: socket fates dominate; raft-plane partitions
#: and isolates stay in the draw (the wire soak's transport interceptors
#: honor them — stacked-plane schedules are the interesting ones), while
#: crash/disk/skew are out (the wire harness runs real product nodes it
#: cannot rebuild mid-soak).
_WIRE_INSERT_OPS = (
    "conn_reset", "conn_reset", "torn_frames", "torn_frames",
    "conn_stall", "conn_stall", "accept_refuse",
    "partition", "isolate", "block_link", "heal_all",
)

#: Bundled schedules that carry pacer-skew steps: excluded from the lease
#: search catalog (lease soundness is stated for the lockstep pacer, and
#: run_soak with leases REFUSES skew-bearing schedules outright).
_SKEW_SCHEDULES = ("slow-disk", "skewed-pacer")

#: Mutation-kind draw weights.
_MUTATIONS = (
    "insert", "insert", "insert", "delete", "delete", "retime", "retime",
    "retarget", "retarget", "perturb", "perturb", "splice", "horizon",
)


class Mutator:
    """Seeded genome mutation over the nemesis DSL + workload knobs. All
    draws come from the caller's ``random.Random``; same seed, same
    lineage."""

    def __init__(self, rng: random.Random, n_nodes: int,
                 limits: SearchLimits, workload_genome: bool = False,
                 wire: bool = False, migration: bool = False,
                 n_streams: int = 0, leases: bool = False):
        self.rng = rng
        self.n_nodes = n_nodes
        self.n_streams = n_streams
        self.limits = limits
        # Wire mode mutates over the socket-fate op catalog (plus the
        # raft-plane partitions the wire soak's interceptors honor).
        self.insert_ops = _WIRE_INSERT_OPS if wire else _INSERT_OPS
        if leases:
            # Lease soaks refuse skew schedules (lockstep scoping), so the
            # op must not enter the draw — a single inserted skew step
            # would turn the candidate into a hard soak error, not just a
            # wasted genome.
            self.insert_ops = tuple(
                op for op in self.insert_ops if op != "skew")
        if migration:
            # Migration ops join the draw ONLY when the soak arms the
            # migration plane (on a plain cluster they are skipped, i.e.
            # wasted steps), so existing seeded lineages stay byte-stable.
            self.insert_ops = self.insert_ops + (
                "migrate", "migrate", "migrate_abort")
        if n_nodes < 2:
            # Link-topology ops need a second node to point at.
            self.insert_ops = tuple(
                op for op in self.insert_ops
                if op not in ("partition", "isolate", "block_link",
                              "heal_link")) or self.insert_ops
        # Include workload-knob mutations in the draw only when the search
        # actually drives traffic (a knob change on a traffic-less soak
        # would be a silent no-op candidate).
        self.kinds = _MUTATIONS + (("workload",) * 3 if workload_genome
                                   else ())

    # ------------------------------------------------------------ mutate

    def mutate(self, genome: Genome,
               corpus_genomes: list[Genome]) -> tuple[Genome, list[str]]:
        """1–3 seeded mutations on a copy of ``genome``; returns the
        mutated child and the op descriptions (for the search log)."""
        g = genome.copy()
        n = 1 + (self.rng.random() < 0.35) + (self.rng.random() < 0.15)
        ops: list[str] = []
        for _ in range(n):
            kind = self.rng.choice(self.kinds)
            desc = getattr(self, "_" + kind)(g, corpus_genomes)
            if desc:
                ops.append(desc)
        self._clamp(g)
        return g, ops

    def _clamp(self, g: Genome) -> None:
        """Force the child into the search limits: horizon/heal bounds,
        step count cap, every ``at`` inside the chaotic phase."""
        lim = self.limits
        s = g.schedule
        h = max(lim.min_horizon, min(lim.max_horizon, s.horizon))
        heal = max(lim.min_heal, min(lim.max_heal, s.heal_ticks))
        steps = [Step(at=max(1, min(st.at, h - 1)), op=st.op,
                      args=dict(st.args))
                 for st in s.steps][:lim.max_steps]
        g.schedule = Schedule(s.name, steps, h, heal)
        if g.workload:
            g.workload = clamp_workload(g.workload)

    # ----------------------------------------------------- mutation kinds

    def _insert(self, g: Genome, _corpus) -> str:
        st = self._gen_step(g.schedule.horizon)
        g.schedule.steps.append(st)
        return f"insert:{st.op}@{st.at}"

    def _delete(self, g: Genome, _corpus) -> str | None:
        if not g.schedule.steps:
            return None
        i = self.rng.randrange(len(g.schedule.steps))
        st = g.schedule.steps.pop(i)
        return f"delete:{st.op}@{st.at}"

    def _retime(self, g: Genome, _corpus) -> str | None:
        if not g.schedule.steps:
            return None
        i = self.rng.randrange(len(g.schedule.steps))
        st = g.schedule.steps[i]
        at = max(1, min(g.schedule.horizon - 1,
                        st.at + self.rng.randint(-40, 40)))
        g.schedule.steps[i] = Step(at=at, op=st.op, args=dict(st.args))
        return f"retime:{st.op}:{st.at}->{at}"

    def _retarget(self, g: Genome, _corpus) -> str | None:
        """Point a step somewhere else: flip leader<->follower, move a
        node index, or re-draw a link/partition's endpoints."""
        idx = [i for i, st in enumerate(g.schedule.steps)
               if st.op not in ("heal_all", "migrate_abort")]
        if not idx:
            return None
        i = self.rng.choice(idx)
        st = g.schedule.steps[i]
        args = dict(st.args)
        if st.op in WIRE_OPS:
            if st.op == "accept_refuse":
                return None  # role-less: nothing to retarget
            cur = args.get("role", "any")
            args["role"] = self.rng.choice(
                [r for r in ROLES if r != cur])
        elif st.op == "migrate":
            args["stream"] = self._stream()
        elif "target" in args:
            args["target"] = ("follower" if args["target"] == "leader"
                              else "leader")
        elif "node" in args:
            args["node"] = self.rng.randrange(self.n_nodes)
        elif st.op in ("block_link", "heal_link"):
            args["src"] = self.rng.randrange(self.n_nodes)
            args["dst"] = self.rng.choice(
                [j for j in range(self.n_nodes) if j != args["src"]])
        elif st.op == "partition":
            a, b = self._split()
            args["a"], args["b"] = a, b
        else:
            args["target"] = self.rng.choice(TARGETS)
        g.schedule.steps[i] = Step(at=st.at, op=st.op, args=args)
        return f"retarget:{st.op}@{st.at}"

    def _perturb(self, g: Genome, _corpus) -> str | None:
        """Jitter a numeric arg: duration, disk-fault probability, or
        pacer stride."""
        idx = [i for i, st in enumerate(g.schedule.steps)
               if any(k in st.args for k in ("for", "p", "stride"))]
        if not idx:
            return None
        i = self.rng.choice(idx)
        st = g.schedule.steps[i]
        args = dict(st.args)
        knob = self.rng.choice(
            sorted(k for k in ("for", "p", "stride") if k in args))
        if knob == "for":
            args["for"] = max(1, min(self.limits.max_for,
                                     args["for"] + self.rng.randint(-25, 25)))
        elif knob == "p":
            args["p"] = round(self.rng.uniform(0.1, 1.0), 2)
        else:
            args["stride"] = self.rng.randint(1, 4)
        g.schedule.steps[i] = Step(at=st.at, op=st.op, args=args)
        return f"perturb:{st.op}.{knob}@{st.at}"

    def _splice(self, g: Genome, corpus_genomes) -> str | None:
        """Crossover: this genome's steps before a cut tick, a corpus
        partner's steps from the cut on."""
        partners = [c for c in corpus_genomes if c.schedule.steps]
        if not partners:
            return None
        other = self.rng.choice(partners).schedule
        h = max(g.schedule.horizon, other.horizon)
        cut = self.rng.randint(1, h - 1)
        steps = ([Step(at=st.at, op=st.op, args=dict(st.args))
                  for st in g.schedule.steps if st.at < cut]
                 + [Step(at=st.at, op=st.op, args=dict(st.args))
                    for st in other.steps if st.at >= cut])
        g.schedule = Schedule(g.schedule.name, steps, h,
                              max(g.schedule.heal_ticks, other.heal_ticks))
        return f"splice:{other.name}@{cut}"

    def _horizon(self, g: Genome, _corpus) -> str:
        s = g.schedule
        h = max(self.limits.min_horizon,
                min(self.limits.max_horizon,
                    s.horizon + self.rng.choice((-80, -40, 40, 80))))
        g.schedule = Schedule(s.name, s.steps, h, s.heal_ticks)
        return f"horizon:{s.horizon}->{h}"

    def _workload(self, g: Genome, _corpus) -> str | None:
        if g.workload is None:
            return None
        g.workload, desc = mutate_workload(g.workload, self.rng)
        return f"workload:{desc}"

    # ------------------------------------------------------- step factory

    def _split(self) -> tuple[list[int], list[int]]:
        nodes = list(range(self.n_nodes))
        self.rng.shuffle(nodes)
        cut = self.rng.randint(1, self.n_nodes - 1)
        return sorted(nodes[:cut]), sorted(nodes[cut:])

    def _node_or_target(self, args: dict) -> None:
        if self.rng.random() < 0.5:
            args["node"] = self.rng.randrange(self.n_nodes)
        else:
            args["target"] = self.rng.choice(TARGETS)

    def _stream(self) -> int:
        # Stream 0 is pinned (metadata row) — the coordinator would just
        # skip it, so the draw starts at 1.
        return self.rng.randrange(1, max(2, self.n_streams))

    def _gen_step(self, horizon: int) -> Step:
        """One fresh random step, drawn from the op catalog with args in
        their validated domains (nemesis.OP_ARGS is the contract)."""
        rng = self.rng
        op = rng.choice(self.insert_ops)
        at = rng.randint(1, max(1, horizon - 1))
        dur = rng.randint(5, self.limits.max_for)
        if op == "conn_reset":
            args = {"role": rng.choice(ROLES),
                    "p": rng.choice((0.5, 0.8, 1.0)),
                    "for": rng.randint(2, 10)}
        elif op == "conn_stall":
            args = {"role": rng.choice(ROLES),
                    "for": rng.randint(5, min(25, self.limits.max_for))}
        elif op == "torn_frames":
            args = {"role": rng.choice(ROLES),
                    "p": rng.choice((0.3, 0.6, 0.9)), "for": dur}
        elif op == "accept_refuse":
            args = {"for": rng.randint(3, 15)}
        elif op == "block_link":
            src = rng.randrange(self.n_nodes)
            dst = rng.choice([j for j in range(self.n_nodes) if j != src])
            args = {"src": src, "dst": dst, "for": dur}
        elif op == "heal_link":
            src = rng.randrange(self.n_nodes)
            dst = rng.choice([j for j in range(self.n_nodes) if j != src])
            args = {"src": src, "dst": dst}
        elif op == "partition":
            a, b = self._split()
            args = {"a": a, "b": b, "for": dur}
            if rng.random() < 0.3:
                args["symmetric"] = False
        elif op == "isolate":
            args = {"for": dur}
            self._node_or_target(args)
            if rng.random() < 0.3:
                args["symmetric"] = False
        elif op == "crash":
            args = {"for": min(dur, 40)}
            self._node_or_target(args)
        elif op == "restart":
            args = {"node": rng.randrange(self.n_nodes)}
        elif op == "disk":
            args = {"fault": rng.choice(DISK_FAULTS),
                    "p": rng.choice((0.3, 0.6, 1.0)), "for": dur}
            self._node_or_target(args)
        elif op == "skew":
            args = {"stride": rng.randint(2, 4)}
            self._node_or_target(args)
        elif op == "migrate":
            args = {"stream": self._stream()}
        elif op == "migrate_abort":
            args = {}
        else:  # heal_all
            args = {}
        return Step(at=at, op=op, args=args)


# ------------------------------------------------------------------- ddmin

def ddmin(steps: list, trips) -> list:
    """Zeller's delta-debugging minimization over a step list: the
    smallest (1-minimal) sublist for which ``trips(sublist)`` still holds.
    Each probe is one full soak — deterministic replay makes every probe
    exact, so the result is a true minimized repro, not a heuristic.
    Probes are memoized (splits revisit subsets)."""
    cache: dict[str, bool] = {}

    def key(sub: list) -> str:
        return json.dumps([[s.at, s.op, s.args] for s in sub],
                          sort_keys=True)

    def check(sub: list) -> bool:
        k = key(sub)
        if k not in cache:
            cache[k] = bool(trips(sub))
        return cache[k]

    if not check(steps):
        raise ValueError("ddmin: the full step list does not trip")
    n = 2
    while len(steps) >= 2:
        # n contiguous chunks, as even as possible.
        size, rem = divmod(len(steps), n)
        chunks, pos = [], 0
        for i in range(n):
            end = pos + size + (1 if i < rem else 0)
            chunks.append(steps[pos:end])
            pos = end
        reduced = False
        for i in range(n):
            complement = [s for j, c in enumerate(chunks) if j != i
                          for s in c]
            if complement and check(complement):
                steps = complement
                n = max(n - 1, 2)
                reduced = True
                break
        if not reduced:
            if n >= len(steps):
                break
            n = min(len(steps), n * 2)
    return steps


# ------------------------------------------------------------------ corpus

class Corpus:
    """The persistent schedule corpus: entries + their coverage union.

    ``path=None`` keeps everything in memory (tests); with a path, every
    admit writes the entry file immediately, so a killed long soak resumes
    from exactly what it had admitted."""

    def __init__(self, path: str | None = None, cap: int = 64):
        self.path = path
        self.cap = cap
        self.entries: list[dict] = (load_corpus_entries(path)
                                    if path else [])
        self.coverage = corpus_coverage(self.entries)

    def signatures(self) -> set[str]:
        return {e["signature"] for e in self.entries}

    def baseline_coverage(self) -> CoverageMap:
        """Union over the ``bundled`` entries only — what replaying the
        six hand-written nemeses covers, the bar a search run is measured
        against."""
        return corpus_coverage(
            [e for e in self.entries if e.get("origin") == "bundled"])

    def admit(self, entry: dict) -> bool:
        """Admit (dedup by signature); persists immediately when backed by
        a directory."""
        if entry["signature"] in self.signatures():
            return False
        self.entries.append(entry)
        for feat in entry["features"]:
            self.coverage.add(feat)
        if self.path:
            save_corpus_entry(self.path, entry)
        return True

    def retire_stale(self) -> list[str]:
        """Over cap? Retire stale lineages: search entries whose EVERY
        feature is also covered by some other entry (they stopped paying
        for their slot), oldest iteration first. Bundled entries are the
        baseline and never retire. Returns retired signatures."""
        retired: list[str] = []
        while len(self.entries) > self.cap:
            stale = [e for e in self.entries
                     if e.get("origin") != "bundled"
                     and all(self.coverage.counts.get(f, 0) > 1
                             for f in e["features"])]
            if not stale:
                break
            victim = min(stale, key=lambda e: (e.get("iteration", 0),
                                               e["signature"]))
            self.entries.remove(victim)
            retired.append(victim["signature"])
            if self.path:
                p = os.path.join(self.path, corpus_entry_filename(victim))
                if os.path.exists(p):
                    os.remove(p)
            self.coverage = corpus_coverage(self.entries)
        return retired


# ------------------------------------------------------------------ driver

class ChaosSearch:
    """The seeded, fully deterministic search driver (see module
    docstring). ``soak`` kwargs select the environment every candidate
    runs in — the long-soak configuration is active_set + device_route +
    quiet_net + a workload genome."""

    def __init__(self, seed: int, corpus: Corpus,
                 n_nodes: int = 3, groups: int = 2,
                 active_set: bool = False, hb_ticks: int | None = None,
                 device_route: bool = False, flight_wire: bool = True,
                 quiet_net: bool = False, workload: dict | None = None,
                 commitless_limit: int | None = None,
                 flight_ring: int | None = None,
                 limits: SearchLimits | None = None,
                 min_novel: int = 1, minimize: bool = True,
                 repro_dir: str | None = None,
                 log_path: str | None = None,
                 start_iteration: int | None = None,
                 wire: bool = False, wire_opts: dict | None = None,
                 migration: bool = False, leases: bool = False,
                 device="cuda"):
        # Every candidate soak runs its engines on this device (not in
        # soak_config: the card and the host give equal runs). Without
        # a card the default raises here, not at the first soak.
        self.device = str(resolve_device(device))
        self.seed = seed
        self.corpus = corpus
        self.n_nodes = n_nodes
        self.groups = groups
        # Wire mode: candidates run through run_wire_soak (real Kafka
        # connections under a lockstep clock) instead of the in-process
        # harness; parents/bootstrap come from the wire schedule catalog,
        # the mutator draws socket-fate ops, and novelty is scored over
        # the wire coverage classes. wire_opts forwards harness knobs
        # (tenants, produce_every, commitless_limit, ...).
        self.wire = wire
        self.wire_opts = dict(wire_opts or {})
        # Migration mode: every candidate soak arms the migration plane
        # (spare row + coordinator), the migration nemeses join the
        # bootstrap/parent catalog, and the mutator draws migrate /
        # migrate_abort ops. Off (the default) leaves the classic search
        # byte-identical — the base SCHEDULES dict must never grow (its
        # sorted order seeds every committed corpus's parent draws).
        self.migration = migration and not wire
        # Lease mode: every candidate soak arms the lease plane (and its
        # per-tick ledger + stale-read probe), the lease nemeses join the
        # bootstrap/parent catalog, and the skew-bearing classics drop out
        # of it — run_soak with leases refuses skew schedules (lockstep
        # scoping), and the mutator stops drawing the op. Off by default
        # for the same SCHEDULES byte-stability reason as migration.
        self.leases = leases and not wire
        if wire:
            self.schedules = WIRE_SCHEDULES
        else:
            base = dict(SCHEDULES)
            if self.leases:
                base = {k: v for k, v in base.items()
                        if k not in _SKEW_SCHEDULES}
                base.update(LEASE_SCHEDULES)
            if self.migration:
                base.update(MIGRATION_SCHEDULES)
            self.schedules = base
        if wire:
            workload = None  # the wire driver owns its own tenant spec
        self.active_set = active_set
        self.hb_ticks = hb_ticks
        self.device_route = device_route
        self.flight_wire = flight_wire
        self.quiet_net = quiet_net
        self.workload = clamp_workload(workload) if workload else None
        self.commitless_limit = commitless_limit
        self.flight_ring = flight_ring
        self.limits = limits or SearchLimits()
        self.min_novel = min_novel
        self.minimize = minimize
        self.repro_dir = repro_dir
        self.log_path = log_path
        # Resume: continue the iteration axis past what the corpus already
        # holds, and fold the start into the RNG seed so a resumed run is
        # a fresh deterministic stream (NOT a replay of the dead one).
        if start_iteration is None:
            start_iteration = 1 + max(
                (e.get("iteration", -1) for e in corpus.entries),
                default=-1)
        self.iteration = self.start_iteration = start_iteration
        self.rng = random.Random(seed * 2654435761 + start_iteration)
        self.mutator = Mutator(self.rng, n_nodes, self.limits,
                               workload_genome=self.workload is not None,
                               wire=wire, migration=self.migration,
                               n_streams=groups, leases=self.leases)
        self.log_lines: list[dict] = []
        self.admitted = 0
        self.violations = 0
        self.repros: list[str] = []
        self.invalid = 0
        self.probes = 0
        self.skipped_total = 0
        self.max_stall_seen = 0

    # ------------------------------------------------------------- soak

    def soak_config(self) -> dict:
        """The environment every candidate runs in — recorded into repro
        files so a replay reconstructs the exact run."""
        cfg = {
            "n_nodes": self.n_nodes, "groups": self.groups,
            "active_set": self.active_set, "hb_ticks": self.hb_ticks,
            "device_route": self.device_route,
            "flight_wire": self.flight_wire, "quiet_net": self.quiet_net,
            "commitless_limit": self.commitless_limit,
            "flight_ring": self.flight_ring,
            "migration": self.migration,
            "leases": self.leases,
        }
        if self.wire:
            cfg["wire"] = True
            cfg["wire_opts"] = dict(self.wire_opts)
        return cfg

    def _soak(self, schedule: Schedule, workload: dict | None,
              soak_seed: int) -> dict:
        self.probes += 1
        if self.wire:
            from josefine_tpu_torch.chaos.wire_soak import run_wire_soak

            return run_wire_soak(
                soak_seed, schedule, n_nodes=self.n_nodes,
                commitless_limit=self.commitless_limit,
                artifact_path=os.devnull, device=self.device,
                **self.wire_opts)
        return run_soak(
            soak_seed, schedule, n_nodes=self.n_nodes, groups=self.groups,
            net=NetFaults.quiet() if self.quiet_net else None,
            active_set=self.active_set, hb_ticks=self.hb_ticks,
            device_route=self.device_route, flight_wire=self.flight_wire,
            workload=workload, commitless_limit=self.commitless_limit,
            flight_ring=self.flight_ring, migration=self.migration,
            leases=self.leases, device=self.device,
            # Search runs keep their own repro records; the per-violation
            # auto-artifact (journals+registry) would litter the cwd once
            # per probe during minimization.
            artifact_path=os.devnull)

    def _soak_seed(self, iteration: int) -> int:
        return (self.seed * 1_000_003 + iteration) % (1 << 31)

    # ---------------------------------------------------------- logging

    @staticmethod
    def _health_line(result: dict) -> dict | None:
        """Compact detector verdicts for a log line, beside the
        invariants: only detectors that left ok, each with its worst
        level and first-degraded tick. None when the soak ran with the
        health plane off. Deterministic by construction (verdicts
        iterate detectors sorted), so the search log stays byte-stable
        across same-seed runs."""
        h = result.get("health")
        if not h:
            return None
        out = {}
        for det, v in h["verdicts"]["detectors"].items():
            if v["worst"] != "ok":
                out[det] = {"worst": v["worst"],
                            "at": v.get("first_degraded")}
        return out

    def _log(self, line: dict) -> dict:
        self.log_lines.append(line)
        if self.log_path:
            with open(self.log_path, "a") as fh:
                fh.write(json.dumps(line, sort_keys=True,
                                    separators=(",", ":")) + "\n")
        return line

    # -------------------------------------------------------- bootstrap

    def bootstrap(self) -> int:
        """Seed an empty corpus by replaying the bundled nemeses (the six
        in-process classics, or the wire catalog in wire mode) under THIS
        search's soak configuration (clamped into the search limits) and
        admitting each run as a ``bundled`` entry — the baseline the
        summary's class-count comparison is stated against."""
        added = 0
        for k, name in enumerate(sorted(self.schedules)):
            sched = self.schedules[name](self.n_nodes)
            lim = self.limits
            sched = Schedule(sched.name, sched.steps,
                             min(sched.horizon, lim.max_horizon),
                             min(sched.heal_ticks, lim.max_heal))
            seed = self._soak_seed(-(k + 1))
            result = self._soak(sched, self.workload, seed)
            cov = CoverageMap.from_dict(result["coverage"])
            entry = self._entry(name, sched, self.workload, seed, cov,
                                origin="bundled", iteration=-1,
                                parent=None)
            if self.corpus.admit(entry):
                added += 1
            self._log({"bootstrap": name, "seed": seed,
                       "signature": cov.signature(),
                       "features": len(cov.counts),
                       "invariants": result["invariants"],
                       "health": self._health_line(result)})
        return added

    @staticmethod
    def _entry(name: str, sched: Schedule, workload: dict | None,
               seed: int, cov: CoverageMap, origin: str, iteration: int,
               parent: str | None) -> dict:
        return {
            "name": name,
            "schedule": json.loads(sched.to_json()),
            "workload": dict(workload) if workload else None,
            "seed": seed,
            "signature": cov.signature(),
            "class_counts": cov.class_counts(),
            "features": sorted(cov.counts),
            "origin": origin,
            "iteration": iteration,
            "parent": parent,
        }

    # -------------------------------------------------------- iteration

    def _pick_parent(self) -> tuple[Genome, str]:
        """A corpus entry (uniform over admit order) — or, 20% of the
        time, a fresh bundled builder, so the search never loses the
        classics as mutation roots."""
        if self.corpus.entries and self.rng.random() >= 0.2:
            e = self.rng.choice(self.corpus.entries)
            return Genome.from_entry(e), e["signature"][:12]
        name = self.rng.choice(sorted(self.schedules))
        sched = self.schedules[name](self.n_nodes)
        return Genome(sched, dict(self.workload) if self.workload
                      else None), name

    def run_iteration(self) -> dict:
        """One search step: pick parent, mutate, soak, score, admit;
        minimize on violation. Returns (and logs) the iteration line."""
        i = self.iteration
        self.iteration += 1
        parent, parent_label = self._pick_parent()
        corpus_genomes = [Genome.from_entry(e) for e in self.corpus.entries]
        child, ops = self.mutator.mutate(parent, corpus_genomes)
        child.schedule.name = f"g{i:05d}"
        soak_seed = self._soak_seed(i)
        line: dict = {"iter": i, "parent": parent_label, "ops": ops,
                      "seed": soak_seed,
                      "steps": len(child.schedule.steps),
                      "horizon": child.schedule.horizon}
        if child.workload:
            line["workload"] = {k: child.workload[k]
                                for k in sorted(child.workload)}
        try:
            child.schedule.validate(self.n_nodes)
        except ValueError as e:
            # The mutator is written to stay inside the DSL, so this is a
            # bug-net, not a code path mutation relies on — but a garbage
            # candidate must cost one log line, never the whole search.
            self.invalid += 1
            return self._log({**line, "invalid": str(e)})
        result = self._soak(child.schedule, child.workload, soak_seed)
        cov = CoverageMap.from_dict(result["coverage"])
        novelty = cov.novelty(self.corpus.coverage)
        line.update({
            "signature": cov.signature(),
            "novel": novelty,
            "invariants": result["invariants"],
            # Detector verdicts ride beside the invariants on every
            # probe: a candidate that trips no invariant but drives a
            # detector critical is visible in the log even if coverage
            # novelty rejects it from the corpus.
            "health": self._health_line(result),
            "nemesis_skipped": result["nemesis_skipped"],
            "max_commitless_window": result["max_commitless_window"],
        })
        self.skipped_total += result["nemesis_skipped"]
        self.max_stall_seen = max(self.max_stall_seen,
                                  result["max_commitless_window"])
        if result["violation"] is not None:
            self.violations += 1
            line["violation"] = result["violation"]
            if self.minimize:
                line["repro"] = self._minimize_and_record(
                    child, soak_seed, result, i)
        admitted = False
        if novelty >= self.min_novel:
            admitted = self.corpus.admit(self._entry(
                child.schedule.name, child.schedule, child.workload,
                soak_seed, cov, origin="search", iteration=i,
                parent=parent_label))
        if admitted:
            self.admitted += 1
            retired = self.corpus.retire_stale()
            if retired:
                line["retired"] = [s[:12] for s in retired]
        line["admitted"] = admitted
        line["corpus"] = len(self.corpus.entries)
        line["corpus_features"] = len(self.corpus.coverage)
        return self._log(line)

    # ------------------------------------------------------ minimization

    def _minimize_and_record(self, genome: Genome, soak_seed: int,
                             result: dict, iteration: int) -> dict:
        """ddmin the violating candidate down to a 1-minimal step list
        that still trips, and keep the repro (JSON on disk when
        ``repro_dir`` is set)."""
        sched = genome.schedule

        def trips(steps: list) -> bool:
            probe = Schedule(sched.name + "-min", list(steps),
                             sched.horizon, sched.heal_ticks)
            return self._soak(probe, genome.workload,
                              soak_seed)["violation"] is not None

        minimized = ddmin(list(sched.steps), trips)
        min_sched = Schedule(f"{sched.name}-min", minimized,
                             sched.horizon, sched.heal_ticks)
        repro = {
            "violation": result["violation"],
            "seed": soak_seed,
            "schedule": json.loads(min_sched.to_json()),
            "workload": dict(genome.workload) if genome.workload else None,
            "soak": self.soak_config(),
            "trigger_schedule": json.loads(sched.to_json()),
            "trigger_steps": len(sched.steps),
            "minimized_steps": len(minimized),
            "iteration": iteration,
        }
        name = None
        if self.repro_dir:
            os.makedirs(self.repro_dir, exist_ok=True)
            name = f"repro_i{iteration:05d}_{soak_seed}.json"
            path = os.path.join(self.repro_dir, name)
            with open(path, "w") as fh:
                json.dump(repro, fh, sort_keys=True, indent=1)
                fh.write("\n")
            self.repros.append(path)
        log.info("minimized violation at iter %d: %d -> %d steps (%s)",
                 iteration, len(sched.steps), len(minimized),
                 result["violation"])
        # Basename only: the search log's byte-identical-across-same-seed
        # contract must survive two runs pointing at different repro dirs.
        return {"file": name, "trigger_steps": len(sched.steps),
                "minimized_steps": len(minimized)}

    # -------------------------------------------------------------- run

    def run(self, budget_iters: int | None = None,
            budget_seconds: float | None = None) -> dict:
        """Drive iterations until a budget is exhausted. ``budget_iters``
        counts THIS run's iterations (resume-friendly); byte-identical
        same-seed logs are only guaranteed in pure-iters mode (the
        seconds gate reads the wall clock)."""
        if budget_iters is None and budget_seconds is None:
            raise ValueError("need --budget-iters and/or --budget-seconds")
        if not self.corpus.entries:
            self.bootstrap()
        import time
        deadline = None
        if budget_seconds is not None:
            deadline = time.monotonic() + budget_seconds  # graftlint: allow(det-wallclock) — budget stop gate; the reading never reaches the search log, corpus, or any journal
        done = 0
        while True:
            if budget_iters is not None and done >= budget_iters:
                break
            if deadline is not None and time.monotonic() >= deadline:  # graftlint: allow(det-wallclock) — budget stop gate; never journaled or logged
                break
            self.run_iteration()
            done += 1
        return self.summary(iterations_run=done)

    def summary(self, iterations_run: int | None = None) -> dict:
        """The search-run epilogue: corpus-vs-baseline feature and
        class-count comparison (the acceptance axis — a search must beat
        replaying the six bundled nemeses), plus run telemetry."""
        baseline = self.corpus.baseline_coverage()
        cov = self.corpus.coverage
        summary = {
            "type": "summary",
            "seed": self.seed,
            "start_iteration": self.start_iteration,
            "iterations_run": iterations_run,
            "soak": self.soak_config(),
            "admitted": self.admitted,
            "violations": self.violations,
            # Basenames (deterministic across repro dirs — this dict is
            # logged); full paths live on ChaosSearch.repros.
            "repros": [os.path.basename(p) for p in self.repros],
            "invalid": self.invalid,
            "soak_runs": self.probes,
            "nemesis_skipped_total": self.skipped_total,
            "max_commitless_window_seen": self.max_stall_seen,
            "corpus_entries": len(self.corpus.entries),
            "corpus_features": len(cov),
            "corpus_class_counts": cov.class_counts(),
            "baseline_features": len(baseline),
            "baseline_class_counts": baseline.class_counts(),
            "novel_vs_baseline": cov.novelty(baseline),
        }
        self._log(summary)
        return summary
