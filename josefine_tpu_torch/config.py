"""Layered configuration: defaults <- TOML file <- environment.

The PyTorch port's copy of the JAX package's ``config.py``: the same
sections, defaults, validation rules and ``JOSEFINE_*`` environment
override, except the ``[engine]`` section (see :class:`EngineConfig`).

Parity: reference ``src/config.rs:4-22`` (``JosefineConfig {raft, broker}``,
``config()`` layering a file source and a ``JOSEFINE``-prefixed environment
source), ``src/raft/config.rs:14-119`` (raft section, defaults + validation),
``src/broker/config.rs:12-41`` (broker section).

Deltas from the reference (deliberate):
* The raft env prefix is ``JOSEFINE_RAFT`` (the reference's is literally
  ``"crate::raft"`` — a bug, ``src/raft/config.rs:50``).
* ``election_timeout`` is honored (the reference hardcodes a 500-1000 ms
  window in ``src/raft/mod.rs:318-319`` and ignores the knob).
* New ``[engine]`` section selecting the consensus execution backend:
  ``backend = "torch"`` (PyTorch device programs) or ``"python"`` (host
  reference engine used for cross-checking), the device the engine's state
  lives on (``device = "cuda"``), plus device-tick sizing.
"""

from __future__ import annotations

import dataclasses
import os

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11
    import tomli as tomllib
from dataclasses import dataclass, field


@dataclass
class NodeAddr:
    """A peer in the static full-mesh cluster (reference ``src/raft/config.rs:26``)."""

    id: int
    ip: str = "127.0.0.1"
    port: int = 6669

    @property
    def addr(self) -> tuple[str, int]:
        return (self.ip, self.port)


@dataclass
class RaftConfig:
    """Parity: reference ``src/raft/config.rs:14-119``."""

    id: int = 1
    ip: str = "127.0.0.1"
    port: int = 6669  # reference default, src/raft/config.rs:101
    nodes: list[NodeAddr] = field(default_factory=list)
    run_for: float | None = None
    # Timing (milliseconds), reference src/raft/config.rs:104-107
    tick_ms: int = 100
    heartbeat_timeout_ms: int = 100
    election_timeout_min_ms: int = 500
    election_timeout_max_ms: int = 1000
    # Flow-control cap: blocks per AppendEntries frame (honored by the
    # engine's outbox — the reference carries this knob but never reads it,
    # SURVEY.md quirk 9; its hot path hardcodes MAX_INFLIGHT=5).
    # The reference's commit_timeout_ms knob (also dead there) is dropped.
    max_append_entries: int = 64
    # Multi-tick device windows: the server loop folds up to this many
    # ticks into one device dispatch while the cluster is in steady state
    # (RaftEngine.suggest_window drops to single ticks during elections,
    # snapshot transfers, and parole). 1 = off. Message reaction latency
    # scales with the window; dispatch count scales with 1/window. The
    # effective window is additionally clamped to the heartbeat interval
    # in ticks (heartbeat_timeout_ms / tick_ms) — the window merge's
    # lossless bound — so raising window_ticks without staggering
    # heartbeats has no effect. Must be the SAME on every node of a
    # cluster: each engine's keepalive freshness horizon assumes peers
    # ping at most one steady-state window apart (engine._peer_fresh), so
    # a node configured with a smaller window than its peers would judge
    # them stale and fire spurious elections.
    window_ticks: int = 1
    # Double-buffered tick pipeline: the server loop keeps one device
    # dispatch in flight and does tick t's host-side work (outbox decode,
    # chain appends, FSM apply) while the device computes tick t+1
    # (RaftEngine.tick_pipelined). Throughput: the host bridge hides
    # behind device latency. Cost: outbound consensus traffic leaves one
    # tick later PER HOP, so multi-hop exchanges stretch accordingly —
    # proposal→commit p50 roughly doubles (measured 3 → 6 ticks,
    # BENCH_engine.json pipelined row) and election rounds stretch the
    # same way. Off by default — turn on for throughput-bound deployments
    # at large P where device latency dominates the tick.
    pipeline_ticks: bool = False
    # Active-set compacted stepping: each tick the engine proves which
    # groups can change (pending traffic, proposals, election/heartbeat
    # timers inside the window horizon), steps ONLY those through the
    # device kernel in a power-of-two bucket, and advances the quiescent
    # rest with a closed-form timer decay — at 100k mostly-idle groups the
    # device step stops paying for the idle 95%+. Bit-exact with the dense
    # schedule (tests/test_active_set.py); auto-falls-back to the dense
    # step on any tick where most groups are active (e.g. cold-start
    # election storms). Off by default: at small P the dense step is
    # already cheap and the scheduler is pure overhead. Incompatible with
    # engine.partitions > 1 (the sharded engine keeps the dense schedule).
    active_set: bool = False
    # Consensus flight-recorder ring capacity (events): the engine journals
    # role/term/leader transitions, snapshot installs, group lifecycle and
    # scheduler mode flips into a bounded, wall-clock-free ring served at
    # the /events endpoint. Steady-state ticks emit nothing, so the cost is
    # O(transitions); the ring bounds memory for week-long soaks.
    flight_ring: int = 4096
    # Wire-level trace events (msg_sent / msg_delivered) in the flight
    # journal: one event per consensus message at the outbox decision
    # points (host decode, device-resident route scatter — detail.path says
    # which) and at inbox consumption, so a proposal can be followed
    # sender→receiver across node journals (utils/flight.merge_journals,
    # tools/trace_report.py). Off by default: at P=100k the steady-state
    # wire volume is ~P events/tick — turn on for chaos soaks and trace
    # captures, not for the bench hot path (bench_engine --flight-wire
    # quotes the measured cost in extra.flight_wire_overhead).
    flight_wire: bool = False
    # Request-scoped causal tracing (utils/spans.py): mint a trace context
    # at the broker's frame decode (and the workload drivers' submit) and
    # stamp tick-denominated phase spans — admission / queue / consensus /
    # apply / serve — through propose() and the commit/apply sites, served
    # at the MetricsServer /traces route and rendered by
    # tools/request_report.py. Off by default: the off path is a single
    # bool per site; the on cost at the 1000×10k traffic shape is quoted
    # in BENCH_traffic.json extra.request_spans_overhead (the flight_wire
    # discipline — measure, don't guess).
    request_spans: bool = False
    # ring_spill trace events in the flight journal: one event per payload
    # AppendEntries the device payload ring could NOT serve (span not
    # resident -> host path). Off by default, same reasoning as
    # flight_wire: a cold catch-up can spill thousands of frames; turn on
    # when diagnosing why routed_frac is below target. The spill COUNT is
    # always available as raft_route_ring_spills_total.
    flight_ring_spill: bool = False
    # Tick-denominated leader leases (raft/lease.py): the host mirrors a
    # per-group lease row (holder, expiry tick, granted term) renewed by
    # quorum-acknowledged AppendEntries evidence, letting the broker serve
    # Fetch/Metadata leader-local (broker.read_mode = "lease") without a
    # consensus round-trip. Observation-only: nothing in the device step
    # reads lease state, so leases-on consensus traffic is byte-identical
    # to leases-off (tests/test_lease_safety.py twin differentials). Off by
    # default; requires prevote (always on here) and an election timeout of
    # at least hb_ticks + 3 ticks — validated below and again at engine
    # init (lease.check_lease_params).
    leases: bool = False
    # lease_acquired / lease_renewed / lease_expired / lease_refused events
    # in the flight journal. Off by default, the flight_wire discipline:
    # renewals are per-quorum-advance per held group, so chaos soaks want
    # it and the bench hot path does not.
    flight_lease: bool = False
    # Node-local health plane (utils/health.py): deterministic detectors
    # (commit-stall, leader-flap, backpressure saturation, ...) evaluated
    # once per completed tick off the host mirrors the engine already
    # maintains — zero extra device fetches — driving per-group FSMs
    # (ok -> degraded -> critical) that journal to a PRIVATE flight ring
    # and export cluster_health{scope,detector} gauges plus the
    # MetricsServer /health route. Off by default: observation-only (a
    # health-on run is byte-identical to a health-off twin), but the
    # per-tick sampling is real work at very large P.
    health: bool = False
    # Vestigial in the reference (src/raft/config.rs:108-109); honored here
    # by the host snapshotter.
    snapshot_interval_s: int = 120
    snapshot_threshold: int = 8192
    # Pre-allocated node slots for runtime membership changes (0 = exactly
    # the configured nodes; the reference has no membership change at all).
    max_nodes: int = 0
    # Escape hatch for the N <= 8 cluster-size envelope (see validate()):
    # accept clusters up to 16 nodes. The protocol is N-generic (the scalar
    # oracle proves N=9 correctness — tests/test_engine.py wide-cluster
    # suite), but the device step's inbox fold and commit compare grow
    # with N per group. Opt in only if that cost is acceptable.
    allow_wide: bool = False
    data_directory: str = "/tmp/josefine-tpu"

    def validate(self) -> None:
        # Parity: validation rules in reference src/raft/config.rs:60-84.
        if self.id == 0:
            raise ValueError("raft.id must be non-zero")
        if self.port <= 1023:
            raise ValueError("raft.port must be > 1023")
        if self.heartbeat_timeout_ms < 10:
            raise ValueError("raft.heartbeat_timeout_ms must be >= 10ms")
        if self.election_timeout_min_ms < self.tick_ms:
            raise ValueError("election timeout must be >= tick interval")
        # NOTE: election timeout may legally be SHORTER than the heartbeat
        # interval — the classic Raft constraint no longer applies because
        # transport-level keepalive (MSG_PING / any peer traffic) resets
        # follower election timers between heartbeats (see node_step
        # peer_fresh). Staggering heartbeats far beyond the election
        # timeout is exactly the scaled configuration for 100k groups.
        # The keepalive is emitted by RaftEngine.tick_finish itself (not by
        # the server loop), so this holds for ANY driver — embedded engines
        # with manual routing (bench clusters, dryrun_multichip) included.
        if self.max_nodes and self.max_nodes < len(self.nodes) + 1:
            raise ValueError("raft.max_nodes must cover the configured nodes")
        # Device-kernel envelope: the consensus step materializes (P, N, N)
        # progress bricks and an O(N^2) commit-compare matrix per group
        # (models/chained_raft.py module docs) — sized for Kafka-style
        # replication factors, not wide clusters. Reject at config time
        # rather than letting compile time/memory blow up at engine init.
        # This is a deliberate product limit the reference does not share
        # (its TOML peer list is unbounded, src/raft/config.rs:26) — see
        # README "Cluster size envelope" for the design rationale and the
        # operator options below.
        n_cluster = max(self.max_nodes, len(self.nodes) + 1)
        cap = 16 if self.allow_wide else 8
        if n_cluster > cap:
            raise ValueError(
                f"cluster size {n_cluster} (nodes incl. self, or max_nodes) "
                f"exceeds the supported envelope of {cap}: the consensus "
                "kernel's (P, N, N) progress state is sized for "
                "replication-factor-scale N. Options: (1) partition the "
                "deployment into cells of <= 8 brokers (each topic's "
                "replica set rarely needs more — per-group claims already "
                "restrict replication to a slot subset); (2) set "
                "raft.allow_wide = true to accept up to 16 nodes, paying "
                "an O(N^2) step per group; (3) file the cluster "
                "shape you need — the cap is an envelope choice, not a "
                "protocol limit."
                if not self.allow_wide else
                f"cluster size {n_cluster} exceeds the hard envelope of 16 "
                "even with raft.allow_wide: deploy cells of <= 16 brokers "
                "and restrict each group's replica set via per-group claims.")
        if self.election_timeout_max_ms < self.election_timeout_min_ms:
            raise ValueError("election_timeout_max_ms < election_timeout_min_ms")
        if self.window_ticks < 1:
            raise ValueError("raft.window_ticks must be >= 1")
        if self.flight_ring < 1:
            raise ValueError("raft.flight_ring must be >= 1")
        if self.leases:
            # Same derivation RaftServer uses to turn ms into ticks; fail
            # at config time with the constraint in tick units so the
            # operator sees the actual safety margin (lease.py module docs:
            # lease duration timeout_min must exceed the heartbeat cadence
            # by >= 3 ticks or an idle leader can expire between renewals).
            t_min = max(2, self.election_timeout_min_ms // self.tick_ms)
            hb = max(1, self.heartbeat_timeout_ms // self.tick_ms)
            if t_min <= hb + 2:
                raise ValueError(
                    f"raft.leases requires election_timeout_min >= "
                    f"heartbeat + 3 ticks (got timeout_min={t_min}, "
                    f"hb_ticks={hb}): a leased leader renews on heartbeat "
                    "acks, so the lease window must outlive the renewal "
                    "cadence with margin")
        for n in self.nodes:
            if n.id == self.id:
                raise ValueError(f"raft.nodes must not contain self (id {n.id})")


@dataclass
class BrokerConfig:
    """Parity: reference ``src/broker/config.rs:12-41``."""

    id: int = 1
    ip: str = "127.0.0.1"
    port: int = 8844  # reference default, src/broker/config.rs:28
    state_file: str = "/tmp/josefine-tpu/state"
    data_directory: str = "/tmp/josefine-tpu/data"
    peers: list[NodeAddr] = field(default_factory=list)
    # Observability endpoint (/metrics, /state, /healthz); 0 = disabled.
    # Addition over the reference, which has no metrics at all (SURVEY.md §5).
    metrics_port: int = 0
    # Seed for broker-side randomized DECISIONS (partition placement
    # shuffles): the same (seed, broker id) reproduces the same placement
    # choices run-to-run, so same-seed cluster runs make identical
    # decisions through the broker path. Identity LABELS (topic/partition
    # uuids, member ids) deliberately stay uuid4 — they name entities,
    # never drive a choice or a journaled value, and collision-freedom
    # across restarts matters more than replayability (each such site
    # carries a graftlint allow(det-uuid) pragma saying so).
    seed: int = 0
    # Produce admission (backpressure): refuse a replicated produce with
    # THROTTLING_QUOTA_EXCEEDED while its partition's consensus-group
    # proposal queue holds this many unminted entries (the client backs
    # off and retries — bounded memory under overload instead of an
    # ever-growing queue). 0 = unbounded (legacy behavior).
    max_group_inflight: int = 128
    # --- connection-plane graceful degradation (wire-plane chaos PR) ---
    # Accept-path admission cap: refuse (clean close, retryable from the
    # client's point of view) new connections past this many live ones.
    # None/0 = uncapped (legacy behavior).
    max_connections: int | None = None
    # Per-client admission: at most this many live connections per
    # client_id, checked at the first decoded request; an over-cap
    # connection is closed without a response. A client fleet that
    # presents one stable client_id per tenant (the production client
    # shape) gets the per-tenant cap the ROADMAP names; the chaos wire
    # driver instead presents per-connection ids (its journal labels), so
    # wire soaks exercise the mechanism per connection, not per tenant.
    # None/0 = uncapped.
    max_connections_per_client: int | None = None
    # Per-TENANT accept-time token budget (the ROADMAP's per-tenant accept
    # admission). The tenant is the client_id prefix up to the first ':'
    # (the rig and production clients present "tenant:conn" ids; an id
    # with no ':' is its own tenant — which makes this a strict
    # generalization of the per-client cap). Each live connection holds
    # one token; a connection arriving with the budget exhausted gets ONE
    # response carrying the retryable THROTTLING_QUOTA_EXCEEDED code
    # (where its first request's API has an error surface), then a close,
    # and broker_conn_refused_total{reason="tenant_quota"} increments.
    # None/0 = uncapped.
    max_connections_per_tenant: int | None = None
    # Frame-body read deadline (seconds): once a frame HEADER arrived, the
    # body must follow within this bound or the connection is closed — a
    # torn frame whose tail never comes must not pin buffers forever.
    # Idle connections (no header) are never timed out. None/0 = no bound.
    conn_read_timeout_s: float | None = None
    # Slow-client eviction: a response write that cannot drain within this
    # bound evicts the connection (broker_conn_evicted_total + a flight
    # event). None = no bound.
    conn_write_timeout_s: float | None = None
    # Reject request frames larger than this with a clean close (the
    # protocol's i32 max is ~2 GiB — an absurd length prefix must not
    # trigger an unbounded read). Default 64 MiB.
    max_frame_bytes: int = 1 << 26
    # Concurrent in-flight frames per connection: the server pipelines
    # request handling (responses still write in request order); past this
    # many unanswered frames it stops reading — natural backpressure.
    max_inflight_per_conn: int = 64
    # Crash model (ARCHITECTURE.md "Durability"): "process" (default) makes
    # every ack durable to process crash (sqlite WAL synchronous=NORMAL, no
    # per-append seglog fsync); "power" additionally fsyncs the seglog
    # before each position record and runs sqlite synchronous=FULL, making
    # acks durable to OS/power failure at a measured throughput cost
    # (bench_log.py --fsync). The reference never decided (sled defaults,
    # src/lib.rs:33).
    durability: str = "process"
    # Read-path mode (ARCHITECTURE.md "Leader leases"): "local" (default)
    # serves Fetch/Metadata from the local replica with no leadership
    # check — the seed behavior, weakest consistency; "lease" serves
    # leader-local iff this node holds an unexpired tick-denominated lease
    # for the partition's group (raft.leases must be on), falling back to
    # a quorum read barrier when the lease is expired/frozen/mid-recycle;
    # "consensus" always pays the read barrier (ReadIndex-style quorum
    # round-trip) — the baseline the lease row in BENCH_traffic.json is
    # measured against.
    read_mode: str = "local"
    # Fetch serve path (ARCHITECTURE.md "The wire serving plane"):
    # "zerocopy" (default) assembles fetch response frames as chunk lists
    # spliced straight from the log's stable buffers — no join, no native
    # re-encode, no frame copy — plus the per-partition hot-tail span
    # cache; "legacy" keeps the seed's join + full re-encode path (the
    # before-row in BENCH_wire.json and the differential-test reference).
    fetch_path: str = "zerocopy"

    def validate(self) -> None:
        if self.id == 0:
            raise ValueError("broker.id must be non-zero")
        if self.port <= 1023:
            raise ValueError("broker.port must be > 1023")
        if self.metrics_port != 0 and self.metrics_port <= 1023:
            raise ValueError("broker.metrics_port must be 0 (disabled) or > 1023")
        if self.durability not in ("process", "power"):
            raise ValueError(
                f"broker.durability must be 'process' or 'power', "
                f"got {self.durability!r}")
        if self.max_group_inflight < 0:
            raise ValueError("broker.max_group_inflight must be >= 0")
        if self.read_mode not in ("local", "lease", "consensus"):
            raise ValueError(
                f"broker.read_mode must be 'local', 'lease' or "
                f"'consensus', got {self.read_mode!r}")
        if self.fetch_path not in ("zerocopy", "legacy"):
            raise ValueError(
                f"broker.fetch_path must be 'zerocopy' or 'legacy', "
                f"got {self.fetch_path!r}")


@dataclass
class EngineConfig:
    """Consensus execution backend selection."""

    backend: str = "torch"  # "torch" | "python"
    # The device that holds the engine's state and runs its step: "cuda"
    # (the card, the default; "cuda:<n>" picks one) or "cpu".
    device: str = "cuda"
    # Device tensor sizing: number of consensus groups stepped in lockstep.
    # The metadata group is group 0; topic partitions may claim further rows.
    partitions: int = 1
    max_nodes: int = 8
    # Multi-device: shard the partition axis over this many local devices
    # (0 = single device): that many distinct cards on "cuda", that many
    # shards of the host on "cpu". partitions must be divisible by it.
    mesh_shards: int = 0

    def validate(self) -> None:
        if self.backend not in ("torch", "python"):
            raise ValueError(
                f"engine.backend must be 'torch' or 'python', got {self.backend!r}")
        if self.device.split(":")[0] not in ("cuda", "cpu"):
            raise ValueError(
                f"engine.device must be 'cuda', 'cuda:<n>' or 'cpu', got {self.device!r}")
        if self.partitions < 1 or self.max_nodes < 1:
            raise ValueError("engine.partitions and engine.max_nodes must be >= 1")
        if self.mesh_shards < 0:
            raise ValueError("engine.mesh_shards must be >= 0")
        if self.mesh_shards and self.partitions % self.mesh_shards:
            raise ValueError(
                f"engine.partitions ({self.partitions}) must be divisible "
                f"by engine.mesh_shards ({self.mesh_shards})")


@dataclass
class JosefineConfig:
    """Parity: reference ``src/config.rs:4-9``."""

    raft: RaftConfig = field(default_factory=RaftConfig)
    broker: BrokerConfig = field(default_factory=BrokerConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)

    def validate(self) -> "JosefineConfig":
        self.raft.validate()
        self.broker.validate()
        self.engine.validate()
        if self.engine.partitions > 1 and self.raft.id != self.broker.id:
            # Partition replica sets are broker ids; mapping them onto raft
            # node slots (consensus-group membership) requires the two id
            # spaces to coincide, as they do in every example config.
            raise ValueError(
                "engine.partitions > 1 requires raft.id == broker.id")
        if self.broker.read_mode != "local" and not self.raft.leases:
            # Both non-local modes ride the lease lane: "lease" for the
            # fast path, "consensus" for the read-barrier waiter machinery.
            raise ValueError(
                f"broker.read_mode = {self.broker.read_mode!r} requires "
                "raft.leases = true")
        return self


# Casts keyed by the dataclass field *annotation* (the default value's type
# is unreliable: run_for defaults to None, nodes/peers to lists).
_ENV_CASTS = {
    "int": int,
    "float": float,
    "str": str,
    "bool": lambda v: str(v).lower() in ("1", "true", "yes"),
    "float | None": float,
}


def _apply_section(cfg_obj, data: dict) -> None:
    for f in dataclasses.fields(cfg_obj):
        if f.name not in data:
            continue
        val = data[f.name]
        if f.name in ("nodes", "peers"):
            val = [NodeAddr(**n) if isinstance(n, dict) else n for n in val]
        setattr(cfg_obj, f.name, val)


def _apply_env(cfg_obj, prefix: str, environ) -> None:
    """Env override: ``JOSEFINE_<SECTION>_<FIELD>`` (reference ``src/config.rs:15``).

    Scalar fields only — structured fields (``nodes``, ``peers``) come from
    the TOML file and reject env overrides loudly rather than mis-parsing.
    """
    for f in dataclasses.fields(cfg_obj):
        key = f"{prefix}_{f.name.upper()}"
        if key not in environ:
            continue
        cast = _ENV_CASTS.get(str(f.type))
        if cast is None:
            raise ValueError(
                f"{key}: field {f.name!r} cannot be set from the environment; "
                "set it in the TOML config file"
            )
        setattr(cfg_obj, f.name, cast(environ[key]))


def load_config(path: str | os.PathLike | None = None, environ=None) -> JosefineConfig:
    """Load defaults, layer a TOML file, then ``JOSEFINE``-prefixed env vars.

    Parity: reference ``src/config.rs:11-22``.
    """
    environ = os.environ if environ is None else environ
    cfg = JosefineConfig()
    if path is not None:
        with open(path, "rb") as fh:
            data = tomllib.load(fh)
        for section in ("raft", "broker", "engine"):
            if section in data:
                _apply_section(getattr(cfg, section), data[section])
    _apply_env(cfg.raft, "JOSEFINE_RAFT", environ)
    _apply_env(cfg.broker, "JOSEFINE_BROKER", environ)
    _apply_env(cfg.engine, "JOSEFINE_ENGINE", environ)
    return cfg.validate()
