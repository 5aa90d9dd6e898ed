"""RaftEngine: the per-node bridge between host runtime and the device step.

One engine instance is **one node of every consensus group** (the node-axis
row of the (partitions x nodes) tensor that lives on this host). Per tick it:

1. encodes received wire messages into the packed (10, P, N_src) inbox
   (one slot per (group, src); extras carry over to the next tick),
2. steps its node's row of all P groups through the packed window step
   (``raft/packed_step.py``) on the engine's device,
3. mirrors device decisions into durable host state: minted blocks are
   appended to the chain with their payloads, accepted spans extend it,
   commit advancement applies blocks to the FSM driver and resolves
   waiting client futures,
4. decodes the outbox into wire messages, attaching payload spans to
   AppendEntries from the chain.

The role machine itself runs on the device; the host moves payloads and
durability. This is the port of the JAX package's ``raft/engine.py`` with
dense and sparse packed IO (sparse by default above 4096 groups), the
active-set scheduler, device-resident delivery between co-located engines
(a :class:`~josefine_tpu_torch.raft.route.RouteFabric` registers itself as
``_fabric``), the tick-denominated leader leases (``leases=True``,
raft/lease.py) and sharding over a device mesh (``mesh=``, a
:class:`~josefine_tpu_torch.parallel.sharded.Mesh`: every state leaf, the
member mask and the planes co-shard their group axis over 'p', one block
per shard on its device; see parallel/sharded.py). Backends: ``"torch"``
(the batched torch step, on ``device``) and ``"python"`` (the scalar
oracle; it takes no mesh).

Invariant: an AppendEntries only reaches the device if its payload span was
validated against its (x, y] claim (rpc.span_is_valid), so "device accepted"
always implies "host can extend the chain".

Device discipline: ``tick_begin`` never waits for the device. It uploads
the packed inbox without a host sync, enqueues the window step, and starts
one asynchronous copy of the flat output into pinned host memory;
``tick_fetch`` waits for that copy alone. A routed inbox plane is
already on the device and merges inside the step. How the step runs (the
scalar oracle, per shard on a mesh, or on one torch device, where a card
replays the sparse step and the compacted active-set tick from captured
CUDA graphs) is the engine's step runner, picked once at construction
(``raft/step_runner.py``). The one exception is the active-set
scheduler's refetch of five (P,) vectors on re-entry after a dense/sparse
fallback tick (``_refetch_wake_inputs``, counted in ``active_refetches``,
timed as the profiler's ``compact/refetch``). A sparse tick whose changed rows overflow the
compaction capacity fetches the dense outputs in ``tick_finish``. State
leaves are never written in place (an in-flight pipelined finish may still
read them): every row write builds a new leaf.

The engine is split across six modules, all state living on this class:

* ``raft/packed_step.py``: the dense, sparse and active-set window steps
  (two backends each);
* ``raft/step_runner.py``: the four device programs of a tick (dense,
  sparse, compacted, decay) and the runner that carries them, one per
  engine, with its graph cache on a card;
* ``raft/snap_transfer.py``: snapshot capture, chunked transfer, install
  (:class:`SnapshotTransfer` mixin);
* ``raft/group_admin.py``: membership mask, group lifecycle, vote parole,
  conf-change application (:class:`GroupAdmin` mixin);
* ``raft/hostio.py``: inbox packing / outbox decoding (:class:`HostIO`
  mixin);
* this module: construction/recovery, wire intake, the tick dispatch
  (begin/finish), and status queries.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque

import numpy as np
import torch

from josefine_tpu_torch.models import chained_raft as cr
from josefine_tpu_torch.models.types import (
    CANDIDATE,
    FOLLOWER,
    LEADER,
    PRECANDIDATE,
    StepParams,
    resolve_device,
    step_params,
)
from josefine_tpu_torch.ops import ids
from josefine_tpu_torch.parallel import sharded as sh
from josefine_tpu_torch.raft import rpc
from josefine_tpu_torch.raft.chain import GENESIS, Chain, id_term, id_seq
from josefine_tpu_torch.raft.fsm import Driver, Fsm, ReplicaDiverged, supports_snapshot
from josefine_tpu_torch.raft.group_admin import (
    _PAROLE_DROP_ARR,
    _PAROLE_DROP_KINDS,
    GroupAdmin,
)
from josefine_tpu_torch.raft.hostio import HostIO, host_to
from josefine_tpu_torch.raft.lease import (
    LeaseLane,
    check_lease_params,
    m_reads_fallback,
    m_reads_leased,
)
from josefine_tpu_torch.raft.membership import ConfChange, MemberTable, is_conf
from josefine_tpu_torch.raft.migration import is_migration_fence
from josefine_tpu_torch.raft.packed_step import (
    _MIRROR13_ROWS,
    _lease_plane_scatter_fn,
    _node_view,
    host_wake_mask,
)
from josefine_tpu_torch.raft.result import NotLeader, TickResult
from josefine_tpu_torch.raft.snap_transfer import SnapshotTransfer, _SnapStream
from josefine_tpu_torch.raft.step_runner import step_runner
from josefine_tpu_torch.utils.flight import FlightRecorder
from josefine_tpu_torch.utils.health import HealthMonitor
from josefine_tpu_torch.utils.kv import KV
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.spans import current_span
from josefine_tpu_torch.utils.profiling import NULL_PROFILER, PhaseProfiler
from josefine_tpu_torch.utils.tracing import get_logger

__all__ = ["RaftEngine", "NotLeader", "TickResult"]

log = get_logger("raft.engine")

_m_ticks = REGISTRY.counter("raft_ticks_total", "Engine ticks executed")
_m_elections = REGISTRY.counter("raft_elections_won_total", "Elections won across groups")
_m_committed = REGISTRY.counter("raft_blocks_committed_total", "Blocks committed and applied")
_m_out = REGISTRY.counter("raft_msgs_out_total", "Consensus wire messages sent")
_m_in = REGISTRY.counter("raft_msgs_in_total", "Consensus wire messages accepted into the inbox")
_m_led = REGISTRY.gauge("raft_groups_led", "Groups this node currently leads")
_m_backlog_dropped = REGISTRY.counter(
    "raft_batch_backlog_dropped_total",
    "Consensus batch entries dropped by the per-src intake backlog cap")
_m_routed = REGISTRY.counter(
    "raft_msgs_routed_total",
    "Consensus messages delivered device-resident via the RouteFabric "
    "(never host-decoded). raft_msgs_out_total covers only host-path "
    "sends; raft_msgs_in_total counts everything accepted into the inbox "
    "— routed entries included, credited at the fabric flush")
# Proposal→commit latency in DEVICE ticks (the protocol's clock), observed
# leader-side when commit advancement covers a block this node minted.
# Power-of-two buckets; p50/p99 via Histogram.quantile.
_m_commit_lat = REGISTRY.histogram(
    "raft_commit_latency_ticks",
    "Proposal submit to commit-applied latency in device ticks (leader-side)")
# Per-tenant attribution of the same latency: rows tagged via
# set_group_tag additionally observe into this tenant-labelled histogram
# (capped label set with an overflow series).
_m_commit_lat_tenant = REGISTRY.histogram(
    "raft_commit_latency_ticks_by_tenant",
    "Proposal submit to commit-applied latency in device ticks, attributed "
    "to the tenant tag of the group row (leader-side; capped label set "
    "with an _other overflow series)", max_series=256)
# Pipeline / backlog telemetry, refreshed at scrape time by the engine's
# collect hook (_publish_telemetry).
_m_phase_ms = REGISTRY.gauge(
    "raft_tick_phase_ms_total",
    "Cumulative wall ms per tick phase (PhaseProfiler; empty unless "
    "enable_profiling)")
_m_wake_frac = REGISTRY.gauge(
    "raft_active_wake_fraction",
    "Fraction of groups the active-set wake predicate selected last tick")
_m_bucket = REGISTRY.gauge(
    "raft_active_bucket_level",
    "Power-of-two active-set gather bucket size of the last compacted tick")
_m_sched_ticks = REGISTRY.gauge(
    "raft_active_sched_ticks_total", "Ticks run through the compacted path")
_m_fallback_ticks = REGISTRY.gauge(
    "raft_active_fallback_ticks_total",
    "Active-set ticks that fell back to the dense dispatch")
_m_sched_rows = REGISTRY.gauge(
    "raft_active_sched_rows_total",
    "Summed active rows over all compacted ticks")
_m_pipe_depth = REGISTRY.gauge(
    "raft_pipeline_depth",
    "In-flight pipelined dispatches (0 = quiesced, 1 = double-buffered)")
_m_inbox_backlog = REGISTRY.gauge(
    "raft_inbox_backlog",
    "Wire messages + batch entries + deferred host messages queued for the "
    "next tick")
_m_kout = REGISTRY.gauge(
    "raft_sparse_outbox_capacity",
    "Current sparse outbox compaction capacity (k_out)")
_m_flight_seq = REGISTRY.gauge(
    "raft_flight_events_total",
    "Consensus flight-recorder events emitted (monotone past ring eviction)")
_m_ring_occ = REGISTRY.gauge(
    "raft_route_ring_occupancy",
    "Blocks resident in this engine's device payload ring (route-servable "
    "AppendEntries payloads; see raft_route_ring_spills_total for the "
    "misses)")
_m_lease_held = REGISTRY.gauge(
    "raft_lease_holder",
    "Groups whose tick-denominated leader lease this node currently holds "
    "(leases=True; see raft_reads_leased_total for the reads they served)")

# Kinds allowed into the device inbox — single source of truth for both the
# single-message whitelist (receive) and the batch intake (_receive_batch).
_CONSENSUS_KIND_SET = frozenset((
    rpc.MSG_VOTE_REQ, rpc.MSG_VOTE_RESP, rpc.MSG_APPEND, rpc.MSG_APPEND_RESP,
    rpc.MSG_PREVOTE_REQ, rpc.MSG_PREVOTE_RESP,
))
_CONSENSUS_KINDS = np.asarray(sorted(_CONSENSUS_KIND_SET), np.int32)

# Above this many groups the JAX engine picks sparse packed IO by default.
_DENSE_MAX_GROUPS = 4096


def _numel(flat) -> int:
    """Elements of a step's flat output: None, one tensor, or one per
    shard."""
    if flat is None:
        return 0
    return sum(f.numel() for f in flat) if isinstance(flat, list) else flat.numel()


def _read_joined(t, axis: int) -> np.ndarray:
    """A device output read to the host (a wait): one tensor, or a mesh
    engine's per-shard blocks joined along ``axis`` in shard order."""
    if isinstance(t, list):
        return np.concatenate([b.cpu().numpy() for b in t], axis=axis)
    return t.cpu().numpy()


class RaftEngine(HostIO, GroupAdmin, SnapshotTransfer):
    """Device-backed consensus engine for one node across P groups."""

    def __init__(
        self,
        kv: KV,
        node_ids: list[int],
        self_id: int,
        groups: int = 1,
        fsms: dict[int, Fsm] | None = None,
        params: StepParams | None = None,
        base_seed: int = 0,
        snapshot_threshold: int | None = None,
        snapshot_interval_ticks: int | None = None,
        max_nodes: int | None = None,
        backend: str = "torch",
        max_append_entries: int | None = 64,
        sparse_io: bool | None = None,
        active_set: bool = False,
        mesh=None,
        flight_ring: int = 4096,
        flight_wire: bool = False,
        flight_ring_spill: bool = False,
        request_spans: bool = False,
        leases: bool = False,
        flight_lease: bool = False,
        health: bool = False,
        device="cuda",
    ):
        if backend not in ("torch", "python"):
            raise ValueError(f"unknown engine backend {backend!r}")
        self._device = resolve_device(device)
        # Multi-device: shard the P (group) axis over a mesh. Groups are
        # independent, so each 'p' shard steps its own rows with no traffic
        # between shards but the psum lane of the active set's wake total.
        # The node axis stays local (the other members of each group are
        # other engines, reached over the wire or the fabric).
        self._mesh = mesh
        self._shards = 1
        self._shard_rows = groups
        if mesh is not None:
            if backend != "torch":
                raise ValueError("mesh sharding requires the torch backend")
            devices = int(np.prod(list(mesh.shape.values())))
            if groups % devices:
                raise ValueError(
                    f"groups={groups} not divisible by mesh devices {devices}")
            if active_set and "p" not in mesh.shape:
                raise ValueError(
                    "active_set on a sharded engine needs a 'p' mesh axis "
                    "(the shard-local compact step runs over 'p')")
            # The partition axis is 'p' alone (any other mesh axis only
            # replicates in the JAX package), so the plan and the telemetry
            # count 'p' shards, never the devices.
            self._shards = sh.mesh_shards(mesh)
            self._shard_rows = groups // self._shards
            self._shard_devs = [resolve_device(d) for d in sh.shard_devices(mesh)]
        self.kv = kv
        if self_id not in node_ids:
            raise ValueError(f"self id {self_id} not in node_ids {node_ids}")
        self.self_id = self_id
        self.P = groups
        # Membership: node-axis columns are pre-allocated slots; the cluster
        # can grow into free slots and shrink by masking columns. The
        # durable member table (updated by committed conf blocks) overrides
        # the configured bootstrap list on restart.
        max_slots = max(len(node_ids), max_nodes or 0)
        self.members = (MemberTable.load(kv, max_slots)
                        or MemberTable.bootstrap(list(node_ids), max_slots))
        self.N = self.members.max_slots
        slot = self.members.slot_of(self_id)
        if slot is None:
            raise ValueError(
                f"self id {self_id} has no slot in the member table "
                f"({sorted(self.members.by_id)}) — a joining node must be "
                "configured with the full current member list")
        self.me = slot
        self.node_ids = [self.members.id_of(s) for s in range(self.N)]
        # Per-group membership claims: group 0 always spans all active
        # members; a data group claimed by a topic partition is restricted
        # to its replica set's slots; an explicitly idled group (empty
        # claim) elects nobody. Groups without an entry default to full
        # membership.
        self._group_claims: dict[int, frozenset[int]] = {}
        self._backend = backend
        params = params or step_params(device=self._device)
        self.params = StepParams.from_leaves(
            [t.to(self._device) for t in params.leaves()])
        # The params as host ints, read once: reading a device scalar per
        # tick would make every tick wait for the device.
        (_tmin, _tmax, self._hb_ticks, auto_proposals,
         _prevote) = self.params.ints()
        if auto_proposals != 0:
            # The auto-proposal lane is a bench-only device feature; the
            # engine mints exactly the payloads it holds, so the two must
            # agree block-for-block.
            raise ValueError("RaftEngine requires params.auto_proposals == 0")

        self.chains = [Chain(kv, prefix=b"g%d:" % g) for g in range(groups)]
        self.drivers = {g: Driver(fsm) for g, fsm in (fsms or {}).items()}

        # Snapshotting / log compaction: take an FSM snapshot + truncate the
        # chain when a group has >= snapshot_threshold committed blocks
        # above its floor, or every snapshot_interval_ticks ticks if it made
        # any progress.
        self.snapshot_threshold = snapshot_threshold
        self.snapshot_interval_ticks = snapshot_interval_ticks
        # Replication flow control: at most this many blocks per AE frame.
        # None = unbounded (simulated modes with no wire frames).
        self.max_append_entries = max_append_entries
        self._ticks = 0
        self._last_snap_tick: dict[int, int] = {}
        self._snap_sent_tick: dict[tuple[int, int], int] = {}
        self._snap_cache: dict[int, tuple[int, bytes]] = {}
        # Chunked snapshot transfer state (see raft/snap_transfer.py).
        # Sender: (g, dst) -> (snap_id, next byte offset; -1 = position
        # probe outstanding), advanced by acks, plus per-transfer lazy
        # streams and last-ack ticks. Receiver: g -> a _SnapSink or a
        # (snap_id, buffer) staging. Acks are queued here and drained into
        # the next tick's outbound.
        self.snap_chunk_bytes = 4 << 20
        self.snap_window_bytes = 8 << 20
        self.snap_transfer_stale_ticks = 200
        # Incremental log-sync resume (receiver-side): a probe reply carries
        # the local log end and the sender ships only the missing suffix.
        self.snap_incremental = True
        # Migration freeze (volatile): groups whose row is the SOURCE of an
        # in-progress live migration refuse NEW proposals with a retryable
        # NotLeader (see raft/migration.py).
        self._frozen_groups: set[int] = set()
        # Vote parole (durable): group -> pre-reset head watermark. A group
        # that reset its chain abstains from elections until its head has
        # been re-replicated past everything it may have acked (see
        # _reset_group).
        self._parole: dict[int, int] = {}
        for k, v in kv.scan_prefix(b"parole:"):
            try:
                g = int(k[len(b"parole:"):])
            except ValueError:
                continue
            if 0 <= g < self.P and len(v) == 8:
                self._parole[g] = int.from_bytes(v, "big")
            else:
                # Stale key from a larger-P config (or corrupt): drop it
                # rather than index out of range on every tick's lift scan.
                log.warning("dropping out-of-range parole key %r", k)
                kv.delete(k)
        self._snap_send_off: dict[tuple[int, int], tuple[int, int]] = {}
        self._snap_payload: dict[tuple[int, int], _SnapStream] = {}
        self._snap_ack_tick: dict[tuple[int, int], int] = {}
        self._snap_staging: dict[int, object] = {}
        self._snap_stage_tick: dict[int, int] = {}
        self._snap_acks: list[rpc.WireMsg] = []

        # Restart recovery for snapshot-capable FSMs: restore the latest
        # snapshot, then replay the committed suffix (snap, commit]. FSMs
        # without restore() are assumed durable in their own right and get
        # no replay.
        for g, drv in self.drivers.items():
            if not supports_snapshot(drv.fsm):
                continue
            ch = self.chains[g]
            if ch.committed == GENESIS:
                continue
            snap_id, snap_data = self._load_snapshot(g)
            start = GENESIS
            if snap_id is not None:
                drv.fsm.restore(snap_data)
                start = snap_id
            else:
                # No snapshot yet: reset to the empty baseline before the
                # full replay so replay is the sole source of state.
                drv.fsm.restore(b"")
            if ch.committed > start:
                # Conf blocks route to the member table, never the app FSM
                # (same split as the live commit path at _apply_conf_block).
                app_blocks = []
                for b in ch.range(start, ch.committed):
                    if is_conf(b.data):
                        self._safe_conf_apply(b)
                    else:
                        app_blocks.append(b)
                drv.apply(app_blocks)

        # The replay above may have re-applied conf blocks — refresh the
        # slot-to-id map derived from the table before it is used.
        self.node_ids = [self.members.id_of(s) for s in range(self.N)]
        mask = self._member_mask()
        full, member = cr.init_state(
            groups, self.N,
            member=mask if mesh is None else torch.from_numpy(self._mask_np),
            base_seed=base_seed, params=self.params, device=self._device)
        # (P, N); on a mesh engine the mask's per-shard blocks.
        self.member = member if mesh is None else mask
        st = _node_view(full, self.me)
        # Durable recovery: chain head/commit + persisted term/voted_for.
        heads_t, heads_s, commits_t, commits_s, terms, voted = [], [], [], [], [], []
        for g, ch in enumerate(self.chains):
            heads_t.append(id_term(ch.head)); heads_s.append(id_seq(ch.head))
            commits_t.append(id_term(ch.committed)); commits_s.append(id_seq(ch.committed))
            t, v = self._load_vol(g)
            terms.append(max(t, id_term(ch.head)))
            voted.append(v)
        up = lambda xs: host_to(np.asarray(xs, np.int32), self._device)
        self.state = st.replace(
            head=ids.Bid(up(heads_t), up(heads_s)),
            commit=ids.Bid(up(commits_t), up(commits_s)),
            term=up(terms),
            voted_for=up(voted),
        )
        if mesh is not None:
            # Shard s's rows of every leaf live on its device; the per-tick
            # path reads and writes blocks only.
            self.state = sh.place_engine_state(self.state, mesh)
        # Host mirrors (numpy) for fast per-tick diffing. head/commit mirror
        # the packed chain ids so tick_finish can select active groups with
        # one vectorized compare instead of an O(P) Python scan.
        self._h_term = np.asarray(terms, np.int64)
        self._h_voted = np.asarray(voted, np.int64)
        self._h_role = np.zeros(groups, np.int64)
        self._h_leader = np.full(groups, -1, np.int64)
        self._h_head = np.fromiter(
            (ch.head for ch in self.chains), np.int64, count=groups)
        self._h_commit = np.fromiter(
            (ch.committed for ch in self.chains), np.int64, count=groups)
        # Reused per-tick input buffer: nine packed message rows + the
        # proposal-count row (zeroed in place each tick, uploaded once).
        self._in10 = np.zeros((10, groups, self.N), np.int32)
        # How this engine's tick programs run, picked once (raft/
        # step_runner.py): the scalar oracle, per shard on a mesh, or one
        # torch device, which on a card replays the sparse step and the
        # compacted tick from captured CUDA graphs.
        self._runner = step_runner(backend, self._device, mesh, self.params, self.me,
                                   groups, self.N, self.self_id)
        self._me_dev = self._runner.me
        # Hot-path counters with the label key pre-resolved.
        self._c_in = _m_in.bind(node=self.self_id)
        # Per-(group, src) tick of the last delivered consensus message —
        # the liveness half of the derived ISR (in_sync_map).
        self._h_last_seen = np.zeros((groups, self.N), np.int64)
        # Per-row incarnation (consensus-group recycling): stamped onto
        # every outbound data-group frame and checked at intake — a frame
        # from a recycled row's previous life must never be applied to its
        # successor.
        self._h_ginc = np.zeros(groups, np.int64)

        # Sparse packed IO (see the sparse commentary in packed_step.py):
        # on by default for large P, where dense per-tick transfers are
        # megabytes of zeros.
        self._sparse = (groups > _DENSE_MAX_GROUPS) if sparse_io is None else bool(sparse_io)
        # Active-set stepping (see the packed_step.py active-set
        # commentary): per tick the host proves which rows can change this
        # window (host_wake_mask over the mirrors below plus pending IO /
        # force-woken rows), gathers exactly those into a power-of-two
        # bucket, steps the bucket through the same window step as the
        # dense path, and advances every quiescent row through the
        # closed-form decay. Off by default.
        self._active_set = bool(active_set)
        # Auto-fallback: when the scheduler wakes more than this fraction
        # of rows, run the plain dense/sparse dispatch for the tick (timer
        # mirrors refetch on re-entry).
        self.active_fallback_frac = 0.5
        # Rows that MUST be stepped next tick regardless of the wake
        # predicate: reset/recycled rows, snapshot installs, send-pointer
        # fixups, claim changes — every out-of-tick device-state mutation
        # site registers itself here.
        self._force_active: set[int] = set()
        # Active sets dispatched but not yet adopted by tick_finish
        # (tick_pipelined schedules tick t+1 before tick t's finish runs,
        # so those rows' mirrors are stale — forcing them active keeps the
        # wake predicate sound on mirrors one tick behind).
        self._sched_pending: list[np.ndarray] = []
        # True after a dense/sparse tick ran while active_set is on: the
        # timer mirrors below were not maintained and must be refetched
        # before the next active schedule.
        self._timers_stale = False
        # Host timer mirrors (the wake predicate's inputs): exact for every
        # quiescent row by construction (the host decay arithmetic IS the
        # device decay), refreshed for active rows from the compact step's
        # 13-row mirror fetch, and kept in lockstep with the out-of-tick
        # device writes (parole hold, group reset). timeout and alive start
        # as one transfer; alive never moves on the engine path.
        self._h_elapsed = np.zeros(groups, np.int32)
        self._h_hb = np.zeros(groups, np.int32)
        timers = self._read_rows(self.state.timeout, self.state.alive)
        self._h_timeout = timers[0].astype(np.int32)
        self._h_alive = timers[1].astype(bool)
        self._wake_role, self._wake_leader = self._h_role, self._h_leader
        # Scheduler observability (read by bench_engine's active-set rows):
        # ticks run compacted vs through the dense fallback, the summed
        # active-row count and the rows of the buckets gathered (padding
        # included; an all-quiescent tick gathers none), and the timer
        # refetches (the one host wait a tick_begin may make).
        self.active_sched_ticks = 0
        self.active_sched_rows = 0
        self.active_bucket_rows = 0
        self.active_fallback_ticks = 0
        self.active_refetches = 0
        self._last_wake_rows = 0
        # Per-shard wake counts of the last schedule (mesh engines): backs
        # the raft_active_wake_fraction{shard=} gauges.
        self._last_wake_shard: np.ndarray | None = None
        self._last_bucket_k = 0
        self._sched_mode: str | None = None
        # Adaptive outbox-compaction capacity: grows x8 on overflow and
        # shrinks a level after 64 quiet ticks. The fetch each tick is the
        # FULL capacity buffer, so without the shrink one cold-start
        # election burst would leave every idle tick fetching a burst-sized
        # buffer.
        self._k_out = min(4096, groups)
        self._k_out_quiet = 0  # consecutive ticks with total << capacity
        # Per-src transport liveness: tick of the last frame (of any kind,
        # including MSG_PING) received from each slot. Drives peer_fresh —
        # the aggregate keepalive that lets leaders stagger per-group
        # heartbeats without election timers firing (see node_step).
        self._h_src_seen = np.full(self.N, -(10 ** 9), np.int64)
        self.keepalive_window_ticks = 2
        # Largest dispatch window ever requested (monotone): scales the
        # keepalive freshness horizon so peers pinging once per K-tick
        # window stay "fresh" even while WE step single ticks.
        self._window_hint = 1

        self._pending_msgs: list[rpc.WireMsg] = []
        self._pending_batches: list[rpc.MsgBatch] = []
        # (payload, future, submit device tick, request span, submit ns) —
        # the tick stamp feeds the proposal→commit latency histogram at mint
        # time; the span (None unless request_spans minted a trace context
        # for this request, utils/spans.py) rides the queue; the host-clock
        # stamp (0 unless the profiler is enabled) opens the commit_queue
        # span.
        self._proposals: dict[
            int, list[tuple[bytes, asyncio.Future | None, int, object, int]]] = {}
        # Groups with a non-empty proposal queue, kept in lockstep with
        # _proposals so the per-tick builders touch only pending groups.
        self._prop_groups: set[int] = set()
        # Conf-change bookkeeping: block-id-keyed commit waiters, the
        # single-in-flight guard (leader side), and conf notifications
        # produced outside tick() (snapshot install) for the next TickResult.
        self._conf_waiters: dict[int, asyncio.Future] = {}
        # Seed the single-change-in-flight guard from the uncommitted suffix
        # of group 0.
        self._conf_pending: int | None = self._scan_conf_pending()
        self._conf_notify: list[ConfChange] = []
        # App-layer conf-apply hook (node-wired after construction, so
        # restart replay cannot fire it).
        self.on_conf_applied = None
        # Rows recycled DURING the current tick (a claim committing on
        # group 0 fires the recycle hook mid-loop): the rest of this tick
        # must not touch them — their scalar mirror/outbox snapshots predate
        # the reset.
        self._recycled_this_tick: set[int] = set()
        # Send-pointer re-roots recorded by the outbox decoder (AE frames
        # capped at max_append_entries), applied as ONE scatter by the NEXT
        # tick_begin (_drain_nxt_fixups) — never at decode time, which
        # would touch device state while tick_pipelined has the next
        # dispatch in flight. _reset_group purges a reset row's entries.
        self._nxt_fixups: list[tuple[int, int, int]] = []
        # Per-tick phase profiler (inbox / stage / dispatch / fetch /
        # decode / apply). NULL_PROFILER's phase() is a shared no-op
        # context manager; enable_profiling() swaps in a recording one.
        self.profiler = NULL_PROFILER
        # Device-resident delivery (raft/route.py): a RouteFabric attaches
        # itself here via register(); None = every message rides the host
        # decode/encode path. Per-tick routed state lives between a
        # consume (tick_begin) and the dispatch it merges into:
        # _routed_plane is the device (9, P, N) inbox plane, _routed_kinds
        # its host (P, N) kind mirror (occupancy / wake / stamps).
        # _route_dirty tells peers this engine deferred inbox claims at
        # its last begin — routing toward it would invert the
        # deferred-beats-new slot precedence, so they hold off one tick.
        self._fabric = None
        self._route_dirty = False
        self._routed_plane = None
        self._routed_kinds: np.ndarray | None = None
        self.routed_msgs = 0
        self._c_routed = _m_routed.bind(node=self.self_id)
        # Device payload ring (raft/payload_ring.py, attached via the
        # fabric when RouteFabric(payload_ring=True)): _routed_blocks holds
        # the ring-fed payload spans consume() handed this tick_begin (they
        # seed the dispatch's staged-block dict, so the receiver's chain
        # adoption walks them exactly like wire-decoded spans);
        # _ring_stage_decode defers decode-time staging (capped catch-up
        # reads) to the NEXT tick's stage batch — staging inside decode
        # would run between this tick's route and its flush barrier, where
        # a scatter could tear a slot the barrier's gather is about to
        # read. flight_ring_spill gates the ring_spill journal event.
        self._routed_blocks: dict[int, list] | None = None
        self._ring_stage_decode: list[tuple[int, object]] = []
        self._flight_ring_spill = bool(flight_ring_spill)
        # Request-scoped spans (default off): when on, propose() reads the
        # ambient trace context (utils/spans.py contextvar) and the
        # mint/commit/apply sites stamp the span's phase rungs.
        self._request_spans = bool(request_spans)
        # Tick-denominated leader leases (raft/lease.py): host-derived from
        # quorum-ack evidence the tick-finish fetches anyway, and
        # observation-only with respect to the step (nothing in it reads
        # lease state, so leases-on wire traffic equals leases-off).
        # _lease_plane is the (P, 3) device mirror [holder, expiry, term],
        # scatter-refreshed for changed rows; None until the first lease
        # row changes.
        self._flight_lease = bool(flight_lease)
        self._lease: LeaseLane | None = None
        self._lease_plane = None
        if leases:
            check_lease_params(self.params)
            self._lease = LeaseLane(self.P, self.N, self.me, _tmin)
        self._c_leased = m_reads_leased.bind(node=self.self_id)
        # Pipelined-tick state: the in-flight tick handle (tick_pipelined's
        # double buffer), the dispatch-in-flight flag (True from tick_begin
        # until the tick's device fetch materializes), and host-side
        # messages (snapshot chunks/acks) deferred while a tick is in
        # flight — staging them mid-flight would mutate chain/device rows
        # the outstanding dispatch already snapshotted.
        self._pipeline_h: dict | None = None
        self._tick_inflight = False
        self._deferred_host: list[rpc.WireMsg] = []
        # Consensus flight recorder (always on — emission sites are
        # transitions tick_finish already detects by diffing the host
        # mirrors, so steady-state ticks append nothing).
        self.flight = FlightRecorder(capacity=flight_ring)
        # Wire-level trace events (flight_wire, default off): msg_sent at
        # the outbox decode and msg_delivered at inbox consumption.
        self._flight_wire = bool(flight_wire)
        # The tick stamp for delivered events of the dispatch being begun:
        # the completing tick of that dispatch (self._ticks + window).
        self._wire_tick = 0
        # Open commit-latency entries, leader-side: group -> deque of
        # (block id, submit device tick, span, staging ns) for blocks this
        # node minted whose commit has not yet been observed. Purged on
        # group reset.
        self._lat_open: dict[int, deque] = {}
        self._h_commit_lat = _m_commit_lat.bind(node=self.self_id)
        # Group-row tenant tags (workload attribution). Cleared on recycle.
        self._group_tags: dict[int, str] = {}
        # While a tick_finish runs, the journal stamp for anything it
        # triggers is the COMPLETING tick — self._ticks only increments at
        # the end.
        self._flight_now: int | None = None
        # Health plane (utils/health.py, default off): a node-local
        # HealthMonitor evaluated once per completed tick off the host
        # mirrors — zero extra device fetches.
        self.health = (HealthMonitor(groups=groups, node=self.self_id)
                       if health else None)
        REGISTRY.add_collect_hook(self, RaftEngine._publish_telemetry)

    def _flight_tick(self) -> int:
        """Journal tick stamp: the completing tick while a finish is in
        progress (see _flight_now), the last completed tick otherwise."""
        return self._ticks if self._flight_now is None else self._flight_now

    def _publish_telemetry(self) -> None:
        """Scrape-time gauge refresh (Registry collect hook; held via a
        weakref so replaced engines retire their publishers)."""
        node = self.self_id
        _m_pipe_depth.set(1 if self._pipeline_h is not None else 0, node=node)
        _m_inbox_backlog.set(
            len(self._pending_msgs) + len(self._deferred_host)
            + sum(len(b) for b in self._pending_batches), node=node)
        _m_kout.set(self._k_out, node=node)
        _m_flight_seq.set(self.flight.seq, node=node)
        if self._fabric is not None:
            r = self._fabric.rings.get(self.me)
            if r is not None:
                _m_ring_occ.set(r.occupancy(), node=node)
        if self._lease is not None:
            _m_lease_held.set(self._lease.valid_count(), node=node)
        if self._active_set:
            _m_wake_frac.set(
                round(self._last_wake_rows / max(1, self.P), 6), node=node)
            if self._mesh is not None and self._last_wake_shard is not None:
                # Per-shard wake fractions (the sharded scheduler's skew
                # view): shard s woke counts[s] of its P/shards rows.
                for s, c in enumerate(self._last_wake_shard):
                    _m_wake_frac.set(round(int(c) / max(1, self._shard_rows), 6),
                                     node=node, shard=s)
            _m_bucket.set(self._last_bucket_k, node=node)
            _m_sched_ticks.set(self.active_sched_ticks, node=node)
            _m_fallback_ticks.set(self.active_fallback_ticks, node=node)
            _m_sched_rows.set(self.active_sched_rows, node=node)
        if self.profiler.enabled:
            for phase, s in self.profiler.snapshot().items():
                _m_phase_ms.set(s["total_ms"], node=node, phase=phase)

    def commit_latency(self) -> dict:
        """This node's proposal→commit latency summary in device ticks
        ({n, p50, p99, sum}), from the product-path histogram."""
        return _m_commit_lat.summary(node=self.self_id)

    def set_group_tag(self, g: int, tag: str | None) -> None:
        """Attribute group ``g``'s leader-side commit latency to ``tag``.
        ``None`` clears. Attribution only — never replicated, never
        journaled."""
        if not (0 <= g < self.P):
            raise ValueError(f"group {g} out of range (P={self.P})")
        if tag is None:
            self._group_tags.pop(g, None)
        else:
            self._group_tags[g] = str(tag)

    def group_tag(self, g: int) -> str | None:
        return self._group_tags.get(g)

    def proposal_backlog(self, group: int) -> int:
        """Queued-but-unminted proposals for ``group`` (the broker's
        admission gate)."""
        return len(self._proposals.get(group, ()))

    def enable_profiling(self, ring: int = 512) -> PhaseProfiler:
        """Attach (and return) a recording phase profiler; idempotent.
        Besides the tick's phases it records two spans per proposal on the
        host clock, ``commit_queue`` (``propose`` to the ``tick_begin``
        that stages it) and ``commit_replicate`` (staging to the leader's
        ``tick_finish`` that sees it commit), and collector pauses inside a
        phase as ``<phase>/gc``. Under a recording ``torch.profiler`` each
        phase is also a range named ``raft.<phase path>``."""
        if self.profiler is NULL_PROFILER:
            self.profiler = PhaseProfiler(ring=ring, ranges="raft.")
        return self.profiler

    # ------------------------------------------------------------ intake

    def receive(self, msg) -> None:
        """Queue a consensus wire message (or columnar batch) for the next
        tick. Malformed AE spans are dropped here (see module invariant).
        InstallSnapshot is handled immediately, host-side — it never enters
        the device inbox."""
        if isinstance(msg, rpc.MsgBatch):
            self._receive_batch(msg)
            return
        if 0 <= msg.src < self.N:
            self._h_src_seen[msg.src] = self._ticks
        if msg.kind == rpc.MSG_PING:
            return  # pure keepalive: the liveness stamp above is its payload
        if msg.kind in (rpc.MSG_SNAPSHOT, rpc.MSG_SNAPSHOT_ACK):
            if self._tick_inflight:
                # A snapshot install/ack mutates chain + device rows the
                # in-flight dispatch already snapshotted. Defer to the next
                # quiesced tick_begin.
                self._deferred_host.append(msg)
                self.flight.emit(self._ticks, "pipeline_defer",
                                 group=msg.group, msg_kind=msg.kind,
                                 src=msg.src)
                return
            if not self._inc_ok(msg):
                return
            if msg.kind == rpc.MSG_SNAPSHOT:
                self._stage_snapshot(msg)
            else:
                self._handle_snap_ack(msg)
            return
        if msg.kind not in _CONSENSUS_KIND_SET:
            raise ValueError(f"engine.receive: not a consensus message kind {msg.kind}")
        if not msg.span_is_valid():
            log.warning("dropping AE with invalid span g=%d src=%d", msg.group, msg.src)
            return
        if not (0 <= msg.group < self.P) or not (0 <= msg.src < self.N):
            log.warning("dropping message for unknown group/node g=%d src=%d", msg.group, msg.src)
            return
        if not self._inc_ok(msg):
            return
        if msg.kind in _PAROLE_DROP_KINDS and msg.group in self._parole:
            return  # on vote parole: abstain from elections (see _reset_group)
        if (self._lease is not None and msg.kind == rpc.MSG_APPEND_RESP
                and msg.ok):
            # Lease evidence: an accepted-append ack drains the (group,
            # src) ship queue (raft/lease.py) — pure host observation,
            # the message still rides the inbox unchanged.
            self._lease.credit(msg.group, msg.src, msg.x, msg.term)
        self._c_in.inc()
        self._pending_msgs.append(msg)

    def _inc_ok(self, msg: rpc.WireMsg) -> bool:
        """Row-incarnation guard (consensus-group recycling): a frame
        stamped with a different incarnation than our local row belongs to
        the row's previous (or a newer) life — drop it."""
        if 0 <= msg.group < self.P and msg.inc != self._h_ginc[msg.group]:
            log.warning("dropping stale-incarnation frame g=%d inc=%d "
                        "(local %d) kind=%d", msg.group, msg.inc,
                        self._h_ginc[msg.group], msg.kind)
            return False
        return True

    def _receive_batch(self, b: rpc.MsgBatch) -> None:
        """Validate and queue a columnar batch. Per-entry checks mirror
        :meth:`receive`: group/src bounds, and AE span integrity for every
        entry that claims a payload span — an entry that fails is dropped
        without touching its siblings."""
        if not (0 <= b.src < self.N):
            log.warning("dropping batch from unknown src %d", b.src)
            return
        self._h_src_seen[b.src] = self._ticks
        if len(b) > 1 and not (np.diff(b.group) > 0).all():
            # Our own encoder emits strictly-ascending unique groups
            # (np.nonzero order); normalize anything else so the
            # searchsorted lookups below hold.
            order = np.argsort(b.group, kind="stable")
            b = rpc.MsgBatch(b.src, b.dst, b.group[order], b.kind_col[order],
                             b.term[order], b.x[order], b.y[order],
                             b.z[order], b.ok[order], b.blocks,
                             inc=b.inc[order])
            dup = np.zeros(len(b), bool)
            dup[1:] = b.group[1:] == b.group[:-1]
            if dup.any():
                b = b.take(~dup)
        inb = (b.group >= 0) & (b.group < self.P)
        # Same whitelist as the single-message path: only device consensus
        # kinds may enter the inbox.
        inb &= np.isin(b.kind_col, _CONSENSUS_KINDS)
        # Row-incarnation guard: entries stamped with another incarnation
        # belong to a recycled row's previous life.
        inb &= self._h_ginc[np.clip(b.group, 0, self.P - 1)] == b.inc
        if self._parole:
            # Vote parole: a reset group abstains from elections until its
            # head is re-replicated past its pre-reset ack watermark.
            par = np.fromiter(self._parole, dtype=b.group.dtype,
                              count=len(self._parole))
            inb &= ~(np.isin(b.kind_col, _PAROLE_DROP_ARR)
                     & np.isin(b.group, par))
        if not inb.all():
            log.warning("dropping %d batch entries (unknown group, "
                        "non-consensus kind, or stale incarnation) src=%d",
                        int((~inb).sum()), b.src)
            b = b.take(inb)
        # AE span integrity, same rules as WireMsg.span_is_valid: an entry
        # claiming a span (x != y) must carry a parent-linked payload chain
        # from x to y; a pure heartbeat (x == y) must carry NO blocks.
        bad: list[int] = []
        ae = np.nonzero((b.kind_col == rpc.MSG_APPEND) & (b.x != b.y))[0]
        for i in ae.tolist():
            grp = int(b.group[i])
            if grp not in b.blocks:
                bad.append(grp)  # claims a span, carries no payload
        for grp, blks in b.blocks.items():
            i = int(np.searchsorted(b.group, grp))
            if (i >= len(b.group) or int(b.group[i]) != grp
                    or int(b.kind_col[i]) != rpc.MSG_APPEND
                    or not rpc._span_ok(int(b.x[i]), int(b.y[i]), blks)):
                bad.append(grp)  # orphan, non-AE, or broken/forged span
        if bad:
            log.warning("dropping AE with invalid span g=%s src=%d", bad, b.src)
            keep = ~np.isin(b.group, np.asarray(bad, dtype=b.group.dtype))
            b = b.take(keep)
            for grp in bad:
                b.blocks.pop(grp, None)
        if len(b):
            if self._lease is not None:
                am = (b.kind_col == rpc.MSG_APPEND_RESP) & (b.ok != 0)
                if am.any():
                    self._lease.credit_many(b.group[am], b.src, b.x[am],
                                            b.term[am])
            self._c_in.inc(len(b))
            self._pending_batches.append(b)
            # Backlog cap per src: beyond 4 pending frames, the OLDEST from
            # that src is dropped; Raft's retry covers whatever it carried.
            from_src = [i for i, pb in enumerate(self._pending_batches)
                        if pb.src == b.src]
            if len(from_src) > 4:
                dropped = self._pending_batches.pop(from_src[0])
                _m_backlog_dropped.inc(len(dropped), node=self.self_id)
                self.flight.emit(self._ticks, "backlog_drop",
                                 src=b.src, entries=len(dropped))
                log.warning("dropping stale batch backlog src=%d (%d entries)",
                            b.src, len(dropped))

    def propose(self, group: int, payload: bytes) -> asyncio.Future:
        """Submit a client payload; resolves with the FSM result once the
        block commits. Fails with NotLeader if this node cannot mint at
        tick time.

        A payload with the conf-change prefix is a membership mutation: it
        must target group 0, the leader assigns the node slot at mint time,
        and commit applies it to the member table instead of the app FSM.
        """
        fut = asyncio.get_running_loop().create_future()
        if is_conf(payload) and group != 0:
            fut.set_exception(ValueError("conf changes must go through group 0"))
            return fut
        if group in self._frozen_groups and not is_migration_fence(payload):
            # Dual-ownership window: this row is the source of a live
            # migration. Refuse with the same retryable error as a deposed
            # leader; the migration FENCE itself must still commit.
            fut.set_exception(NotLeader(group, -1))
            return fut
        span = None
        if self._request_spans:
            # Trace context (utils/spans.py): submit time closes the span's
            # admission phase and opens the queue phase.
            span = current_span()
            if span is not None:
                span.mark("admitted", self._ticks)
                span.group = group
        # The third slot is the submit device tick — tick_finish stamps it
        # onto the minted block for the proposal→commit latency histogram.
        # graftlint: allow(det-wallclock) — profiling plane only: the commit_queue span's start, never journaled
        t_prop = time.perf_counter_ns() if self.profiler.enabled else 0
        self._proposals.setdefault(group, []).append(
            (payload, fut, self._ticks, span, t_prop))
        self._prop_groups.add(group)
        return fut

    def propose_conf(self, change: ConfChange) -> asyncio.Future:
        """Propose a membership change (resolved at commit)."""
        return self.propose(0, change.encode())

    # -------------------------------------------------------------- tick

    def tick(self, window: int = 1) -> TickResult:
        if self._pipeline_h is not None:
            raise RuntimeError(
                "pipelined tick in flight; call tick_drain() before tick()")
        return self.tick_finish(self.tick_begin(window))

    def suggest_window(self, max_window: int) -> int:
        """Adaptive dispatch-window policy for driver loops.

        Returns ``max_window`` in steady state, 1 when the cluster needs
        the single-tick schedule:

        * any group I belong to is leaderless — elections MUST run
          single-tick: a window quantizes every randomized timeout to the
          window boundary, which de-randomizes candidacy collisions and
          livelocks convergence;
        * a snapshot transfer is in flight — each chunk ack would wait a
          whole window;
        * vote parole is active (tick_begin would clamp to 1 anyway).

        Pending inbox frames / proposals deliberately do NOT reduce the
        window: they apply at the window's first tick regardless.
        """
        # Apply the same hb_ticks clamp tick_begin will apply, so a driver
        # that sleeps window * tick_ms never sleeps longer than the engine
        # actually stepped.
        max_window = min(int(max_window), self._hb_ticks)
        if max_window > self._window_hint:
            # Remember the steady-state window for the keepalive horizon
            # (see _peer_fresh) even while this call returns 1.
            self._window_hint = max_window
        if max_window <= 1:
            return 1
        if self._snap_send_off or self._snap_staging or self._parole:
            return 1
        leaderless = (self._h_leader < 0) & self._mask_np[:, self.me]
        return 1 if leaderless.any() else int(max_window)

    def _peer_fresh(self, window: int = 1) -> np.ndarray:
        """(N,) transport-liveness vector: slots heard from within the
        keepalive window. Feeds the device's aggregate keepalive (see
        node_step peer_fresh). The freshness horizon scales with the
        cluster's STEADY-STATE window (the largest window this engine has
        been asked for), not the current dispatch: ping arrival spacing is
        set by the PEERS' windows."""
        horizon = self.keepalive_window_ticks * max(1, window, self._window_hint)
        fresh = (self._ticks - self._h_src_seen) <= horizon
        fresh &= self._active_vec()
        fresh[self.me] = False
        return fresh.astype(np.int32)

    # ------------------------------------------------- active-set scheduler

    def _schedule_active(self, window: int, pf: np.ndarray) -> np.ndarray | None:
        """Partition this tick's groups: returns the sorted active-set ids
        (rows a ``window``-tick dispatch could change beyond decay), or
        None to fall back to the dense/sparse dispatch (active fraction
        above ``active_fallback_frac``). Pure host work — no device wait
        except the one-off refetch after a fallback run.

        The set is the union of the predicate family:

        * :func:`packed_step.host_wake_mask` over the host mirrors —
          election-timer and heartbeat horizons, candidates, leaderless
          member rows;
        * host-known IO: pending wire messages/batches, queued proposals;
        * force-woken rows (reset/recycle, snapshot install, nxt fixups,
          claim changes — ``_force_active``);
        * rows dispatched but not yet adopted (``_sched_pending``): under
          tick_pipelined the next begin runs before the previous finish,
          so those rows' mirrors are one tick stale — keeping them active
          makes the staleness harmless (their fresh state is on device).
        """
        role, leader = self._h_role, self._h_leader
        if self._timers_stale:
            role, leader = self._refetch_wake_inputs()
            self._timers_stale = False
        # _decay_mirrors must advance the quiescent timers with the same
        # role/leader view the device decay sees (post-step on a fallback
        # re-entry tick), not the possibly-stale mirrors.
        self._wake_role, self._wake_leader = role, leader
        wake = host_wake_mask(
            self._hb_ticks, role, leader,
            self._h_elapsed, self._h_timeout, self._h_hb, self._h_alive,
            self._mask_np[:, self.me], pf, window)
        for b in self._pending_batches:
            wake[b.group] = True
        if self._pending_msgs:
            wake[np.fromiter((m.group for m in self._pending_msgs),
                             np.intp, len(self._pending_msgs))] = True
        if self._prop_groups:
            wake[np.fromiter(self._prop_groups, np.intp,
                             len(self._prop_groups))] = True
        if self._routed_kinds is not None:
            # Device-routed inbox rows: pending IO exactly like a host
            # message, just resident on the device already.
            wake |= self._routed_kinds.any(axis=1)
        if self._force_active:
            fa = [g for g in self._force_active if 0 <= g < self.P]
            if fa:
                wake[fa] = True
            # Cleared even on fallback below: the dense step covers every
            # row, which is exactly what a force-wake asks for.
            self._force_active.clear()
        for gp in self._sched_pending:
            wake[gp] = True
        G = np.nonzero(wake)[0]
        self._last_wake_rows = len(G)  # scrape-time wake-fraction gauge
        if self._mesh is not None:
            # Per-shard wake split (telemetry; the plan recomputes its own
            # counts from the same G).
            self._last_wake_shard = np.bincount(G // self._shard_rows,
                                                minlength=self._shards)
        if len(G) > self.active_fallback_frac * self.P:
            return None
        return G

    def _refetch_wake_inputs(self) -> tuple[np.ndarray, np.ndarray]:
        """Re-entering active mode after a dense/sparse fallback tick: those
        steps return no timers, so read elapsed/timeout/hb_elapsed into the
        timer mirrors, and role/leader as LOCALS, in one transfer of five
        (P,) vectors. This is the one place ``tick_begin`` waits for the
        device (mode transitions only, never steady state).

        Role/leader never go into the mirrors: under tick_pipelined this
        begin runs BEFORE the fallback tick's finish, whose mirror diff
        (lost_leadership, NotLeader waiter drops) needs the pre-step
        baseline, while the predicate needs the post-step values (a
        follower that reached candidacy during the dense tick must not read
        as a quiescent follower). tick_finish never diffs the timer
        mirrors, so overwriting them is safe even with that finish
        pending."""
        st = self.state
        with self.profiler.phase("refetch"):
            v = self._read_rows(st.elapsed, st.timeout, st.hb_elapsed, st.role, st.leader)
        self.active_refetches += 1
        self._h_elapsed = v[0].copy()
        self._h_timeout = v[1].copy()
        self._h_hb = v[2].copy()
        return v[3].astype(np.int64), v[4].astype(np.int64)

    def _step_active(self, G: np.ndarray, k: int, plan, vals: np.ndarray,
                     pf: np.ndarray, window: int, prof):
        """The active set's device step: the all-quiescent decay when ``G``
        is empty, else the compacted tick over the bucket of ``k`` rows
        (``plan`` a mesh engine's). Returns (new full state, flat output,
        outbox view, upload bytes), the flat and the view None when nothing
        was gathered."""
        if not len(G):
            # Decay IS the device step; nothing to gather, step, or fetch.
            # (Routed rows are forced awake by the scheduler, so a pending
            # routed plane implies a row.)
            return self._runner.decay(self.state, pf, window, prof), None, None, 0
        new_state, flat, ov = self._runner.compacted(
            self.state, self.member, G, k, plan, vals, pf, window, self._routed_plane, prof)
        # Per shard: the bucket's int32 ids and its (10, k, N) int32 inbox.
        return new_state, flat, ov, self._shards * k * (1 + 10 * self.N) * 4

    # ------------------------------------------------------- mesh engines

    def _read_rows(self, *leaves) -> np.ndarray:
        """(k, P, ...) int32 host copy of k state leaves (a device wait, so
        never in ``tick_begin``'s steady state): on a mesh engine read shard
        by shard and joined along P."""
        if self._mesh is None:
            return torch.stack([a.to(torch.int32) for a in leaves]).cpu().numpy()
        return np.concatenate(
            [torch.stack([a.parts[s].to(torch.int32) for a in leaves]).cpu().numpy()
             for s in range(self._shards)], axis=1)

    def _hold_rows(self, hold: np.ndarray, leaf):
        """``where(hold, 0, leaf)`` over a (P,) leaf as a new tensor; on a
        mesh engine per shard, the shards with no held row keep their
        block."""
        if self._mesh is None:
            return torch.where(host_to(hold, self._device), 0, leaf)
        L = self._shard_rows
        parts = list(leaf.parts)
        for s, part in enumerate(parts):
            h = hold[s * L:(s + 1) * L]
            if h.any():
                parts[s] = torch.where(host_to(h, part.device), 0, part)
        return sh.Shards(parts)

    def _decay_mirrors(self, G: np.ndarray, window: int, pf: np.ndarray) -> None:
        """Host twin of the device decay, applied to the QUIESCENT rows'
        timer mirrors (active rows adopt theirs from the 13-row mirror
        fetch in tick_finish). Same integer arithmetic as
        ``chained_raft.decay_idle``, so the mirrors stay bit-exact. Reads
        the role/leader view _schedule_active just used (post-step locals
        on a fallback re-entry tick, the mirrors otherwise)."""
        role, leader = self._wake_role, self._wake_leader
        quiet = self._h_alive.copy()
        quiet[G] = False
        lead = np.clip(leader, 0, self.N - 1).astype(np.intp)
        hb8 = self._hb_ticks * 8
        ka = (leader >= 0) & (pf[lead] != 0) & (self._h_hb < hb8)
        new_e = np.where((role == LEADER) | ka, 0, self._h_elapsed + window)
        self._h_elapsed[quiet] = new_e[quiet].astype(np.int32)
        self._h_hb[quiet] += window

    def tick_begin(self, window: int = 1) -> dict:
        """Dispatch one tick's device step WITHOUT waiting for its results.

        Splitting begin/finish lets co-located engines (the in-process
        cluster) overlap their device work, and is what tick_pipelined
        builds its double buffer on. Contract: no group mutation between
        begin and finish of the same engine. receive() IS safe mid-flight:
        consensus traffic only queues, and host-side snapshot messages
        (which mutate chain/device rows) are deferred to the next quiesced
        tick_begin automatically.

        ``window > 1`` folds that many consecutive ticks into the one
        dispatch (see the window commentary in packed_step.py): the pending
        inbox applies at the window's first tick, the rest run quiet, and
        the merged outbox comes back in one fetch. Clamped to hb_ticks (the
        lossless-merge bound) and disabled while any group is on vote
        parole (the parole elapsed-hold is re-asserted per dispatch, so a
        long window would let a paroled timer run).
        """
        prof = self.profiler
        if self._deferred_host and not self._tick_inflight:
            # Host-side messages (snapshot chunks/acks) deferred while a
            # tick was in flight: the engine is quiesced here, stage them
            # before this tick's device step runs.
            pend, self._deferred_host = self._deferred_host, []
            for m in pend:
                self.receive(m)
        window = max(1, min(int(window), self._hb_ticks))
        if self._parole:
            window = 1
        if window > self._window_hint:
            self._window_hint = window
        # Delivered-event stamp for this dispatch (see _flight_wire note).
        self._wire_tick = self._ticks + window
        # Rows recycled since the last tick OUTSIDE of tick() were reset
        # before this tick's device step ran — this tick is already their
        # new incarnation and must NOT be suppressed.
        self._recycled_this_tick.clear()
        if self._parole:
            # Vote parole: hold every paroled group's election timer at
            # zero so it can never reach candidacy. Grant-suppression
            # happens at intake.
            pidx_l = list(self._parole)
            hold = np.zeros(self.P, bool)
            hold[pidx_l] = True
            self.state = self.state.replace(elapsed=self._hold_rows(
                hold, self.state.elapsed))
            # Keep the host timer mirror in lockstep with the device hold.
            self._h_elapsed[pidx_l] = 0
        if self._nxt_fixups:
            # Last tick's AE-cap send-pointer re-roots, as one scatter just
            # before the step reads state.nxt (see _drain_nxt_fixups).
            self._drain_nxt_fixups()
        if self._fabric is not None:
            # Consume the device-routed inbox plane promoted at the
            # driver's last delivery barrier: the kind mirror backs the
            # wake predicate, the builders' occupancy deferral, and the
            # per-(group, src) delivery stamp; the plane itself merges
            # under the host residual inside the window step.
            with prof.phase("route"):
                (self._routed_plane, self._routed_kinds, rterms,
                 self._routed_blocks) = self._fabric.consume(self.me)
                if self._routed_kinds is not None:
                    gi, si = np.nonzero(self._routed_kinds)
                    self._h_last_seen[gi, si] = self._ticks
                    if self._flight_wire and rterms is not None and len(gi):
                        # Routed inbox consumption: the kind/term mirrors
                        # the fabric maintains ARE the delivered rows.
                        self.flight.emit_many(
                            self._wire_tick, "msg_delivered", gi,
                            rterms[gi, si], self._routed_kinds[gi, si],
                            si, self.me, "routed")
        pf = self._peer_fresh(window)
        rp = self._routed_plane
        runner = self._runner
        G = None
        if self._active_set:
            # "compact" is entered twice per eager compacted tick: the
            # predicate here and the runner's gather. A replayed tick
            # gathers inside "dispatch".
            with prof.phase("compact"):
                G = self._schedule_active(window, pf)
            if G is None:
                # Auto-fallback: the active fraction exceeds the threshold,
                # so run the plain dispatch below. It returns no timers, so
                # the mirrors go stale until the next active tick refetches.
                self._timers_stale = True
                self.active_fallback_ticks += 1
            else:
                self.active_sched_ticks += 1
                self.active_sched_rows += len(G)
            # Journal compacted<->dense transitions (not every tick).
            mode = "dense_fallback" if G is None else "compacted"
            if mode != self._sched_mode:
                if self._sched_mode is not None:
                    self.flight.emit(self._ticks, "active_mode_flip",
                                     from_mode=self._sched_mode, to_mode=mode,
                                     wake_rows=self._last_wake_rows)
                self._sched_mode = mode
        if G is not None:
            k, build_k, plan = runner.bucket(G)
            self._last_bucket_k = k
            if len(G):
                self.active_bucket_rows += k * self._shards
            with prof.phase("inbox"):
                # Compact-domain inbox: rows line up with the gathered
                # state rows (G is a superset of every pending group).
                vals, staged, deferred, deferred_b = self._build_inbox_active(G, build_k)
            new_state, flat, ov, upload = self._step_active(
                G, k, plan, vals, pf, window, prof)
            with prof.phase("decay"):
                self._decay_mirrors(G, window, pf)
            h = {"mode": "active", "G": G, "k": k, "plan": plan, "upload_bytes": upload}
            self._sched_pending.append(G)
        elif self._sparse:
            with prof.phase("inbox"):
                # Proposal staging (sparse row 9) happens in _pack_inbox_rows.
                idx, vals, staged, deferred, deferred_b = self._build_inbox_sparse()
            new_state, flat, sv, ov = runner.sparse(
                self.state, self.member, self._k_out, idx, vals, pf, window, rp, prof)
            # sv/ov stay on the device; tick_finish fetches them only on a
            # compaction overflow.
            h = {"mode": "sparse", "sv": sv, "k_out": self._k_out,
                 "upload_bytes": int(idx.nbytes + vals.nbytes)}
        else:
            with prof.phase("inbox"):
                in10, staged, deferred, deferred_b = self._build_inbox()
            with prof.phase("stage"):
                if self._prop_groups:
                    prop_groups = list(self._prop_groups)
                    pg = np.asarray(prop_groups, np.intp)
                    self._scatter_proposal_counts(in10[9], pg, prop_groups)
                if self._flight_wire:
                    # Same occupancy pass, nonzero form: the stamp AND the
                    # delivered trace come from one scan.
                    gi, si = np.nonzero(in10[0])
                    self._h_last_seen[gi, si] = self._ticks
                    if len(gi):
                        self.flight.emit_many(
                            self._wire_tick, "msg_delivered", gi,
                            in10[1][gi, si], in10[0][gi, si],
                            si, self.me, "host")
                else:
                    self._h_last_seen[in10[0] != rpc.MSG_NONE] = self._ticks
            new_state, flat, ov = runner.dense(
                self.state, self.member, in10, pf, window, rp, prof)
            h = {"mode": "dense", "upload_bytes": int(in10.nbytes)}
        if self._routed_blocks:
            # Ring-fed payload spans (consumed above): pre-staged blocks
            # for exactly this dispatch — tick_finish's chain adoption
            # walks them like wire-decoded spans, no host decode involved.
            for g, blks in self._routed_blocks.items():
                staged.setdefault(g, []).extend(blks)
        self._routed_blocks = None
        # The step's own outbox stays on the device: the route fabric
        # scatters from it in this tick's finish (route.py _src_ov). The
        # tick's device->host copy starts now; tick_fetch waits for it alone.
        h["fetch_bytes"] = _numel(flat) * 4
        flat, ready = runner.fetch(flat)
        h.update(ov=ov, flat=flat, ready=ready, staged=staged, window=window)
        self.state = new_state
        self._pending_msgs = deferred
        self._pending_batches = deferred_b
        # Peers consult this before routing toward us: deferred carry-over
        # claims slots FIRST at our next begin, and a routed row must never
        # invert that precedence — so for one tick they use the host path.
        self._route_dirty = bool(deferred or deferred_b)
        # The routed plane is consumed by exactly this dispatch.
        self._routed_plane = None
        self._routed_kinds = None
        # Snapshot the proposal queues INTO the tick handle: the device was
        # told exactly these counts (inbox row 9), so tick_finish must mint
        # and resolve exactly these payloads. A proposal enqueued between
        # begin and finish stays in self._proposals for the NEXT tick.
        props = h["props"] = {g: self._proposals.pop(g) for g in list(self._prop_groups)}
        self._prop_groups.clear()
        # Staging time on the host clock: it rides the minted blocks'
        # commit-latency entries to the commit_replicate span. One read per
        # tick that stages, taken with profiling off too, so the proposals
        # in flight when a profiler is enabled still close their span.
        # graftlint: allow(det-wallclock) — profiling plane only: the commit spans' staging stamp, never journaled
        h["t_stage"] = t_stage = time.perf_counter_ns() if props else 0
        if prof.enabled:
            for queue in props.values():
                for p in queue:
                    if p[4]:
                        prof.add_ns("commit_queue", t_stage - p[4])
        self._tick_inflight = True
        return h

    def tick_fetch(self, h: dict) -> dict:
        """Materialize the tick's device→host transfer (blocking) WITHOUT
        any of the host-side mirror/decode work. Idempotent; tick_finish
        calls it implicitly. Pipelined drivers call it explicitly so the
        next tick_begin can dispatch before tick_finish's host work runs
        (the host work then overlaps the new dispatch's device compute)."""
        if "flat_np" not in h:
            with self.profiler.phase("fetch"):
                for ev in h.pop("ready"):
                    ev.synchronize()
                # flat is None on an all-quiescent active tick (nothing to
                # fetch: the decay program is the whole device step).
                h["flat_np"] = self._runner.join(h)
            self._tick_inflight = False
        return h

    def tick_pipelined(self, window: int = 1) -> TickResult:
        """Double-buffered tick: fetch tick t's results, dispatch tick t+1,
        THEN run tick t's host-side finish (decode, chain append, FSM apply)
        while the device computes t+1.

        Returns tick t's TickResult — an empty one on the priming call, and
        the pipeline stays one tick deep thereafter. Outbound messages
        therefore reach peers one tick later than under tick(), per message
        hop. Deferred host-side messages (snapshot chunks) quiesce the
        pipeline for one round: tick t finishes fully before t+1
        dispatches. Call tick_drain() before switching back to tick()."""
        prev = self._pipeline_h
        self._pipeline_h = None
        res: TickResult | None = None
        if prev is not None:
            self.tick_fetch(prev)  # wait out tick t's device step
            if self._deferred_host:
                # Snapshot traffic needs a quiesced engine: close out tick
                # t before tick_begin stages it and dispatches t+1.
                res = self.tick_finish(prev)
                prev = None
        h = self.tick_begin(window)
        # Publish the in-flight handle BEFORE tick t's finish runs: a group
        # reset/recycle inside that finish happens AFTER tick t+1's state
        # was snapshotted by the dispatch, so _reset_group records the row
        # on THIS handle (skip_rows) and finish(t+1) discards its stale
        # fetched values.
        self._pipeline_h = h
        if prev is not None:
            res = self.tick_finish(prev)  # overlaps t+1's device compute
        return res if res is not None else TickResult()

    def tick_drain(self) -> TickResult | None:
        """Finish the in-flight pipelined tick (shutdown / mode switch);
        None if the pipeline is empty."""
        h, self._pipeline_h = self._pipeline_h, None
        return self.tick_finish(h) if h is not None else None

    @property
    def pipeline_window(self) -> int:
        """Ticks the in-flight pipelined dispatch will execute — 0 when the
        pipeline is empty."""
        return int(self._pipeline_h["window"]) if self._pipeline_h else 0

    def tick_finish(self, h: dict) -> TickResult:
        try:
            return self._tick_finish(h)
        finally:
            # Always restore the out-of-tick journal stamp — an exception
            # mid-finish must not freeze later forensic emits at the dead
            # tick.
            self._flight_now = None

    def _tick_finish(self, h: dict) -> TickResult:
        self.tick_fetch(h)  # no-op if the pipelined driver already fetched
        # Rows reset/recycled AFTER this tick was dispatched but before
        # this finish (pipelined mode) — their fetched values predate the
        # reset exactly like a mid-tick recycle.
        self._recycled_this_tick |= h.pop("skip_rows", set())
        staged = h["staged"]
        # The proposal queues THIS tick presented to the device (snapshotted
        # by tick_begin); self._proposals may already hold newer entries for
        # the next tick and must not be touched here.
        props = h["props"]
        prop_gs = set(props)
        # Normalize every fetch mode to COMPACT row arrays: ``proc`` holds
        # the group ids needing host work and the v/ov_c arrays their
        # fetched values, position-aligned. Sparse mode never materializes
        # dense (10, P)/(9, P, N) views.
        if h["mode"] == "active":
            # Compact fetch over the scheduled rows: the (13, A) mirror
            # (the dense 10 plus elapsed/timeout/hb_elapsed, adopted into
            # the host timer mirrors below) and the (9, A, N) outbox.
            # ``proc`` IS the active set — sorted ascending, a superset of
            # every row needing host work and of every proposal group.
            proc = h["G"].astype(np.int64, copy=False)
            A = len(proc)
            if A and h["plan"] is not None:
                # Mesh engine: the per-shard flats, picked back into G
                # order; the psum lane must count the whole schedule.
                sv13, ov_c, total = h["plan"].gather_flat(h["flat_np"], self.N)
                if total != A:
                    raise RuntimeError(f"psum lane counted {total} scheduled rows, "
                                       f"the schedule has {A}")
            elif A:
                flat = h["flat_np"]
                cut = _MIRROR13_ROWS * h["k"]
                sv13 = (flat[:cut].reshape(_MIRROR13_ROWS, h["k"])
                        [:, :A].astype(np.int64))
                ov_c = flat[cut:].reshape(9, h["k"], self.N)[:, :A, :]
            else:
                # All-quiescent tick: the decay program was the whole step.
                sv13 = np.zeros((13, 0), np.int64)
                ov_c = np.zeros((9, 0, self.N), np.int32)
            v = sv13[:10]
            dense = False
        elif h["mode"] == "dense":
            # ONE flat fetch holding the (10, P) scalar mirror and the
            # (9, P, N) outbox.
            flat = h["flat_np"]
            cut = 10 * self.P
            sv = flat[:cut].reshape(10, self.P).astype(np.int64, copy=False)
            ov = flat[cut:].reshape(9, self.P, self.N)
            dense = True
        else:
            flat = h["flat_np"]
            k_out = h["k_out"]
            total = int(flat[0])
            C = 10 + 9 * self.N
            if total > k_out:
                # Compaction overflow (burst bigger than capacity):
                # fetch the dense device-resident outputs — correct, just
                # a bigger transfer — and grow the bucket.
                with self.profiler.phase("fetch"):
                    sv32 = _read_joined(h["sv"], axis=1)
                    ov = _read_joined(h["ov"], axis=1)
                # Counted at the int32 wire width, before the int64 cast.
                sv = sv32.astype(np.int64, copy=False)
                h["fetch_bytes"] += sv32.nbytes + ov.nbytes
                dense = True
                while self._k_out < min(self.P, total):
                    self._k_out = min(self.P, self._k_out * 8)
                self._k_out_quiet = 0
                log.info("sparse outbox overflow (%d > %d); capacity now %d",
                         total, k_out, self._k_out)
            else:
                rows_g = flat[1:1 + k_out][:total].astype(np.int64)
                buf = flat[1 + k_out:].reshape(k_out, C)[:total]
                dense = False
                # Shrink hysteresis: 64 consecutive ticks fitting the next
                # bucket down (with 2x headroom) drop one level; a burst
                # right after just regrows via the overflow fetch. The
                # target walks the SAME growth ladder (min(P, 4096 * 8^i)),
                # so shrink/regrow cycles only revisit its sizes.
                floor = min(4096, self.P)
                if k_out > floor:
                    target = floor
                    while min(self.P, target * 8) < k_out:
                        target = min(self.P, target * 8)
                    if total * 2 <= target:
                        self._k_out_quiet += 1
                        if self._k_out_quiet >= 64:
                            self._k_out = target
                            self._k_out_quiet = 0
                            log.info("sparse outbox quiet; capacity %d -> %d",
                                     k_out, self._k_out)
                    else:
                        self._k_out_quiet = 0
                else:
                    self._k_out_quiet = 0

        if h["mode"] == "active":
            pass  # proc / v / ov_c already compact, computed above
        elif dense:
            (n_term, n_voted, n_role, n_leader,
             n_head_t, n_head_s, n_commit_t, n_commit_s,
             minted_a, became_a) = sv
            head_all = (n_head_t << 32) | n_head_s
            commit_all = (n_commit_t << 32) | n_commit_s
            # Same predicate as the device-side sparse compaction: any
            # mirrored field moved (vote-only rows included — their
            # durable vol record and mirrors must update), outbox traffic,
            # plus rows with queued proposals.
            active = (became_a != 0) | (minted_a != 0)
            active |= head_all != self._h_head
            active |= commit_all != self._h_commit
            active |= n_role != self._h_role
            active |= n_leader != self._h_leader
            active |= (n_term != self._h_term) | (n_voted != self._h_voted)
            active |= (ov[0] != rpc.MSG_NONE).any(axis=1)  # outbox traffic
            if prop_gs:
                active[list(prop_gs)] = True
            proc = np.nonzero(active)[0].astype(np.int64)
            v = sv[:, proc]
            ov_c = ov[:, proc, :]
        else:
            # Fetched rows ⊇ rows needing work; proposal groups the device
            # left unchanged (no mint — we are not their leader) are
            # appended with mirror values so their futures still fail fast.
            fetched = set(rows_g.tolist())
            extra = np.asarray(sorted(prop_gs - fetched), np.int64)
            v = buf[:, :10].astype(np.int64).T           # (10, R)
            ov_c = buf[:, 10:].reshape(total, 9, self.N).transpose(1, 0, 2)
            proc = rows_g
            if len(extra):
                ev = np.stack([
                    self._h_term[extra], self._h_voted[extra],
                    self._h_role[extra], self._h_leader[extra],
                    self._h_head[extra] >> 32,
                    self._h_head[extra] & 0xFFFFFFFF,
                    self._h_commit[extra] >> 32,
                    self._h_commit[extra] & 0xFFFFFFFF,
                    np.zeros(len(extra), np.int64),
                    np.zeros(len(extra), np.int64),
                ])
                v = np.concatenate([v, ev], axis=1)
                ov_c = np.concatenate(
                    [ov_c, np.zeros((9, len(extra), self.N), ov_c.dtype)],
                    axis=1)
                proc = np.concatenate([proc, extra])
        (n_term, n_voted, n_role, n_leader,
         n_head_t, n_head_s, n_commit_t, n_commit_s, minted, became) = v
        head_new = (n_head_t << 32) | n_head_s
        commit_new = (n_commit_t << 32) | n_commit_s

        if self._parole:
            pos_of = {int(g): i for i, g in enumerate(proc)}
            # Lift parole once legitimate replication has carried the head
            # back past the pre-reset ack watermark: from here on the node's
            # chain again contains everything it ever acknowledged.
            for g, wm in list(self._parole.items()):
                pos = pos_of.get(g)
                head = int(head_new[pos]) if pos is not None else int(self._h_head[g])
                if head >= wm:
                    log.info("g=%d vote parole lifted (head %#x >= "
                             "watermark %#x)", g, head, wm)
                    self._lift_parole(g)

        res = TickResult()
        reset_rows: set[int] = set()
        # Payload-ring staging (fabric payload_ring on): every block this
        # finish mints or adopts is collected here and staged into the
        # sender ring in ONE batch just before the route phase — so the
        # AEs the device emitted for these blocks (this tick or later)
        # resolve as ring-resident and route on the device.
        ring = (self._fabric.rings.get(self.me)
                if self._fabric is not None else None)
        ring_pend: dict[int, list] = {}
        # The device tick that just completed (self._ticks increments at the
        # END of this finish) — the stamp for journal events and the commit-
        # latency clock. Published via _flight_now so emits INSIDE this
        # finish stamp the same tick.
        t_now = self._ticks + h.get("window", 1)
        self._flight_now = t_now
        prof = self.profiler
        with prof.phase("apply"):
            # Host work is only needed where host-visible state moved. Rows
            # whose only change is outbox traffic or term/vote are handled by
            # the vectorized passes below.
            need = ((became != 0) | (minted != 0)
                    | (head_new != self._h_head[proc])
                    | (commit_new != self._h_commit[proc])
                    | ((self._h_role[proc] == LEADER) & (n_role != LEADER)))
            if prop_gs:
                need |= np.isin(proc, np.fromiter(prop_gs, np.int64, len(prop_gs)))
            need_rows = np.nonzero(need)[0].tolist()
            for pos in need_rows:
                g = int(proc[pos])
                if g in self._recycled_this_tick:
                    # Recycled by a group-0 commit hook earlier in THIS loop
                    # (proc order is ascending, so group 0 comes first): every
                    # snapshot for this row predates the reset. Proposals
                    # snapshotted for the row at tick_begin must FAIL, not leak.
                    for _payload, fut, _t_sub, _span, _t_prop in props.pop(g, ()):
                        if fut is not None and not fut.done():
                            fut.set_exception(NotLeader(g, -1))
                    continue
                ch = self.chains[g]
                new_head = int(head_new[pos])

                # Leadership transitions.
                if became[pos]:
                    res.became_leader.append(g)
                    self.flight.emit(t_now, "election_won", group=g,
                                     term=int(n_term[pos]), leader=self.me)
                    noop = ch.append(int(n_term[pos]), b"")  # no-op liveness block
                    if ring is not None:
                        ring_pend.setdefault(g, []).append(noop)
                    if g == 0:
                        # A deposed leader's conf block may sit uncommitted in
                        # our log and commit later under us — re-arm the
                        # single-change-in-flight guard from the suffix.
                        self._conf_pending = self._scan_conf_pending()
                was_leader = self._h_role[g] == LEADER
                if was_leader and n_role[pos] != LEADER:
                    res.lost_leadership.append(g)
                    self.flight.emit(t_now, "leadership_lost", group=g,
                                     term=int(n_term[pos]),
                                     leader=int(n_leader[pos]))
                    drv = self.drivers.get(g)
                    if drv:
                        drv.drop_waiters(NotLeader(g, int(n_leader[pos])))
                    if g == 0:
                        self._conf_pending = None
                        for fut in self._conf_waiters.values():
                            if not fut.done():
                                fut.set_exception(NotLeader(g, int(n_leader[pos])))
                        self._conf_waiters.clear()

                # Minted payload blocks (leader): mirror device ids exactly.
                queue = props.get(g, [])
                if minted[pos]:
                    if minted[pos] != len(queue):
                        raise RuntimeError(
                            f"device minted {minted[pos]} blocks but host holds "
                            f"{len(queue)} payloads (group {g})"
                        )
                    for payload, fut, t_sub, span, _t_prop in queue:
                        conf_err = None
                        if is_conf(payload):
                            # Leader-side conf admission: assign the slot, and
                            # enforce one change in flight. The device already
                            # counted this mint, so a refused change still
                            # appends — as a harmless no-op block.
                            try:
                                if self._conf_pending is not None:
                                    raise ValueError(
                                        "a membership change is already in flight")
                                change = self.members.assign(ConfChange.decode(payload))
                                payload = change.encode()
                            except ValueError as e:
                                conf_err, payload = e, b""
                        blk = ch.append(int(n_term[pos]), payload)
                        if ring is not None:
                            ring_pend.setdefault(g, []).append(blk)
                        if span is not None:
                            # Queue phase closes at mint; the span rides the
                            # latency deque to the commit site.
                            span.mark("minted", t_now)
                            span.leader = self.self_id
                        # Open a commit-latency entry for the minted block,
                        # with the host time it was staged (block ids are
                        # appended in mint order, so the deque stays
                        # id-sorted).
                        lat_q = self._lat_open.get(g)
                        if lat_q is None:
                            lat_q = self._lat_open[g] = deque(maxlen=4096)
                        lat_q.append((blk.id, t_sub, span, h["t_stage"]))
                        drv = self.drivers.get(g)
                        if is_conf(payload):
                            self._conf_pending = blk.id
                            if fut is not None and not fut.done():
                                self._conf_waiters[blk.id] = fut
                        elif fut is not None and not fut.done():
                            if conf_err is not None:
                                fut.set_exception(conf_err)
                            elif drv is not None:
                                drv.notify(blk.id, fut)
                            else:
                                fut.set_result(b"")
                    props.pop(g, None)
                elif queue:
                    for _, fut, _, _, _ in queue:
                        if fut is not None and not fut.done():
                            fut.set_exception(NotLeader(g, int(n_leader[pos])))
                    props.pop(g, None)

                # Accepted spans (follower): reconcile the chain to the device's
                # new head by walking parent pointers through the staged blocks.
                # Only the branch the device actually adopted is persisted, in
                # ONE KV transaction (Chain.extend_many).
                if new_head != self._h_head[g] and not minted[pos] and not became[pos]:
                    by_id = {b.id: b for b in staged.get(g, [])}
                    path = []
                    cur = new_head
                    while not ch.has(cur):
                        blk = by_id.get(cur)
                        if blk is None:
                            raise RuntimeError(
                                f"chain/device divergence g={g}: no payload for {cur:#x}"
                            )
                        path.append(blk)
                        cur = blk.parent
                    path.reverse()
                    ch.extend_many(path)
                    if ring is not None and path:
                        # Adopted blocks stage too: a follower that later
                        # leads (or relays catch-up) serves them from its own
                        # ring instead of re-reading the chain.
                        ring_pend.setdefault(g, []).extend(path)
                    if ch.head != new_head:
                        ch.force_head(new_head)

                # Commit advancement -> FSM apply (half-open (old, new], every node).
                new_commit = int(commit_new[pos])
                if new_commit != ch.committed:
                    blocks = ch.commit(new_commit)
                    res.committed[g] = new_commit
                    _m_committed.inc(len(blocks), node=self.self_id)
                    committed_spans = []
                    lat_q = self._lat_open.get(g)
                    if lat_q:
                        # Leader-side commit latency: every open mint entry the
                        # commit id passes is either committed (observe) or was
                        # overwritten by another leader's branch (drop).
                        cids = {b.id for b in blocks}
                        tag = self._group_tags.get(g)
                        while lat_q and lat_q[0][0] <= new_commit:
                            bid, t_sub, span, t_stage = lat_q.popleft()
                            if bid in cids:
                                self._h_commit_lat.observe(t_now - t_sub)
                                if prof.enabled:
                                    # Staging to this answer: the commit_replicate span.
                                    # graftlint: allow(det-wallclock) — profiling plane only (off by default); timings feed /metrics, never the journal or state
                                    t_done = time.perf_counter_ns()
                                    prof.add_ns("commit_replicate", t_done - t_stage)
                                if span is not None:
                                    span.mark("committed", t_now)
                                    committed_spans.append(span)
                                if tag is not None:
                                    _m_commit_lat_tenant.observe(
                                        t_now - t_sub, node=self.self_id,
                                        tenant=tag)
                        if not lat_q:
                            self._lat_open.pop(g, None)
                    app_blocks = []
                    for blk in blocks:
                        if is_conf(blk.data):
                            self._apply_conf_block(g, blk, res)
                        else:
                            app_blocks.append(blk)
                    drv = self.drivers.get(g)
                    if drv:
                        try:
                            drv.apply(app_blocks)
                        except ReplicaDiverged as e:
                            # The FSM proved its local state cannot be the fold
                            # of the committed sequence: rewind the whole group
                            # to an empty replica (with vote parole) and let
                            # the leader re-sync it from scratch.
                            log.error("g=%d replica diverged (%s); resetting "
                                      "for full re-sync", g, e)
                            drv.drop_waiters(NotLeader(g, int(n_leader[pos])))
                            reset_fsm = getattr(drv.fsm, "reset", None)
                            if callable(reset_fsm):
                                reset_fsm()
                            self._reset_group(g)
                            self._h_head[g] = GENESIS
                            self._h_commit[g] = GENESIS
                            reset_rows.add(g)
                            continue
                    for span in committed_spans:
                        span.mark("applied", t_now)

                # Refresh the chain mirrors for this group (the active-row
                # selector above diffs against these next tick).
                self._h_head[g] = ch.head
                self._h_commit[g] = ch.committed

            # Durable volatile state: (term, voted_for) is ONE record written in
            # one put — a crash can never pair a new term with a stale vote.
            vol_changed = (n_term != self._h_term[proc]) | (n_voted != self._h_voted[proc])
            for pos in np.nonzero(vol_changed)[0]:
                self._store_vol(int(proc[pos]), int(n_term[pos]), int(n_voted[pos]))

            if log.isEnabledFor(10):  # TRACE: per-group role transitions
                for pos in np.nonzero(n_role != self._h_role[proc])[0]:
                    g = int(proc[pos])
                    log.log(10, "n%d g=%d role %d->%d term=%d head=%#x voted=%d",
                            self.self_id, g, int(self._h_role[g]),
                            int(n_role[pos]), int(n_term[pos]),
                            int(head_new[pos]), int(n_voted[pos]))
            # Rows reset/recycled DURING this tick: their fetched values
            # predate the reset — keep the reset's own mirror writes instead.
            keep = np.asarray(
                [int(g) not in reset_rows and int(g) not in self._recycled_this_tick
                 for g in proc], bool) if (reset_rows or self._recycled_this_tick) \
                else np.ones(len(proc), bool)
            upd = proc[keep]
            # Flight journal, derived from the SAME mirror diff the adoption
            # below consumes. Steady-state ticks diff to nothing.
            n_term_k, n_role_k, n_lead_k = n_term[keep], n_role[keep], n_leader[keep]
            old_term_k, old_role_k = self._h_term[upd], self._h_role[upd]
            old_lead_k = self._h_leader[upd]
            fl = self.flight
            for i in np.nonzero(n_term_k != old_term_k)[0]:
                fl.emit(t_now, "term_bump", group=int(upd[i]),
                        term=int(n_term_k[i]), leader=int(n_lead_k[i]),
                        prev_term=int(old_term_k[i]))
            # Observed leader changes, excluding rows already journaled as
            # election_won / leadership_lost by the transition loop above.
            lead_chg = ((n_lead_k != old_lead_k) & (became[keep] == 0)
                        & ~((old_role_k == LEADER) & (n_role_k != LEADER)))
            for i in np.nonzero(lead_chg)[0]:
                fl.emit(t_now, "leader_change", group=int(upd[i]),
                        term=int(n_term_k[i]), leader=int(n_lead_k[i]),
                        prev_leader=int(old_lead_k[i]))
            el_lost = (((old_role_k == CANDIDATE) | (old_role_k == PRECANDIDATE))
                       & (n_role_k == FOLLOWER))
            for i in np.nonzero(el_lost)[0]:
                fl.emit(t_now, "election_lost", group=int(upd[i]),
                        term=int(n_term_k[i]), leader=int(n_lead_k[i]))
            self._h_term[upd] = n_term_k
            self._h_voted[upd] = n_voted[keep]
            self._h_role[upd] = n_role_k
            self._h_leader[upd] = n_lead_k
            if h["mode"] == "active":
                # Timer-mirror adoption (rows 10..12 of the compact mirror).
                # Skip rows keep their reset-site mirror values, exactly like
                # the scalar mirrors above; quiescent rows were advanced by the
                # host decay twin at tick_begin.
                sv13k = sv13[:, keep]
                self._h_elapsed[upd] = sv13k[10].astype(np.int32)
                self._h_timeout[upd] = sv13k[11].astype(np.int32)
                self._h_hb[upd] = sv13k[12].astype(np.int32)
                # This dispatch's rows are adopted — the scheduler no longer
                # needs to force them awake for mirror staleness.
                self._sched_pending = [gp for gp in self._sched_pending
                                       if gp is not h["G"]]

            if self._conf_notify:
                res.conf_changes.extend(self._conf_notify)
                self._conf_notify.clear()
        # Skip rows reset mid-tick too, not just recycled ones: a
        # ReplicaDiverged reset discards the blocks this tick's computed
        # AE-ack claims to hold.
        skip = self._recycled_this_tick | reset_rows
        if self._lease is not None:
            # Lease lane (raft/lease.py): record this tick's shipped AEs,
            # recompute expiries off the post-adoption mirrors, settle
            # read barriers. Observation-only — runs before the route/
            # decode below but reads the SAME compact outbox they do.
            self._lease_finish(proc, ov_c, skip, t_now)
        if ring is not None and (self._ring_stage_decode or ring_pend):
            # Stage this finish's minted/adopted blocks — plus the capped
            # catch-up reads the LAST decode recorded (deferred one tick:
            # staging inside decode would fall between a route and its
            # flush barrier, where the scatter could tear a slot the
            # barrier's gather still needs) — before the route decision
            # below reads residency. Rows reset/recycled this tick stay
            # out: their blocks belong to a dead incarnation.
            with prof.phase("ring"):
                if self._ring_stage_decode:
                    pend, self._ring_stage_decode = self._ring_stage_decode, []
                    for g, blk in pend:
                        if g not in skip:
                            ring.stage(g, int(self._h_ginc[g]), (blk,))
                for g, blks in ring_pend.items():
                    if g not in skip:
                        ring.stage(g, int(self._h_ginc[g]), blks)
        routed_mask = None
        routed_dsts: set[int] = set()
        if self._fabric is not None and len(proc):
            # Device-resident delivery: payload-free rows toward clean
            # on-fabric peers scatter straight into their staged inbox
            # planes (the scatter source is the step's device output —
            # never the host copy) and are masked out of the host decode
            # below. The residual the decode emits is exactly the
            # payload-bearing / off-fabric share.
            with prof.phase("route"):
                routed_mask = self._fabric.route_from(
                    self, proc, ov_c, h, skip=skip or None)
            if routed_mask is not None:
                n_routed = int(routed_mask.sum())
                self.routed_msgs += n_routed
                self._c_routed.inc(n_routed)
                routed_dsts = set(
                    np.nonzero(routed_mask.any(axis=0))[0].tolist())
        with prof.phase("decode"):
            res.outbound = self._decode_outbox(ov_c, proc, skip=skip or None,
                                               routed=routed_mask)
        if self._snap_acks:
            # Snapshot-transfer acks queued by receive() ride this tick's
            # outbound.
            res.outbound.extend(self._snap_acks)
            self._snap_acks.clear()
        if self.N > 1:
            # Aggregate keepalive, emitted by the ENGINE so it works under
            # any driver loop: every active peer that got no frame this
            # tick gets a MSG_PING, keeping its peer_fresh entry for this
            # node warm. Device-routed frames ARE this tick's traffic to
            # their peers (they feed peer_fresh via the fabric flush), so
            # those slots need no ping — and emitting one would make routed
            # runs diverge on the wire from host-decoded ones.
            sent_to = {m.dst for m in res.outbound} | routed_dsts
            for slot in self.members.active_slots():
                if slot != self.me and slot not in sent_to:
                    res.outbound.append(rpc.WireMsg(
                        kind=rpc.MSG_PING, src=self.me, dst=slot))
        if self._snap_send_off or self._snap_staging:
            self._gc_snap_transfers()
        self._ticks += h.get("window", 1)
        self._maybe_snapshot()
        _m_ticks.inc(node=self.self_id)
        if res.became_leader:
            _m_elections.inc(len(res.became_leader), node=self.self_id)
        if res.outbound:
            # Count per-entry messages (a MsgBatch is many), keeping the
            # out/in counters symmetric with _receive_batch's inc(len(b)).
            _m_out.inc(sum(len(m) if isinstance(m, rpc.MsgBatch) else 1
                           for m in res.outbound), node=self.self_id)
        _m_led.set(int((self._h_role == LEADER).sum()), node=self.self_id)
        if self.health is not None:
            # Once per completed tick, after the mirrors are adopted: pure
            # host-mirror reads, journaled to the monitor's own ring.
            self.health.observe(self._ticks, self.health_sample())
        return res

    # ------------------------------------------------------------ lookups

    def health_sample(self) -> dict:
        """Zero-fetch detector inputs off the host mirrors: commit seq
        (progress), open proposal + unobserved-commit ledgers (pending),
        and the known-leader mirror (flap). Strictly read-only."""
        pend = np.zeros(self.P, np.int64)
        for g, q in self._proposals.items():
            pend[g] += len(q)
        for g, q in self._lat_open.items():
            pend[g] += len(q)
        return {
            "progress": self._h_commit & 0xFFFFFFFF,
            "pending": pend,
            "leaders": self._h_leader,
        }

    def has_group(self, group: int) -> bool:
        return 0 <= group < self.P

    def is_leader(self, group: int = 0) -> bool:
        return self.has_group(group) and self._h_role[group] == LEADER

    def leader_index(self, group: int = 0) -> int:
        return int(self._h_leader[group]) if self.has_group(group) else -1

    def leader_id(self, group: int = 0) -> int | None:
        idx = self.leader_index(group)
        return self.node_ids[idx] if 0 <= idx < self.N else None

    def term(self, group: int = 0) -> int:
        return int(self._h_term[group])

    # ------------------------------------------------------------- leases

    def _lease_finish(self, proc, ov_c, skip, t_now: int) -> None:
        """Per-tick lease maintenance (tick_finish, post mirror adoption):
        resync armed terms with the role/term mirrors, push this tick's
        shipped AppendEntries onto the evidence queues (pre-cap send tops
        from the compact outbox — the composition matches _decode_outbox
        bit for bit, so acks match their ships exactly), recompute every
        led row's expiry, settle read barriers, journal transitions, and
        refresh the device mirror plane for changed rows."""
        lane = self._lease
        lead = self._h_role == LEADER
        lane.resync(lead, self._h_term)
        if len(proc):
            ae = ov_c[0] == rpc.MSG_APPEND
            if ae.any():
                gids = np.asarray(proc, np.int64)
                if skip:
                    smask = np.isin(gids, np.fromiter(skip, np.int64,
                                                      len(skip)))
                    if smask.any():
                        ae = ae & ~smask[:, None]
                ae[:, self.me] = False
                rows, dsts = np.nonzero(ae)
                if len(rows):
                    i64 = np.int64
                    y64 = ((ov_c[4][rows, dsts].astype(i64) << 32)
                           | ov_c[5][rows, dsts].astype(i64))
                    lane.record(gids[rows], dsts, y64, t_now)
        ev = lane.recompute(t_now, lead, self._h_term, self._mask_np)
        lane.resolve_waiters(lead, self._h_term, self._mask_np)
        if self._flight_lease:
            fl = self.flight
            for g in ev["acquired"].tolist():
                fl.emit(t_now, "lease_acquired", group=g,
                        term=int(lane.ev_term[g]), leader=self.me,
                        expiry=int(lane.expiry[g]))
            for g in ev["renewed"].tolist():
                fl.emit(t_now, "lease_renewed", group=g,
                        term=int(lane.ev_term[g]), leader=self.me,
                        expiry=int(lane.expiry[g]))
            for g in ev["expired"].tolist():
                fl.emit(t_now, "lease_expired", group=g,
                        term=int(self._h_term[g]),
                        leader=int(self._h_leader[g]))
        if len(ev["changed"]):
            self._lease_plane_update(ev["changed"], ev["plane_vals"])

    def _lease_plane_update(self, rows: np.ndarray, vals: np.ndarray) -> None:
        """Refresh the (P, 3) device lease mirror [holder, expiry, term]
        for changed rows. Observation-only: nothing in the step reads it —
        it exists so device-side consumers can check lease occupancy
        without a host round trip. The python backend keeps the host array
        itself as the plane. The first refresh uploads the whole mirror;
        later ones scatter the changed rows, in place (no dispatch reads
        this plane)."""
        lane = self._lease
        if self._backend == "python":
            self._lease_plane = lane.plane_np
        elif self._mesh is not None:
            # Co-sharded with the state on 'p': the first refresh splits
            # the mirror, later ones select the changed rows shard by shard.
            if self._lease_plane is None:
                self._lease_plane = sh.place_lease_plane(self._mesh, lane.plane_np)
            else:
                mask = np.zeros(self.P, bool)
                mask[rows] = True
                self._lease_plane = sh.lease_plane_select(self._lease_plane, mask,
                                                          lane.plane_np)
        elif self._lease_plane is None:
            self._lease_plane = host_to(lane.plane_np, self._device)
        else:
            _lease_plane_scatter_fn(self._lease_plane,
                                    host_to(np.asarray(rows, np.int64), self._device),
                                    host_to(np.asarray(vals, np.int64), self._device))

    def lease_valid(self, group: int) -> bool:
        """True iff this node may serve ``group``'s reads leader-local
        right now: the row leads at its armed term, the lease tick has
        not expired, and the group is not frozen for migration. Any
        in-step step-down lands in the role mirror within the same
        tick_finish, so this gate can never outlive a deposition."""
        lane = self._lease
        if lane is None or not self.has_group(group):
            return False
        return (bool(lane.valid[group])
                and self._h_role[group] == LEADER
                and lane.ev_term[group] == self._h_term[group]
                and self._ticks < lane.expiry[group]
                and group not in self._frozen_groups)

    def lease_expiry(self, group: int) -> int | None:
        """The group's lease expiry tick (exclusive), or None when no
        lease is held."""
        if not self.lease_valid(group):
            return None
        return int(self._lease.expiry[group])

    def lease_serve(self, group: int) -> tuple[bool, str]:
        """Gate a leader-local read: (True, "ok") when the lease covers
        it (counted in raft_reads_leased_total), else (False, reason)
        with reason in off / frozen / not_leader / expired (counted in
        raft_reads_fallback_total{reason}; journaled as lease_refused
        under flight_lease). Callers fall back to read_barrier() or
        surface a retryable NotLeader."""
        lane = self._lease
        if lane is None or not self.has_group(group):
            reason = "off"
        elif group in self._frozen_groups:
            reason = "frozen"
        elif not (self._h_role[group] == LEADER
                  and lane.ev_term[group] == self._h_term[group]):
            reason = "not_leader"
        elif not (lane.valid[group]
                  and self._ticks < lane.expiry[group]):
            reason = "expired"
        else:
            self._c_leased.inc()
            return True, "ok"
        m_reads_fallback.inc(node=self.self_id, reason=reason)
        if lane is not None and self._flight_lease:
            self.flight.emit(self._ticks, "lease_refused",
                             group=int(group) if self.has_group(group)
                             else -1,
                             term=self.term(group)
                             if self.has_group(group) else -1,
                             reason=reason)
        return False, reason

    def read_barrier(self, group: int) -> asyncio.Future:
        """ReadIndex-style read fence, the consensus fallback for the
        lease fast path: resolves True once a full quorum of peers has
        acked AppendEntries shipped at or after the call tick — proving
        this node was still the leader when the read arrived — and False
        (the caller surfaces a retryable NotLeader) the moment the row
        stops leading at its armed term. Appends NOTHING to the log, so
        the write plane is identical whichever read mode runs.

        Trace context: a bound RequestSpan gets the barrier wait as its
        consensus phase (minted at submit, committed+applied at quorum)."""
        fut = asyncio.get_running_loop().create_future()
        lane = self._lease
        g = int(group)
        span = current_span() if self._request_spans else None
        if span is not None:
            span.mark("minted", self._ticks)

            def _close(f, span=span):
                t = self._ticks
                span.mark("committed", t)
                span.mark("applied", t)
            fut.add_done_callback(_close)
        if (lane is None or not self.has_group(g)
                or self._h_role[g] != LEADER
                or lane.ev_term[g] != self._h_term[g]):
            fut.set_result(False)
            return fut
        if int(self._mask_np[g].sum()) // 2 == 0:
            fut.set_result(True)  # self-quorum: the local read is exact
            return fut
        lane.add_waiter(g, self._ticks, fut)
        return fut

    def _lease_invalidate(self, group: int) -> None:
        """Drop a row's lease state (reset / recycle / membership
        change). The serve gate's role check already refuses instantly —
        this clears evidence and queues so nothing from the old
        incarnation or member set ever credits the next."""
        lane = getattr(self, "_lease", None)
        if lane is not None:
            lane.reset_rows(np.asarray([group], np.int64))

    def lease_summary(self) -> dict | None:
        """Lane telemetry for bench rows (None when leases are off)."""
        return None if self._lease is None else self._lease.summary()

    def in_sync_map(self, groups, max_lag: int = 64,
                    liveness_ticks: int = 30) -> dict[int, set[int]]:
        """Live ISR for every requested group this node leads, in ONE
        device fetch: member slots whose confirmed ``match`` pointer is
        within ``max_lag`` blocks of the leader's head AND that have sent us
        any consensus traffic within ``liveness_ticks``. Self is always
        included. Groups this node does not lead are absent from the
        result. Cost: one (2, P, N) transfer per CALL (not per group) —
        batch all partitions of a Metadata request into one call."""
        led = [g for g in groups if self.is_leader(g)]
        if not led:
            return {}
        both = self._read_rows(self.state.match.s, self.member)
        ms, mask = both[0], both[1].astype(bool)
        recent = (self._ticks - self._h_last_seen) <= liveness_ticks
        out: dict[int, set[int]] = {}
        for g in led:
            head_s = id_seq(self.chains[g].head)
            ok = mask[g] & (head_s - ms[g] <= max_lag) & recent[g]
            slots = set(np.nonzero(ok)[0].tolist())
            slots.add(self.me)
            out[g] = slots
        return out

    def in_sync_slots(self, group: int, max_lag: int = 64) -> set[int] | None:
        """Single-group view of :meth:`in_sync_map`; None when not leader."""
        return self.in_sync_map([group], max_lag).get(group)

    def in_sync_ids_map(self, groups, max_lag: int = 64) -> dict[int, list[int]]:
        """node-id form of :meth:`in_sync_map` (one bulk fetch)."""
        return {
            g: [i for i in (self.node_ids[s] for s in sorted(slots))
                if i is not None]
            for g, slots in self.in_sync_map(groups, max_lag).items()
        }

    def in_sync_ids(self, group: int, max_lag: int = 64) -> list[int] | None:
        return self.in_sync_ids_map([group], max_lag).get(group)

    def debug_state(self) -> dict:
        """Cluster-state view for a /state endpoint: an on-demand read of
        the host mirrors."""
        out = {
            "node": self.self_id,
            "groups": self.P,
            "groups_led": int((self._h_role == LEADER).sum()),
            "ticks": self._ticks,
        }
        if self.P <= 64:  # full per-group detail only at small scale
            out["detail"] = [
                {
                    "group": g,
                    "term": int(self._h_term[g]),
                    "role": int(self._h_role[g]),
                    "leader": self.leader_id(g),
                    "commit": self.chains[g].committed,
                    "head": self.chains[g].head,
                    "floor": self.chains[g].floor,
                }
                for g in range(self.P)
            ]
        return out

    # ------------------------------------------------------------ helpers

    def _load_vol(self, g: int) -> tuple[int, int]:
        """(term, voted_for) — one record so the pair is crash-atomic."""
        raw = self.kv.get(b"g%d:vol" % g)
        if raw is not None:
            return (int.from_bytes(raw[:8], "big", signed=True),
                    int.from_bytes(raw[8:16], "big", signed=True))
        # Migration from the pre-atomic split keys (term / voted_for as two
        # records): read once here; the next vote/term change rewrites the
        # pair as a single record.
        t = self.kv.get(b"g%d:vol:term" % g)
        v = self.kv.get(b"g%d:vol:voted" % g)
        return (0 if t is None else int.from_bytes(t, "big", signed=True),
                -1 if v is None else int.from_bytes(v, "big", signed=True))

    def _store_vol(self, g: int, term: int, voted: int) -> None:
        self.kv.put(b"g%d:vol" % g,
                    term.to_bytes(8, "big", signed=True)
                    + voted.to_bytes(8, "big", signed=True))
