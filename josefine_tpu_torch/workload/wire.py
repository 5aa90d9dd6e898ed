"""Wire driver: the same tenant model over the REAL Kafka protocol.

Where :mod:`josefine_tpu.workload.driver` measures the product path at
scale inside one process, this driver is the end-to-end truth at smaller
P: it speaks the actual wire protocol through ``broker/server.py`` —
Metadata-routed produces to the partition leader (NotLeader re-routes),
real consumer groups (FindCoordinator → JoinGroup → SyncGroup → Fetch →
OffsetCommit → LeaveGroup), and payload verification: everything produced
must come back from a fetch, attributed to the right topic-partition,
and NOTHING else (cross-tenant delivery is an immediate failure).

Robustness (wire-plane chaos PR): every request runs under a per-request
deadline, failures retry with seeded exponential backoff drawn from the
schedule's dedicated retry stream (``ArrivalSchedule.retry_delay`` — the
OFFERED sequence stays a pure function of the seed), retryable error
codes and timeouts refresh metadata and re-route, and a connection reset
mid-consumer-generation reconnects and resumes the group dance from a
fresh JoinGroup. Since the broker pipelines frames per connection, a
group's members can share ONE connection (``shared_conn=True``) — the
old one-connection-per-member rule existed only to dodge the broker's
per-connection serialization, which is gone.

Time is pluggable: the default :class:`RequestClock` maps deadline/backoff
ticks onto the wall clock; the wire chaos soak injects a lockstep clock
that advances the whole cluster's virtual time instead, which is what
makes a chaos run's retry/fate history replayable from its seed.

Real sockets mean real wall-clock scheduling, so the byte-stable-trace
contract is the in-process driver's alone; this module's draws still come
from the seeded schedule, so the OFFERED sequence is reproducible.
"""

from __future__ import annotations

import asyncio
import json

from josefine_tpu_torch.broker import records
from josefine_tpu_torch.kafka import client as kafka_client
from josefine_tpu_torch.kafka.codec import ApiKey, ErrorCode
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.tracing import get_logger
from josefine_tpu_torch.workload.model import TenantModel, WorkloadSpec
from josefine_tpu_torch.workload.schedule import ArrivalSchedule

log = get_logger("workload.wire")

_m_retries = REGISTRY.counter("wire_client_retries_total",
                              "Wire-client retries (reconnects, reroutes, "
                              "backoffs) across all request kinds")

_RETRYABLE = (int(ErrorCode.NOT_LEADER_OR_FOLLOWER),
              int(ErrorCode.LEADER_NOT_AVAILABLE),
              int(ErrorCode.UNKNOWN_TOPIC_OR_PARTITION),
              int(ErrorCode.THROTTLING_QUOTA_EXCEEDED),
              int(ErrorCode.REQUEST_TIMED_OUT))

#: Group-protocol error codes that mean "rejoin from scratch", not "fail".
_GROUP_RETRYABLE = (int(ErrorCode.COORDINATOR_NOT_AVAILABLE),
                    int(ErrorCode.NOT_COORDINATOR),
                    int(ErrorCode.ILLEGAL_GENERATION),
                    int(ErrorCode.UNKNOWN_MEMBER_ID),
                    int(ErrorCode.REBALANCE_IN_PROGRESS))

#: Failures that mean "the connection is gone / the request never
#: resolved" — retry with backoff through reconnect machinery.
_CONN_ERRORS = (ConnectionError, OSError, TimeoutError,
                asyncio.TimeoutError, asyncio.IncompleteReadError)


class GroupRetry(Exception):
    """A consumer-group dance must restart from JoinGroup."""


class _Retry(Exception):
    """Signal from a :meth:`WireDriver._with_retries` body: the RESPONSE
    said try again (retryable error code). ``reroute=True`` counts the
    re-route; loops that route by leadership pair it with a quiet
    metadata refresh via the wrapper's ``refresh`` flag."""

    def __init__(self, reason: str, reroute: bool = False):
        super().__init__(reason)
        self.reroute = reroute


class _Exhausted(RuntimeError):
    """A retry loop ran out of attempts (produce give-up accounting needs
    to tell this apart from a hard response error)."""


class RequestClock:
    """Wall-clock time source for the driver: deadlines and backoff are
    tick-denominated (so the chaos soak can substitute a virtual clock),
    and one tick maps to ``tick_s`` wall seconds here."""

    def __init__(self, tick_s: float = 0.125):
        self.tick_s = tick_s

    async def sleep_ticks(self, ticks: int) -> None:
        await asyncio.sleep(max(0, ticks) * self.tick_s)

    async def call(self, coro, deadline_ticks: int):
        """Run one request coroutine under a deadline; raises
        ``TimeoutError`` (asyncio's) past it."""
        return await asyncio.wait_for(coro, deadline_ticks * self.tick_s)


class WireDriver:
    """Multi-tenant sessions over real broker sockets (see module doc)."""

    def __init__(self, spec: WorkloadSpec, seed: int,
                 bootstrap: list[tuple[str, int]], replication: int = 1,
                 clock: RequestClock | None = None, conn_wrap=None,
                 shared_conn: bool = False,
                 request_ticks: int = 80, join_ticks: int = 320,
                 max_attempts: int = 12):
        self.spec = spec.validate()
        self.model = TenantModel(spec)
        self.sched = ArrivalSchedule(spec, seed)
        self.bootstrap = list(bootstrap)
        self.replication = replication
        self.clock = clock or RequestClock()
        # Chaos seam: ``conn_wrap(label)`` returns a (reader, writer)
        # wrapper for a new connection (WirePlane.client_wrap). Labels are
        # deterministic — broker slot + reconnect ordinal, group + member +
        # attempt — so the fate plane's journals replay from the seed.
        self.conn_wrap = conn_wrap
        self.shared_conn = shared_conn
        self.request_ticks = request_ticks
        self.join_ticks = join_ticks
        self.max_attempts = max_attempts
        self._clients: dict[tuple[str, int], kafka_client.KafkaClient] = {}
        # Deterministic connection labels: broker slot by first-use order,
        # reconnect ordinal per slot.
        self._addr_slot: dict[tuple[str, int], str] = {}
        self._slot_attempt: dict[str, int] = {}
        # (topic, partition) -> (host, port) of the current leader.
        self._leaders: dict[tuple[str, int], tuple[str, int]] = {}
        # Ground truth for verification: payload bytes per partition, in
        # ack order.
        self.produced: dict[tuple[str, int], list[bytes]] = {}
        self.n_produced = 0
        self.n_reroutes = 0
        self.n_consumed = 0
        self.n_retries = 0
        self.n_reconnects = 0
        self.n_gave_up = 0
        self.n_group_restarts = 0

    # ------------------------------------------------------- connections

    def _label(self, addr: tuple[str, int]) -> str:
        slot = self._addr_slot.get(addr)
        if slot is None:
            slot = f"b{len(self._addr_slot)}"
            self._addr_slot[addr] = slot
        n = self._slot_attempt.get(slot, 0)
        self._slot_attempt[slot] = n + 1
        return f"{slot}:{n}"

    async def _connect(self, addr: tuple[str, int], label: str):
        wrap = self.conn_wrap(label) if self.conn_wrap else None
        return await self.clock.call(
            kafka_client.connect(addr[0], addr[1], client_id=label,
                                 wrap=wrap),
            self.request_ticks)

    async def _client(self, addr: tuple[str, int]):
        cl = self._clients.get(addr)
        if cl is not None and cl._read_task is not None \
                and cl._read_task.done():
            # The read loop exited (reset / broker hangup): reconnect
            # instead of parking requests on a dead socket.
            await self._drop_client(addr)
            cl = None
        if cl is None:
            cl = await self._connect(addr, self._label(addr))
            self._clients[addr] = cl
        return cl

    async def _drop_client(self, addr: tuple[str, int]) -> None:
        cl = self._clients.pop(addr, None)
        if cl is not None:
            self.n_reconnects += 1
            await cl.close()

    async def close(self) -> None:
        for cl in list(self._clients.values()):
            await cl.close()
        self._clients.clear()

    # ------------------------------------------------------------ retry

    async def _backoff(self, attempt: int) -> None:
        """Seeded exponential backoff with jitter, drawn from the
        schedule's dedicated retry stream (never the arrival stream)."""
        self.n_retries += 1
        _m_retries.inc()
        await self.clock.sleep_ticks(self.sched.retry_delay(attempt))

    async def _send(self, cl, api_key: int, api_version: int, body: dict,
                    deadline_ticks: int | None = None) -> dict:
        # The client's own wall timeout is a backstop far past the
        # tick-denominated deadline, which governs.
        return await self.clock.call(
            cl.send(api_key, api_version, body, timeout=600.0),
            deadline_ticks or self.request_ticks)

    def _bootstrap_addr(self, attempt: int) -> tuple[str, int]:
        return self.bootstrap[attempt % len(self.bootstrap)]

    async def _with_retries(self, attempts: int, addr_for, body, fail,
                            refresh: bool = False):
        """The ONE pick-addr/try/drop/backoff loop behind every request
        kind (the wire-chaos PR shipped five copies of it; this is the
        recorded-debt collapse — behavior pinned by the existing
        retry/reroute tests).

        ``addr_for(attempt)`` picks the target (bootstrap rotation, or
        the current leader for leadership-routed kinds). ``body(cl,
        attempt)`` runs the request against a live client and either
        returns the final value, raises :class:`_Retry` (response-level
        retryable: back off on the seeded stream, count a re-route when
        flagged, go around), or raises to abort the loop. Connection
        failures drop the client before backing off. ``refresh=True``
        quietly refreshes metadata after every backoff (the
        leadership-routed kinds re-route off the freshest view; a failed
        refresh is survivable — the next attempt re-routes stale).
        ``fail(last)`` builds the exhaustion exception."""
        last: Exception | None = None
        for attempt in range(attempts):
            addr = addr_for(attempt)
            try:
                cl = await self._client(addr)
                return await body(cl, attempt)
            except _Retry as e:
                last = e
                if e.reroute:
                    self.n_reroutes += 1
            except _CONN_ERRORS as e:
                last = e
                await self._drop_client(addr)
            await self._backoff(attempt)
            if refresh:
                await self._refresh_quietly()
        raise fail(last)

    async def refresh_metadata(self) -> None:
        async def body(cl, attempt):
            md = await self._send(cl, ApiKey.METADATA, 1, {
                "topics": [{"name": n} for n in self.model.topic_names]})
            brokers = {b["node_id"]: (b["host"], b["port"])
                       for b in md["brokers"]}
            for t in md["topics"]:
                if t["error_code"] != ErrorCode.NONE:
                    continue
                for p in t["partitions"]:
                    addr2 = brokers.get(p["leader_id"])
                    if addr2 is not None:
                        self._leaders[(t["name"], p["partition_index"])] = addr2

        await self._with_retries(
            self.max_attempts, self._bootstrap_addr, body,
            lambda last: ConnectionError(f"metadata refresh failed: {last!r}"))

    # ------------------------------------------------------------ setup

    async def create_topics(self, timeout: float = 30.0) -> None:
        async def body(cl, attempt):
            resp = await self._send(cl, ApiKey.CREATE_TOPICS, 1, {
                "topics": [{"name": name,
                            "num_partitions": self.spec.partitions_per_topic,
                            "replication_factor": self.replication,
                            "assignments": [], "configs": []}
                           for name in self.model.topic_names],
                "timeout_ms": int(timeout * 1000), "validate_only": False,
            }, deadline_ticks=self.join_ticks)
            for t in resp["topics"]:
                if t["error_code"] not in (int(ErrorCode.NONE),
                                           int(ErrorCode.TOPIC_ALREADY_EXISTS)):
                    raise RuntimeError(f"create_topics failed: {t}")
            await self.refresh_metadata()

        await self._with_retries(
            self.max_attempts, self._bootstrap_addr, body,
            lambda last: ConnectionError("create_topics never reached a broker"))

    # ---------------------------------------------------------- produce

    async def produce_batches(self, count: int, max_attempts: int | None = None,
                              raise_on_fail: bool = True) -> int:
        """Offer ``count`` schedule-drawn batches, each routed to its
        partition's CURRENT leader; retryable errors, timeouts, and
        connection failures back off (seeded), refresh metadata, and
        re-route. Returns the number of batches acked; a batch whose
        attempt budget is exhausted raises, or is counted in
        ``n_gave_up`` when ``raise_on_fail=False`` (chaos soaks measure
        give-ups instead of dying mid-schedule)."""
        if self.spec.produce_per_tick <= 0:
            raise ValueError("produce_batches needs produce_per_tick > 0 "
                             "(zero-rate schedules mint no arrivals)")
        arrivals = []
        tick = 0
        while len(arrivals) < count:
            arrivals.extend(self.sched.produce_arrivals(tick))
            tick += 1
        acked = 0
        for arr in arrivals[:count]:
            if await self._produce_one(arr, max_attempts or self.max_attempts,
                                       raise_on_fail):
                acked += 1
        return acked

    async def _produce_one(self, arr, max_attempts: int,
                           raise_on_fail: bool) -> bool:
        payload = arr.payload(self.spec)
        batch = records.build_batch(payload, self.spec.records_per_batch)
        key = (arr.topic, arr.partition)

        async def body(cl, attempt):
            resp = await self._send(cl, ApiKey.PRODUCE, 3, {
                "transactional_id": None, "acks": -1,
                "timeout_ms": 5000,
                "topics": [{"name": arr.topic, "partitions": [
                    {"index": arr.partition, "records": batch}]}],
            })
            p = resp["responses"][0]["partitions"][0]
            code = int(p["error_code"])
            if code == int(ErrorCode.NONE):
                self.produced.setdefault(key, []).append(payload)
                self.n_produced += 1
                return True
            if code in _RETRYABLE:
                raise _Retry(f"produce {key}: code {code}", reroute=True)
            raise RuntimeError(f"produce to {key} failed with code {code}")

        try:
            return await self._with_retries(
                max_attempts,
                lambda a: self._leaders.get(key) or self._bootstrap_addr(a),
                body,
                lambda last: _Exhausted(f"produce to {key} never accepted "
                                        f"({max_attempts} attempts)"),
                refresh=True)
        except _Exhausted:
            if raise_on_fail:
                raise
            self.n_gave_up += 1
            return False

    async def _refresh_quietly(self) -> None:
        """Metadata refresh that must not abort a retry loop: under chaos
        the refresh itself can fail — the next attempt re-routes off stale
        leadership, which is still progress."""
        try:
            await self.refresh_metadata()
        except _CONN_ERRORS:
            pass

    # ----------------------------------------------------------- consume

    async def _coordinator_addr(self, group_id: str) -> tuple[str, int]:
        async def body(cl, attempt):
            resp = await self._send(cl, ApiKey.FIND_COORDINATOR, 1,
                                    {"key": group_id, "key_type": 0})
            if resp["error_code"] == ErrorCode.NONE:
                return (resp["host"], resp["port"])
            raise _Retry(f"find-coordinator: {resp['error_code']}")

        return await self._with_retries(
            self.max_attempts * 2, self._bootstrap_addr, body,
            lambda last: RuntimeError(f"no coordinator for {group_id}"))

    async def consume_verify_tenant(self, tenant: int,
                                    max_group_attempts: int = 8) -> int:
        """One tenant's consumer group over the real group protocol: join,
        leader assigns ranges, every member fetches its assignment from
        offset 0, payloads are verified against the produced ground truth,
        offsets are committed, members leave. Returns batches consumed.

        Reconnect-with-resume: a connection reset or deadline mid-dance
        (join, sync, fetch, or commit) tears the sessions down, backs off
        on the seeded retry stream, and rejoins from a fresh JoinGroup —
        the group reconverges on a new generation instead of dying."""
        last: Exception | None = None
        for attempt in range(max_group_attempts):
            try:
                return await self._consume_once(tenant, attempt)
            except (GroupRetry, *_CONN_ERRORS) as e:
                last = e
                self.n_group_restarts += 1
                await self._backoff(attempt)
        raise RuntimeError(
            f"consumer group for tenant {tenant} never converged "
            f"({max_group_attempts} attempts): {last!r}")

    async def _consume_once(self, tenant: int, attempt: int) -> int:
        group_id = f"cg-{TenantModel.tenant_label(tenant)}"
        n_members = max(1, self.spec.consumers_per_tenant)
        co_addr = await self._coordinator_addr(group_id)
        parts = [(topic, p)
                 for topic in self.model.topics_of_tenant(tenant)
                 for p in range(self.spec.partitions_per_topic)]

        # The broker pipelines frames per connection (responses ordered,
        # handling concurrent), so members may share one socket: a
        # follower's blocking SyncGroup no longer stops the leader's from
        # being read — the serialization deadlock rule is gone. The
        # shared_conn=False mode keeps one socket per member (the
        # production client shape).
        sessions: list = []

        async def connect_member(m: int):
            label = f"cg-{TenantModel.tenant_label(tenant)}:m{m}:a{attempt}"
            return await self._connect(co_addr, label)

        try:
            if self.shared_conn:
                shared = await connect_member(0)
                sessions = [shared] * n_members
            else:
                for m in range(n_members):
                    sessions.append(await connect_member(m))

            async def join(cl) -> dict:
                resp = await self._send(cl, ApiKey.JOIN_GROUP, 1, {
                    "group_id": group_id, "session_timeout_ms": 30_000,
                    "rebalance_timeout_ms": 30_000, "member_id": "",
                    "protocol_type": "consumer",
                    "protocols": [{"name": "range", "metadata": b""}]},
                    deadline_ticks=self.join_ticks)
                if resp["error_code"] in _GROUP_RETRYABLE:
                    raise GroupRetry(f"join: {resp['error_code']}")
                if resp["error_code"] != ErrorCode.NONE:
                    raise RuntimeError(f"join failed: {resp}")
                return resp

            joins = await asyncio.gather(*[join(cl) for cl in sessions])
            generation = joins[0]["generation_id"]
            leader_id = joins[0]["leader"]
            member_ids = [j["member_id"] for j in joins]

            # The group leader computes the range assignment and syncs it.
            members_sorted = sorted(member_ids)
            assignment = {
                mid: [parts[i] for i in range(len(parts))
                      if i % len(members_sorted) == rank]
                for rank, mid in enumerate(members_sorted)
            }

            async def sync(cl, mid: str) -> dict:
                body = {"group_id": group_id, "generation_id": generation,
                        "member_id": mid, "assignments": []}
                if mid == leader_id:
                    body["assignments"] = [
                        {"member_id": m,
                         "assignment": json.dumps(a).encode()}
                        for m, a in sorted(assignment.items())]
                resp = await self._send(cl, ApiKey.SYNC_GROUP, 1, body,
                                        deadline_ticks=self.join_ticks)
                if resp["error_code"] in _GROUP_RETRYABLE:
                    raise GroupRetry(f"sync: {resp['error_code']}")
                if resp["error_code"] != ErrorCode.NONE:
                    raise RuntimeError(f"sync failed: {resp}")
                return resp

            syncs = await asyncio.gather(
                *(sync(cl, m) for cl, m in zip(sessions, member_ids)))
            consumed = 0
            for cl, mid, s in zip(sessions, member_ids, syncs):
                my_parts = [tuple(x) for x in json.loads(s["assignment"])] \
                    if s["assignment"] else []
                consumed += await self._fetch_verify_commit(
                    cl, group_id, generation, mid, my_parts)
            for cl, mid in zip(sessions, member_ids):
                await self._send(cl, ApiKey.LEAVE_GROUP, 1,
                                 {"group_id": group_id, "member_id": mid})
        finally:
            for cl in {id(c): c for c in sessions}.values():
                await cl.close()
        self.n_consumed += consumed
        return consumed

    async def _fetch_one(self, topic: str, p: int) -> dict:
        """Fetch a whole partition from offset 0 off its current leader,
        with reconnect + reroute on connection failure."""
        async def body(cl, attempt):
            resp = await self._send(cl, ApiKey.FETCH, 4, {
                "replica_id": -1, "max_wait_ms": 0, "min_bytes": 0,
                "max_bytes": 1 << 22, "isolation_level": 0,
                "topics": [{"topic": topic, "partitions": [
                    {"partition": p, "fetch_offset": 0,
                     "partition_max_bytes": 1 << 22}]}],
            })
            pr = resp["responses"][0]["partitions"][0]
            if int(pr["error_code"]) in _RETRYABLE:
                raise _Retry(f"fetch {topic}[{p}]: {pr['error_code']}",
                             reroute=True)
            if pr["error_code"] != ErrorCode.NONE:
                raise RuntimeError(
                    f"fetch {topic}[{p}] failed: {pr['error_code']}")
            return pr

        return await self._with_retries(
            self.max_attempts,
            lambda a: self._leaders.get((topic, p)) or self._bootstrap_addr(a),
            body,
            lambda last: ConnectionError(f"fetch {topic}[{p}] never served"),
            refresh=True)

    async def _fetch_verify_commit(self, co, group_id: str, generation: int,
                                   mid: str, parts: list) -> int:
        consumed = 0
        offsets = []
        for topic, p in parts:
            expect = self.produced.get((topic, p), [])
            pr = await self._fetch_one(topic, p)
            data = pr.get("records") or b""
            for payload in expect:
                if payload not in data:
                    raise RuntimeError(
                        f"produced payload missing from {topic}[{p}]")
            # Cross-tenant isolation: every workload payload embeds its
            # topic (w:<tenant>:<seq>:<topic>:<part>, '='-padded); any
            # OTHER topic's header in this partition's data is delivery
            # corruption. Digit guards skip coincidental binary "w:".
            topic_b = topic.encode()
            for seg in data.split(b"w:")[1:]:
                fields = seg.split(b"=", 1)[0].split(b":")
                if (len(fields) >= 4 and fields[0].isdigit()
                        and fields[1].isdigit() and fields[2] != topic_b):
                    raise RuntimeError(
                        f"foreign payload in {topic}[{p}]: "
                        f"{fields[:4]!r}")
            consumed += len(expect)
            offsets.append((topic, p, pr["high_watermark"]))
        if offsets:
            by_topic: dict[str, list] = {}
            for topic, p, off in offsets:
                by_topic.setdefault(topic, []).append(
                    {"partition_index": p, "committed_offset": off,
                     "committed_metadata": None})
            resp = await self._send(co, ApiKey.OFFSET_COMMIT, 2, {
                "group_id": group_id, "generation_id": generation,
                "member_id": mid, "retention_time_ms": -1,
                "topics": [{"name": n, "partitions": pl}
                           for n, pl in sorted(by_topic.items())]})
            for t in resp["topics"]:
                for p in t["partitions"]:
                    if p["error_code"] in _GROUP_RETRYABLE:
                        raise GroupRetry(f"commit: {p['error_code']}")
                    if p["error_code"] != ErrorCode.NONE:
                        raise RuntimeError(f"offset commit failed: {p}")
        return consumed

    async def consume_verify(self) -> int:
        total = 0
        for tenant in range(self.spec.tenants):
            total += await self.consume_verify_tenant(tenant)
        return total

    def summary(self) -> dict:
        return {
            "produced": self.n_produced,
            "consumed": self.n_consumed,
            "reroutes": self.n_reroutes,
            "retries": self.n_retries,
            "reconnects": self.n_reconnects,
            "gave_up": self.n_gave_up,
            "group_restarts": self.n_group_restarts,
            "partitions_hit": len(self.produced),
        }
