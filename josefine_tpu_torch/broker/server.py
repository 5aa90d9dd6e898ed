"""Broker server: Kafka-protocol TCP surface.

Parity: reference ``src/broker/server.rs`` (accept loop :32-50 + dispatcher
:53-70), ``src/broker/tcp.rs`` (per-connection framed read → handle →
framed write, correlation id echoed :48-57) and the ``JosefineBroker``
facade (``src/broker/mod.rs:30-43``).

Structural delta: the reference funnels every connection through ONE
dispatcher task over an mpsc channel and serves frames strictly
sequentially per connection; here each connection runs a reader task plus
a writer task over an ordered in-flight queue. Group-membership calls
(JoinGroup/SyncGroup — the ones that legitimately block for a whole
rebalance round) are handled CONCURRENTLY; every other API runs on a
per-connection serial lane so pipelined produces can never append out of
order; responses always write in request order. That removes the
serialization deadlock the wire driver used to dodge with a
one-connection-per-group-member rule — a JoinGroup that blocks awaiting
the rebalance no longer stops the next member's frame on the same socket
from being read and handled — without giving up the Kafka per-connection
ordering guarantee.

Graceful degradation (wire-plane chaos PR): accept-path admission caps
(global and per-client_id — clean retryable refusals), a frame-size
bound (absurd length prefixes close instead of reading unbounded), a
frame-body read deadline (torn frames cannot pin buffers forever), and
slow-client eviction on the write path. Connection-plane telemetry rides
the ordinary metrics registry; evictions also land in the flight journal
through the optional ``flight_hook``.
"""

from __future__ import annotations

import asyncio

from josefine_tpu_torch.broker import fetch_frame
from josefine_tpu_torch.broker.handlers import Broker, quota_refusal_body
from josefine_tpu_torch.broker.state import Store
from josefine_tpu_torch.config import BrokerConfig
from josefine_tpu_torch.kafka import codec
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.shutdown import Shutdown
from josefine_tpu_torch.utils.spans import bind_span
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("broker.server")

_m_active = REGISTRY.gauge("broker_active_connections",
                           "Live accepted connections per broker")
_m_refused = REGISTRY.counter("broker_conn_refused_total",
                              "Connections refused by admission "
                              "(accept cap, per-client cap, accept_refuse)")
_m_evicted = REGISTRY.counter("broker_conn_evicted_total",
                              "Connections evicted (slow client: response "
                              "write missed its deadline)")
_m_resets = REGISTRY.counter("broker_conn_resets_total",
                             "Connections that ended in a reset")

#: Writer-queue sentinel: the reader hit EOF/err — flush and stop.
_EOF = object()

#: APIs handled CONCURRENTLY per connection: the group-membership calls
#: that legitimately block for a whole rebalance round. Everything else —
#: in particular produce — runs on a per-connection serial lane, so two
#: pipelined produces on one socket can never append out of order (the
#: Kafka per-connection ordering guarantee; concurrency exists ONLY to
#: unblock join/sync sharing a socket).
_CONCURRENT_APIS = frozenset((
    int(codec.ApiKey.JOIN_GROUP), int(codec.ApiKey.SYNC_GROUP),
))


def _tenant_of(client_id: str) -> str:
    """Tenant key for per-tenant admission: the client_id prefix up to the
    first ':' (ids without one are their own tenant)."""
    return client_id.split(":", 1)[0]


def _api_kind(api_key: int) -> str:
    """Span-kind label for an API key (``produce``, ``fetch``, ...)."""
    try:
        return codec.ApiKey(api_key).name.lower()
    except ValueError:
        return f"api_{api_key}"


class _Evict(Exception):
    """Raised on the write path when a slow client misses its deadline."""


class _CloseConn(Exception):
    """Raised on the write path when a handler asked for a close."""


class JosefineBroker:
    """Facade: bind + serve until shutdown (reference ``JosefineBroker::run``).

    ``conn_shim`` (settable attribute) is the wire-chaos seam: an object
    with ``accept_allowed()``, ``wrap_server(reader, writer)`` and
    ``label_server(writer, client_id)`` (see
    :class:`josefine_tpu.chaos.wire.WirePlane`). ``flight_hook(kind,
    detail)`` journals connection-plane events (evictions) into the
    node's flight recorder. ``span_recorder`` (``raft.request_spans``,
    wired by Node) mints one request span at each frame decode — the
    wire-path trace context (utils/spans.py): admission runs decode →
    propose-submit (serial-lane waits included), serve closes when the
    response frame is encoded for the ordered writer.
    """

    def __init__(
        self,
        config: BrokerConfig,
        store: Store,
        raft_client,
        shutdown: Shutdown | None = None,
        leader_hint=None,
        is_controller=None,
        conn_shim=None,
        flight_hook=None,
        span_recorder=None,
    ):
        self.config = config
        self.shutdown = shutdown or Shutdown()
        self.broker = Broker(config, store, raft_client, leader_hint=leader_hint,
                             is_controller=is_controller)
        self.conn_shim = conn_shim
        self.flight_hook = flight_hook
        self.span_recorder = span_recorder
        self._server: asyncio.Server | None = None
        self._conn_tasks: set[asyncio.Task] = set()
        self._active = 0
        self._by_client: dict[str, int] = {}
        self._by_tenant: dict[str, int] = {}
        self.bound_addr: tuple[str, int] | None = None
        # Run-local backpressure tally for the health plane (see
        # health_counters): the _m_refused/_m_evicted registry counters
        # are process-global and would bleed across brokers sharing a
        # process, so the monitor reads these instead.
        self.n_refused = 0
        self.n_evicted = 0

    async def start(self, sock=None) -> None:
        if sock is not None:
            self._server = await asyncio.start_server(
                self._serve_connection, sock=sock)
        else:
            self._server = await asyncio.start_server(
                self._serve_connection, self.config.ip, self.config.port
            )
        self.broker.groups.start()
        lsock = self._server.sockets[0]
        self.bound_addr = lsock.getsockname()[:2]
        log.info("broker %d listening on %s:%d", self.config.id, *self.bound_addr)

    async def run(self) -> None:
        await self.start()
        await self.shutdown.wait()
        await self.stop()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # Connection handlers park on read_frame between requests; cancel
            # them or wait_closed() (which awaits handlers on >=3.12.1) hangs
            # until every client hangs up.
            for t in list(self._conn_tasks):
                t.cancel()
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
            await self._server.wait_closed()
        await self.broker.groups.close()
        self.broker.replicas.close()

    # ------------------------------------------------------------ internals

    def health_counters(self) -> dict:
        """Produce-backpressure inputs for the health plane: cumulative
        connection refusals (accept gate, global/per-client/per-tenant
        caps) plus slow-client evictions — the saturation symptoms the
        broker already counts. Wired as ``engine.health.extra_fn`` by
        node.py; merged into the per-tick sample the monitor's
        backpressure_sat detector windows."""
        return {"backpressure": self.n_refused + self.n_evicted}

    def _set_active(self, delta: int) -> None:
        self._active += delta
        _m_active.set(self._active, node=self.config.id)

    def _admit(self) -> bool:
        """Accept-path admission: the wire-chaos accept gate, then the
        global cap. A refusal is a clean close before any frame is read —
        retryable by any client with reconnect machinery."""
        shim = self.conn_shim
        if shim is not None and not shim.accept_allowed():
            _m_refused.inc(reason="accept_refuse")
            self.n_refused += 1
            return False
        cap = self.config.max_connections
        if cap and self._active >= cap:
            _m_refused.inc(reason="max_connections")
            self.n_refused += 1
            return False
        return True

    async def _serve_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername")
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        if not self._admit():
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            return
        shim = self.conn_shim
        if shim is not None:
            reader, writer = shim.wrap_server(reader, writer)
        self._set_active(1)
        client_key: str | None = None
        cfg = self.config
        # Ordered in-flight pipeline: the reader appends one future per
        # frame, the writer drains them FIFO — concurrent handling,
        # per-connection response ordering preserved. maxsize is the
        # backpressure valve: past it the reader stops reading.
        queue: asyncio.Queue = asyncio.Queue(
            maxsize=max(1, cfg.max_inflight_per_conn))
        inflight: set[asyncio.Task] = set()
        serial_tail: asyncio.Task | None = None

        rec = self.span_recorder

        async def handle(req: dict, after: asyncio.Task | None = None,
                         span=None):
            if span is not None:
                # The request's trace context (minted at frame decode):
                # bound task-locally so the propose() this request reaches
                # can stamp its queue/consensus/apply rungs on the span.
                bind_span(span)
            if after is not None and not after.done():
                # Serial lane: state-mutating requests preserve arrival
                # order; a predecessor's failure only matters to its own
                # response (the connection is torn down separately).
                await asyncio.gather(after, return_exceptions=True)
            body = await self.broker.handle_request(
                req["api_key"], req["api_version"], req["body"],
                client_id=req.get("client_id"),
                client_host=str(peer[0]) if peer else "",
            )
            if body is None:
                if span is not None:
                    rec.finish(span, status="closed")
                return _EOF  # unroutable: close (the reference panics here)
            if body.pop("__no_response__", False):
                if span is not None:
                    rec.finish(span, status="no_response")
                return None  # acks=0 produce
            api_version = req["api_version"] if req["body"] is not None else 0
            if (req["api_key"] == int(codec.ApiKey.FETCH)
                    and fetch_frame.body_has_spans(body)):
                # Zero-copy serve path (broker.fetch_path="zerocopy"): the
                # response frame is a chunk list — header scratch buffers
                # plus the log's record spans by reference — handed to the
                # writer for writev-style output. Joined, it is
                # byte-identical to the legacy encode below
                # (tests/test_wire_fetch.py pins this differentially).
                frame = fetch_frame.encode_fetch_frame(
                    api_version, req["correlation_id"], body)
            else:
                resp = codec.encode_response(
                    req["api_key"], api_version, req["correlation_id"], body
                )
                frame = codec.frame(resp)
            if span is not None:
                # Serve closes here — the frame is handed to the ordered
                # writer. Failure/cancellation paths close through the
                # done-callback guard below (finish is idempotent).
                rec.finish(span, status="ok")
            return frame

        reset = False
        evicted = False

        async def write_loop():
            nonlocal reset
            try:
                while True:
                    fut = await queue.get()
                    if fut is _EOF:
                        return
                    payload = await fut
                    if payload is None:
                        continue
                    if payload is _EOF:
                        raise _CloseConn()
                    if type(payload) is list:
                        # Zero-copy fetch frame: chunks written back to
                        # back (asyncio buffers them without copying),
                        # ONE drain — the wire bytes and the chaos
                        # plane's tear/fate draw (which keys on drained
                        # writes) are identical to a single joined write.
                        for chunk in payload:
                            writer.write(chunk)
                    else:
                        writer.write(payload)
                    if cfg.conn_write_timeout_s:
                        try:
                            await asyncio.wait_for(writer.drain(),
                                                   cfg.conn_write_timeout_s)
                        except asyncio.TimeoutError:
                            raise _Evict() from None
                    else:
                        await writer.drain()
            except ConnectionResetError:
                reset = True
                raise

        conn_task = task
        writer_task = asyncio.create_task(write_loop())

        def _writer_done(t: asyncio.Task) -> None:
            # A writer that died (eviction, reset, handler crash, close
            # request) must also stop the reader — it may be parked on
            # read_frame or on a full queue; cancelling the connection
            # task unwinds both.
            if (not t.cancelled() and t.exception() is not None
                    and conn_task is not None and not conn_task.done()):
                conn_task.cancel()

        writer_task.add_done_callback(_writer_done)
        try:
            while not self.shutdown.is_shutdown:
                try:
                    payload = await codec.read_frame(
                        reader, max_frame=cfg.max_frame_bytes,
                        body_timeout=cfg.conn_read_timeout_s or None)
                except ConnectionResetError as e:
                    reset = True
                    log.warning("reset from %s: %s", peer, e)
                    break
                except (ConnectionError, ValueError) as e:
                    log.warning("bad frame from %s: %s", peer, e)
                    break
                if payload is None:
                    break
                try:
                    req = codec.decode_request(payload)
                except ValueError as e:
                    log.warning("undecodable request from %s: %s", peer, e)
                    break
                if client_key is None:
                    # First frame names the peer: wire-chaos label + the
                    # per-client (≈ per-tenant) admission check.
                    client_key = req.get("client_id") or ""
                    if shim is not None:
                        shim.label_server(writer, client_key)
                    per = cfg.max_connections_per_client
                    if per and self._by_client.get(client_key, 0) >= per:
                        _m_refused.inc(reason="per_client")
                        self.n_refused += 1
                        log.warning(
                            "refusing connection from %s: client %r already "
                            "holds %d connections", peer, client_key, per)
                        client_key = None
                        break
                    tper = cfg.max_connections_per_tenant
                    tenant = _tenant_of(client_key)
                    if tper and self._by_tenant.get(tenant, 0) >= tper:
                        # Per-tenant token budget exhausted: answer the
                        # first request with the retryable
                        # THROTTLING_QUOTA_EXCEEDED code (when its API has
                        # an error surface), then close. One hot tenant
                        # burns only its own tokens — the global accept
                        # path and every other tenant's budget are
                        # untouched.
                        _m_refused.inc(reason="tenant_quota")
                        self.n_refused += 1
                        log.warning(
                            "refusing connection from %s: tenant %r already "
                            "holds %d connections", peer, tenant, tper)
                        rbody = quota_refusal_body(req["api_key"],
                                                   req["body"])
                        if rbody is not None:
                            ver = (req["api_version"]
                                   if req["body"] is not None else 0)
                            writer.write(codec.frame(codec.encode_response(
                                req["api_key"], ver,
                                req["correlation_id"], rbody)))
                            try:
                                await writer.drain()
                            except (ConnectionError, OSError):
                                pass
                        client_key = None
                        break
                    self._by_client[client_key] = \
                        self._by_client.get(client_key, 0) + 1
                    if tper:
                        self._by_tenant[tenant] = \
                            self._by_tenant.get(tenant, 0) + 1
                span = None
                if rec is not None:
                    # Wire-path trace context: minted at FRAME DECODE, so
                    # the admission phase covers everything between the
                    # byte arriving and the proposal entering the engine.
                    span = rec.begin(_api_kind(req["api_key"]),
                                     tenant=req.get("client_id") or "")
                if req["api_key"] in _CONCURRENT_APIS:
                    ht = asyncio.create_task(handle(req, span=span))
                else:
                    ht = asyncio.create_task(
                        handle(req, after=serial_tail, span=span))
                    serial_tail = ht
                inflight.add(ht)
                ht.add_done_callback(inflight.discard)
                if span is not None:
                    # Completion guard: a task cancelled BEFORE its first
                    # step never enters the coroutine body (connection
                    # teardown racing a just-decoded frame), so the span
                    # must close from the task side; finish is idempotent,
                    # a handler-finished span makes this a no-op.
                    ht.add_done_callback(
                        lambda _t, _s=span: rec.finish(_s, status="error"))
                await queue.put(ht)
            # EOF (or a broken frame): let the writer flush what is owed.
            await queue.put(_EOF)
            await writer_task
        except ConnectionResetError:
            reset = True
        except (_Evict, _CloseConn):
            pass  # bookkeeping happens in finally off the gathered result
        except (ConnectionError, asyncio.CancelledError):
            pass
        except Exception:
            log.exception("connection handler crashed for %s", peer)
        finally:
            writer_task.cancel()
            for ht in list(inflight):
                ht.cancel()
            results = await asyncio.gather(writer_task, *inflight,
                                           return_exceptions=True)
            if isinstance(results[0], _Evict):
                evicted = True
            elif isinstance(results[0], ConnectionResetError):
                reset = True
            elif (isinstance(results[0], Exception)
                  and not isinstance(results[0],
                                     (_CloseConn, ConnectionError,
                                      asyncio.CancelledError))):
                # A handler crash surfaces through the writer task; it
                # must not die silently just because the reader was
                # cancelled first.
                log.error("connection handler crashed for %s: %r",
                          peer, results[0])
            if evicted:
                _m_evicted.inc()
                self.n_evicted += 1
                if self.flight_hook is not None:
                    self.flight_hook("conn_evicted",
                                     {"client": client_key or "",
                                      "peer": str(peer)})
                log.warning("evicted slow client %s (%r): response write "
                            "missed %.2fs deadline", peer, client_key,
                            cfg.conn_write_timeout_s)
            if reset:
                _m_resets.inc()
            if client_key is not None:
                n = self._by_client.get(client_key, 1) - 1
                if n <= 0:
                    self._by_client.pop(client_key, None)
                else:
                    self._by_client[client_key] = n
                if cfg.max_connections_per_tenant:
                    tenant = _tenant_of(client_key)
                    n = self._by_tenant.get(tenant, 1) - 1
                    if n <= 0:
                        self._by_tenant.pop(tenant, None)
                    else:
                        self._by_tenant[tenant] = n
            self._set_active(-1)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
