"""Kafka protocol client (internal broker→broker RPC + test driver).

Parity: reference ``src/kafka/mod.rs:14-50`` + ``src/kafka/tcp.rs:16-57`` —
split read/write over one connection with a correlation-keyed callback map
(``codec.rs:151-276``). Used for the LeaderAndIsr fan-out in CreateTopics
(``src/broker/handler/create_topics.rs:101-123``) and by the integration
tests as the cluster-facing client (the reference's bit-rotted tests used
it the same way, ``tests/josefine.rs:111-119``).
"""

from __future__ import annotations

import asyncio
import itertools

from josefine_tpu_torch.kafka import codec
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("kafka.client")


class KafkaClient:
    """One connection to one broker; concurrent requests are correlated."""

    def __init__(self, host: str, port: int, client_id: str = "josefine-internal",
                 wrap=None):
        self.host = host
        self.port = port
        self.client_id = client_id
        # Chaos seam: ``wrap(reader, writer) -> (reader, writer)`` shims the
        # freshly opened stream pair (josefine_tpu/chaos/wire.WirePlane
        # injects seeded socket faults through it). None = production path.
        self._wrap = wrap
        self._corr = itertools.count(1)
        self._pending: dict[int, tuple[int, int, asyncio.Future]] = {}
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._read_task: asyncio.Task | None = None

    async def connect(self) -> "KafkaClient":
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        if self._wrap is not None:
            self._reader, self._writer = self._wrap(self._reader, self._writer)
        self._read_task = asyncio.create_task(self._read_loop())
        return self

    async def send(self, api_key: int, api_version: int, body: dict, timeout: float = 10.0) -> dict:
        """Send one request; resolves with the decoded response body."""
        if self._writer is None:
            raise ConnectionError("not connected")
        if self._read_task is not None and self._read_task.done():
            # The read loop already exited (peer hung up): fail fast instead
            # of parking a future nothing will ever resolve.
            raise ConnectionError("kafka client connection closed")
        corr = next(self._corr)
        fut = asyncio.get_running_loop().create_future()
        self._pending[corr] = (api_key, api_version, fut)
        try:
            # The write itself can fail (injected reset, dead peer): it
            # must run inside the cleanup scope or the pending future
            # leaks with an unretrieved exception.
            payload = codec.encode_request(api_key, api_version, corr,
                                           self.client_id, body)
            self._writer.write(codec.frame(payload))
            await self._writer.drain()
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(corr, None)
            if fut.done() and not fut.cancelled():
                fut.exception()  # retrieve: the read loop fails every
                # pending future when the connection dies, and a caller
                # that already gave up must not leave a GC warning

    async def send_raw(self, api_key: int, api_version: int, body: dict,
                       timeout: float = 10.0) -> tuple[bytes, bytes]:
        """Send one request and return the RAW (request, response) payload
        bytes (no length prefix, correlation ids intact). Fixture-capture
        path (tools/capture_fixtures.py): the response bytes come from the
        peer verbatim, so frames captured against a real broker are
        independent of this codec's decoder."""
        if self._writer is None:
            raise ConnectionError("not connected")
        corr = next(self._corr)
        fut = asyncio.get_running_loop().create_future()
        # Sentinel api_key -1: the read loop resolves the future with the
        # raw payload instead of decoding.
        self._pending[corr] = (-1, api_version, fut)
        try:
            payload = codec.encode_request(api_key, api_version, corr,
                                           self.client_id, body)
            self._writer.write(codec.frame(payload))
            await self._writer.drain()
            resp = await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(corr, None)
            if fut.done() and not fut.cancelled():
                fut.exception()
        return payload, resp

    async def _read_loop(self) -> None:
        try:
            while True:
                payload = await codec.read_frame(self._reader)
                if payload is None:
                    break
                # Correlation id always leads the response; the api context
                # comes from the pending map (reference codec.rs:206-211).
                corr = int.from_bytes(payload[:4], "big", signed=True)
                entry = self._pending.get(corr)
                if entry is None:
                    log.warning("response for unknown correlation id %d", corr)
                    continue
                api_key, api_version, fut = entry
                if api_key == -1:  # raw capture (send_raw)
                    if not fut.done():
                        fut.set_result(bytes(payload))
                    continue
                try:
                    d = codec.decode_response(api_key, api_version, payload)
                    if not fut.done():
                        fut.set_result(d["body"])
                except Exception as e:
                    if not fut.done():
                        fut.set_exception(e)
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            for _, _, fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("kafka client connection closed"))
            self._pending.clear()

    async def close(self) -> None:
        if self._read_task:
            self._read_task.cancel()
            await asyncio.gather(self._read_task, return_exceptions=True)
        if self._writer:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass


async def connect(host: str, port: int, **kw) -> KafkaClient:
    return await KafkaClient(host, port, **kw).connect()
