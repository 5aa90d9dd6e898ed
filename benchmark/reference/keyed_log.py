"""Plain reference of a keyed Kafka topic over replicated logs.

On top of :mod:`replicated_log` (every group's committed log and applies
as that module states), the guarantee a keyed producer relies on: every
acknowledged record of a key is on the partition its key hashes to, once,
in the order it was produced, on every replica.

Records are the benchmark's payloads: ``PAYLOAD_HEAD`` (group, serial,
the serial counting the producer's records in the order it made them),
then the key's number (``KEY``); the key is ``"user" + str(number)``, as
YCSB's ``CoreWorkload.buildKeyName`` names it. The partition is Kafka's
``DefaultPartitioner`` for keyed records,
``toPositive(murmur2(key)) % partitions``, and a topic of ``groups - 1``
partitions lives on groups ``1 .. groups - 1`` (group 0 is the cluster's
metadata group).

Also here, for tests of the benchmark's own generator: YCSB's
``ZipfianGenerator.nextLong`` and ``ScrambledZipfianGenerator.nextValue``
and its ``Utils.fnvhash64``, one draw at a time, as published.
"""

from __future__ import annotations

import math
import struct
from collections import defaultdict

from benchmark.reference import replicated_log as rl

KEY = struct.Struct(">q")
CHECKS = rl.CHECKS + ("misplaced", "key_out_of_order")

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def _java_long(x: int) -> int:
    """A 64-bit pattern read as Java's signed ``long``."""
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


def _java_rem(a: int, b: int) -> int:
    """Java's ``%``: the remainder takes the dividend's sign."""
    r = abs(a) % abs(b)
    return -r if a < 0 else r


def murmur2(data: bytes) -> int:
    """Kafka's ``Utils.murmur2`` (seed ``0x9747b28c``), byte by byte; the
    Java ``int`` it returns."""
    m, r = 0x5BD1E995, 24
    length = len(data)
    h = (0x9747B28C ^ length) & _M32
    for i in range(length // 4):
        k = 0
        for j in range(4):
            k |= data[4 * i + j] << (8 * j)
        k = (k * m) & _M32
        k ^= k >> r
        k = (k * m) & _M32
        h = (h * m) & _M32
        h ^= k
    tail = length & 3
    base = length - tail
    if tail == 3:
        h ^= data[base + 2] << 16
    if tail >= 2:
        h ^= data[base + 1] << 8
    if tail >= 1:
        h ^= data[base]
        h = (h * m) & _M32
    h ^= h >> 13
    h = (h * m) & _M32
    h ^= h >> 15
    return h - (1 << 32) if h >> 31 else h


def key_bytes(number: int) -> bytes:
    """The key's bytes, as Kafka's ``StringSerializer`` sends them."""
    return b"user" + str(number).encode()


def group_of(number: int, groups: int) -> int:
    """The group holding the key's partition."""
    return 1 + (murmur2(key_bytes(number)) & 0x7FFFFFFF) % (groups - 1)


def fnvhash64(val: int) -> int:
    """YCSB's ``Utils.fnvhash64``: FNV-1a over the value's 8 low-first
    octets, then ``Math.abs`` of the Java ``long``."""
    h = 0xCBF29CE484222325
    for _ in range(8):
        h ^= val & 0xFF
        val >>= 8
        h = (h * 1099511628211) & _M64
    h = _java_long(h)
    return h if h == -(1 << 63) else abs(h)


class ZipfianGenerator:
    """YCSB's ``ZipfianGenerator(min, max, zipfianconstant, zetan)``; Gray
    et al., SIGMOD 1994. ``next_long(u)`` takes the uniform draw YCSB's
    ``nextDouble()`` would give."""

    def __init__(self, lo: int, hi: int, theta: float, zetan: float):
        self.items = hi - lo + 1
        self.base = lo
        self.theta = theta
        self.zeta2theta = 1.0 + 1.0 / math.pow(2.0, theta)
        self.alpha = 1.0 / (1.0 - theta)
        self.zetan = zetan
        self.eta = ((1 - math.pow(2.0 / self.items, 1 - theta))
                    / (1 - self.zeta2theta / zetan))

    def next_long(self, u: float) -> int:
        uz = u * self.zetan
        if uz < 1.0:
            return self.base
        if uz < 1.0 + math.pow(0.5, self.theta):
            return self.base + 1
        return self.base + int(self.items * math.pow(self.eta * u - self.eta + 1,
                                                     self.alpha))


class ScrambledZipfianGenerator:
    """YCSB's ``ScrambledZipfianGenerator(min, max)`` at its constant 0.99:
    a Zipfian over 10^10 items (``ZETAN`` precomputed), hashed and reduced
    into ``[min, max]``."""

    ZETAN = 26.46902820178302
    ITEM_COUNT = 10_000_000_000
    CONSTANT = 0.99

    def __init__(self, lo: int, hi: int):
        self.lo, self.count = lo, hi - lo + 1
        self.gen = ZipfianGenerator(0, self.ITEM_COUNT, self.CONSTANT, self.ZETAN)

    def next_value(self, u: float) -> int:
        return self.lo + _java_rem(fnvhash64(self.gen.next_long(u)), self.count)


def key_number(payload: bytes) -> int:
    return KEY.unpack_from(payload, rl.PAYLOAD_HEAD.size)[0]


def compare(proposals: list[tuple[int, bytes, str]], replicas: list[dict],
            groups: int) -> dict[str, int]:
    """:func:`replicated_log.compare`'s counts, plus ``misplaced`` (a
    committed record on a group other than its key's, counted per replica)
    and ``key_out_of_order`` (per replica and key, an acknowledged record
    applied after one of the same key that was produced later)."""
    n = dict(rl.compare(proposals, replicas), misplaced=0, key_out_of_order=0)
    acked = {p for _, p, s in proposals if s == "acked"}
    home: dict[int, int] = {}
    for r in replicas:
        for g, chain in r["chains"].items():
            for _, _, d in chain:
                if not d:
                    continue
                k = key_number(d)
                if k not in home:
                    home[k] = group_of(k, groups)
                n["misplaced"] += home[k] != g
        last: dict[int, int] = defaultdict(lambda: -1)
        for d in r["applied"]:
            if d in acked:
                k, serial = key_number(d), rl.PAYLOAD_HEAD.unpack_from(d)[1]
                n["key_out_of_order"] += serial < last[k]
                last[k] = max(last[k], serial)
    return n
