"""Bit-faithful ports of the JVM randomness Spark's ``randomSplit`` uses.

The reference splits with ``df.randomSplit([0.7, 0.3], seed=2018)``
(reference Main/main.py:80).  Under the hood (Spark 2.3/2.4) that is:

1. a per-partition ascending sort over every *orderable* output column —
   including the assembled ``features`` vector, whose ``VectorUDT`` sorts as
   its sqlType struct ``(type, size, indices[], values[])``;
2. one ``BernoulliCellSampler`` pass per output split, each re-seeded with
   ``seed + partitionIndex`` and drawing one double per row: a row lands in
   the split whose ``[lo, hi)`` cell contains its draw;
3. the sampler RNG is ``XORShiftRandom``, whose seed is MurmurHash3-mixed —
   over a **64-byte** buffer, because upstream allocates
   ``java.lang.Long.SIZE`` (a bit count) bytes.

This module reproduces 1-3 exactly; :mod:`har_tpu_torch.data.spark_split` builds
the sort keys.  Validated row-for-row against the captured reference run
(result.txt:105-131: counts 3,793/1,625 and all ten shown sample UIDs).

Also here: the Scala ``immutable.HashMap`` iteration-order key.  MLlib's
``StringIndexer`` breaks frequency ties in whatever order
``countByValue().toSeq`` yields — the hash-trie's LSB-first 5-bit-chunk
walk of the improved Java string hash.  ``scala_hashmap_key`` reproduces
it so one-hot indices match MLlib's bit-for-bit.
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF

#: MurmurHash3 seed scala.util.hashing uses for byte arrays.
_ARRAY_SEED = 0x3C074A61


def murmur3_bytes(data: bytes, seed: int) -> int:
    """scala.util.hashing.MurmurHash3.bytesHash (x86 32-bit variant)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & _M32

    def rotl(x: int, r: int) -> int:
        return ((x << r) | (x >> (32 - r))) & _M32

    i = 0
    while len(data) - i >= 4:
        k = data[i] | data[i + 1] << 8 | data[i + 2] << 16 | data[i + 3] << 24
        k = (k * c1) & _M32
        k = rotl(k, 15)
        k = (k * c2) & _M32
        h ^= k
        h = rotl(h, 13)
        h = (h * 5 + 0xE6546B64) & _M32
        i += 4
    k = 0
    rem = len(data) - i
    if rem == 3:
        k ^= data[i + 2] << 16
    if rem >= 2:
        k ^= data[i + 1] << 8
    if rem >= 1:
        k ^= data[i]
        k = (k * c1) & _M32
        k = rotl(k, 15)
        k = (k * c2) & _M32
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def xorshift_hash_seed(seed: int) -> int:
    """Spark XORShiftRandom.hashSeed.

    Upstream allocates ``ByteBuffer.allocate(java.lang.Long.SIZE)`` — 64
    *bytes* (SIZE is in bits) — so the hash runs over the 8 big-endian seed
    bytes followed by 56 zeros.  Reproducing the quirk is load-bearing.
    """
    buf = (seed & _M64).to_bytes(8, "big") + b"\x00" * 56
    low = murmur3_bytes(buf, _ARRAY_SEED)
    high = murmur3_bytes(buf, low)
    return ((high << 32) | low) & _M64


class XORShiftRandom:
    """Spark's org.apache.spark.util.random.XORShiftRandom.

    Subclasses java.util.Random but replaces ``next(bits)`` with a 64-bit
    xorshift; ``nextDouble`` keeps Java's 53-bit construction.
    """

    def __init__(self, seed: int):
        self._state = xorshift_hash_seed(seed)

    def next(self, bits: int) -> int:
        s = self._state
        s ^= (s << 21) & _M64
        s ^= s >> 35
        s ^= (s << 4) & _M64
        self._state = s
        return s & ((1 << bits) - 1)

    def next_double(self) -> float:
        return ((self.next(26) << 27) + self.next(27)) * (2.0 ** -53)


def bernoulli_draws(n: int, seed: int, partition_index: int = 0) -> np.ndarray:
    """The n doubles BernoulliCellSampler draws for one partition.

    Every output split re-runs the same seeded sequence over the partition,
    so one draw per row decides all splits at once (``lo <= x < hi``).
    """
    rng = XORShiftRandom(seed + partition_index)
    return np.fromiter(
        (rng.next_double() for _ in range(n)), dtype=np.float64, count=n
    )


def py2_string_hash(s: str) -> int:
    """CPython 2's 64-bit str hash (signed).

    PySpark params default their ``seed`` to ``hash(type(self).__name__)``
    — e.g. pyspark.ml.tuning.CrossValidator's fold assignment runs SQL
    ``rand(hash('CrossValidator'))``.  Python 2 (the reference's 2019-era
    client) hashes strings with this deterministic algorithm; Python 3
    randomizes, so replaying the committed run means replaying py2's.
    """
    if not s:
        return 0
    x = (ord(s[0]) << 7) & _M64
    for ch in s:
        x = ((1000003 * x) ^ ord(ch)) & _M64
    x ^= len(s)
    if x == _M64:  # CPython maps -1 to -2
        x = _M64 - 1
    return x - (1 << 64) if x >= (1 << 63) else x


def java_string_hash(s: str) -> int:
    """java.lang.String.hashCode (signed 32-bit)."""
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & _M32
    return h - (1 << 32) if h >= (1 << 31) else h


def scala_hash_improve(hcode: int) -> int:
    """scala.collection.immutable.HashMap's hash improver."""
    h = hcode & _M32
    h = (h + (~((h << 9) & _M32) & _M32)) & _M32
    h ^= h >> 14
    h = (h + ((h << 4) & _M32)) & _M32
    return h ^ (h >> 10)


def scala_int_trie_order(keys) -> list[int]:
    """scala immutable.HashMap[Int-hashed key] iteration order.

    The hash trie walks 5-bit chunks of improve(key.##) LSB-first; whole
    doubles 0.0..5.0 hash like their int values (scala unified hashing),
    so MulticlassMetrics' ``labelCountByClass`` map iterates class ids in
    this order — the order its weighted metrics accumulate in.
    """

    def chunk_key(k: int) -> tuple[int, ...]:
        h = scala_hash_improve(k & _M32)
        return tuple((h >> (5 * level)) & 31 for level in range(7))

    return sorted(keys, key=chunk_key)


def scala_hashmap_key(s: str) -> tuple[int, ...]:
    """Sort key reproducing scala immutable.HashMap iteration order.

    The hash trie consumes the improved hash five bits at a time from the
    least-significant end; iteration walks bitmap slots in increasing
    order at each level, i.e. lexicographically over the chunk sequence.
    """
    h = scala_hash_improve(java_string_hash(s))
    return tuple((h >> (5 * level)) & 31 for level in range(7))
