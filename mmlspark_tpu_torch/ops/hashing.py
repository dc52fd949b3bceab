"""Murmur3-based term hashing, bit-compatible with Spark ML's HashingTF.

The PyTorch port's own copy of ``mmlspark_tpu/ops/hashing.py``.

The reference pins exact hash slot indices in 2^18-dim space
(``core/ml/src/test/scala/HashingTFSpec.scala:22-29``), so the featurizer's
hash function must reproduce Spark's ``Murmur3_x86_32.hashUnsafeBytes`` over
UTF-8 bytes with seed 42, including its quirk of mixing each *trailing* byte
(signed!) as its own 4-byte word, followed by ``Utils.nonNegativeMod``.

The hot path is VECTORIZED: cold terms hash through a numpy batch kernel
(`murmur3_batch`) that processes every term's k-th word in one vector op —
the reference runs its slot scan as a cluster job
(``AssembleFeatures.scala:198-224``); a Python per-token loop would be the
single-box equivalent of forgetting that. Warm terms (repeated vocabulary,
the common case) resolve through a module-level dict at lookup speed.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MASK = 0xFFFFFFFF
SPARK_SEED = 42


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK


def _mix_k1(k1: int) -> int:
    k1 = (k1 * _C1) & _MASK
    k1 = _rotl(k1, 15)
    return (k1 * _C2) & _MASK


def _mix_h1(h1: int, k1: int) -> int:
    h1 ^= k1
    h1 = _rotl(h1, 13)
    return (h1 * 5 + 0xE6546B64) & _MASK


def murmur3_x86_32(data: bytes, seed: int = SPARK_SEED) -> int:
    """Spark-compatible murmur3 over bytes; returns a SIGNED 32-bit int."""
    h1 = seed & _MASK
    n_aligned = len(data) - len(data) % 4
    for i in range(0, n_aligned, 4):
        k1 = int.from_bytes(data[i:i + 4], "little")
        h1 = _mix_h1(h1, _mix_k1(k1))
    # Spark tail quirk: each remaining byte is sign-extended and mixed alone.
    for i in range(n_aligned, len(data)):
        b = data[i]
        half_word = b - 256 if b >= 128 else b
        h1 = _mix_h1(h1, _mix_k1(half_word & _MASK))
    h1 ^= len(data)
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _MASK
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _MASK
    h1 ^= h1 >> 16
    return h1 - (1 << 32) if h1 >= (1 << 31) else h1


# -- vectorized batch kernel -------------------------------------------------

def _vrotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _vmix_k1(k1: np.ndarray) -> np.ndarray:
    k1 = k1 * np.uint32(_C1)
    k1 = _vrotl(k1, 15)
    return k1 * np.uint32(_C2)


def _vmix_h1(h1: np.ndarray, k1: np.ndarray) -> np.ndarray:
    h1 = h1 ^ k1
    h1 = _vrotl(h1, 13)
    return h1 * np.uint32(5) + np.uint32(0xE6546B64)


def murmur3_batch(terms: Sequence[str], seed: int = SPARK_SEED) -> np.ndarray:
    """Vectorized murmur3 over a batch of terms (signed int32 per term).

    Terms are grouped into power-of-two length buckets so one long outlier
    (a URL, an un-split blob) can't inflate the padded byte matrix for the
    whole batch; within a bucket padding is bounded at 2x. Each bucket's
    bytes land in one padded uint8 matrix; each 4-byte word position is
    mixed across the bucket in one vector op (per-row validity masked by
    length), then the trailing 1-3 bytes mix sign-extended exactly like the
    scalar path. O(max_term_len_in_bucket) numpy passes per bucket.
    """
    n = len(terms)
    if n == 0:
        return np.zeros(0, np.int32)
    encoded = [t.encode("utf-8") for t in terms]
    lens = np.fromiter((len(b) for b in encoded), np.int64, n)
    buckets = np.zeros(n, np.int64)
    nz = lens > 4
    buckets[nz] = np.ceil(np.log2(lens[nz])).astype(np.int64)
    uniq = np.unique(buckets)
    if len(uniq) == 1:
        return _murmur3_batch_core(encoded, lens, seed)
    out = np.empty(n, np.int32)
    for b in uniq:
        idx = np.nonzero(buckets == b)[0]
        out[idx] = _murmur3_batch_core([encoded[i] for i in idx],
                                       lens[idx], seed)
    return out


def _murmur3_batch_core(encoded: Sequence[bytes], lens: np.ndarray,
                        seed: int) -> np.ndarray:
    n = len(encoded)
    maxlen = int(lens.max())
    with np.errstate(over="ignore"):
        if maxlen == 0:
            h1 = np.full(n, seed, np.uint32)
            return _finalize(h1, lens)
        pad = (maxlen + 3) // 4 * 4
        flat = np.frombuffer(b"".join(encoded), np.uint8)
        starts = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        buf = np.zeros((n, pad), np.uint8)
        for j in range(maxlen):  # maxlen is small for tokens; row dim is wide
            m = lens > j
            buf[m, j] = flat[starts[m] + j]
        words = (buf[:, 0::4].astype(np.uint32)
                 | (buf[:, 1::4].astype(np.uint32) << np.uint32(8))
                 | (buf[:, 2::4].astype(np.uint32) << np.uint32(16))
                 | (buf[:, 3::4].astype(np.uint32) << np.uint32(24)))
        n_words = lens // 4
        h1 = np.full(n, seed, np.uint32)
        for k in range(pad // 4):
            full = n_words > k
            mixed = _vmix_h1(h1, _vmix_k1(words[:, k]))
            h1 = np.where(full, mixed, h1)
        # tail: each trailing byte sign-extended, mixed alone, in order
        tail_len = lens % 4
        for t in range(3):
            valid = tail_len > t
            if not valid.any():
                break
            idx = np.minimum(n_words * 4 + t, pad - 1)
            b = buf[np.arange(n), idx].astype(np.uint32)
            signed = np.where(b >= 128, b | np.uint32(0xFFFFFF00), b)
            mixed = _vmix_h1(h1, _vmix_k1(signed))
            h1 = np.where(valid, mixed, h1)
        return _finalize(h1, lens)


def _finalize(h1: np.ndarray, lens: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        h1 = h1 ^ lens.astype(np.uint32)
        h1 = h1 ^ (h1 >> np.uint32(16))
        h1 = h1 * np.uint32(0x85EBCA6B)
        h1 = h1 ^ (h1 >> np.uint32(13))
        h1 = h1 * np.uint32(0xC2B2AE35)
        h1 = h1 ^ (h1 >> np.uint32(16))
    return h1.view(np.int32)


# term -> signed 32-bit hash; plain dict (read-mostly) beats lru_cache here
_HASH_CACHE: Dict[str, int] = {}
_HASH_CACHE_MAX = 1 << 21


def _term_hash(term: str) -> int:
    h = _HASH_CACHE.get(term)
    if h is None:
        h = murmur3_x86_32(term.encode("utf-8"))
        if len(_HASH_CACHE) < _HASH_CACHE_MAX:
            _HASH_CACHE[term] = h
    return h


def _hashes(terms: Sequence[str]) -> np.ndarray:
    """Signed murmur3 per term: cache hits via dict, misses via the batch
    kernel (one vectorized pass over all cold terms)."""
    cache = _HASH_CACHE
    out = np.empty(len(terms), np.int64)
    miss_i: List[int] = []
    miss_t: List[str] = []
    for i, t in enumerate(terms):
        h = cache.get(t)
        if h is None:
            miss_i.append(i)
            miss_t.append(t)
        else:
            out[i] = h
    if miss_t:
        hs = murmur3_batch(miss_t)
        out[miss_i] = hs
        if len(cache) < _HASH_CACHE_MAX:
            for t, h in zip(miss_t, hs.tolist()):  # lint: allow-sync (numpy array)
                cache[t] = h
    return out


def hash_term(term: str, num_features: int) -> int:
    """Slot index for one term: nonNegativeMod(murmur3(term), numFeatures)."""
    if num_features <= 0:
        raise ValueError(f"num_features must be positive, got {num_features}")
    return _term_hash(term) % num_features


def hash_terms(terms: Iterable[str], num_features: int) -> np.ndarray:
    """Slot indices (int64) for a sequence of terms."""
    if num_features <= 0:
        raise ValueError(f"num_features must be positive, got {num_features}")
    terms = terms if isinstance(terms, (list, tuple)) else list(terms)
    # numpy '%' on a negative int64 is already nonNegativeMod
    return _hashes(terms) % num_features


def hash_token_rows(token_rows: Sequence[Sequence[str]],
                    num_features: int) -> Tuple[np.ndarray, np.ndarray]:
    """Flattened slot indices for ragged token rows.

    Returns (slots, row_ptr): ``slots[row_ptr[i]:row_ptr[i+1]]`` are row i's
    slot indices in token order — the CSR layout every downstream scatter
    (TF counts, active-slot scans) consumes without a per-row Python loop.
    """
    n = len(token_rows)
    counts = np.fromiter(
        (len(r) if r is not None else 0 for r in token_rows), np.int64, n)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    flat: List[str] = []
    for r in token_rows:
        if r:
            flat.extend(r)
    return hash_terms(flat, num_features), row_ptr


def tf_csr(token_rows: Sequence[Sequence[str]], num_features: int
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Term-frequency CSR over ragged token rows: (row_ptr, slots, counts).

    Per row, ``slots`` are unique and ascending (Spark SparseVector ordering).
    One np.unique over rowid*num_features+slot keys replaces the reference's
    per-row HashingTF transform loop.
    """
    for r in token_rows:
        if r is None:
            raise ValueError("HashingTF applied to a null token array")
    slots, in_ptr = hash_token_rows(token_rows, num_features)
    n = len(token_rows)
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(in_ptr))
    keys = row_ids * num_features + slots
    uniq, counts = np.unique(keys, return_counts=True)
    out_rows = uniq // num_features
    out_slots = uniq % num_features
    row_ptr = np.searchsorted(out_rows, np.arange(n + 1, dtype=np.int64))
    return row_ptr, out_slots, counts.astype(np.int64)


def project_slots(fitted: np.ndarray, slots: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Positions of ``slots`` within the sorted fit-time active-slot array.

    Returns (pos, ok): ``pos[ok]`` are valid compact indices; slots unseen at
    fit have ``ok`` False. THE single definition of the active-slot
    projection used by both HashingTFModel and AssembleFeaturesModel.
    """
    width = len(fitted)
    slots = np.asarray(slots, np.int64)
    if width == 0:
        return np.zeros(len(slots), np.int64), np.zeros(len(slots), bool)
    pos = np.searchsorted(fitted, slots)
    ok = (pos < width) & (fitted[np.minimum(pos, width - 1)] == slots)
    return pos, ok


def term_frequencies(token_rows: Sequence[Sequence[str]],
                     num_features: int) -> List[np.ndarray]:
    """Per-row (slots, counts) pairs — the HashingTF transform per row.

    Returns a list of (k, 2) arrays [slot, count] sorted by slot, mirroring
    Spark's SparseVector ordering so downstream slot selection is stable.
    (Compatibility view over :func:`tf_csr`.)
    """
    row_ptr, slots, counts = tf_csr(token_rows, num_features)
    pairs = np.stack([slots, counts], axis=1)
    return [pairs[row_ptr[i]:row_ptr[i + 1]] for i in range(len(token_rows))]
