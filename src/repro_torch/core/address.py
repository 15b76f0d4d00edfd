"""Structural + fractal address randomization (the paper's §II-C dispatch rules).

A numpy copy of the reference package's host-side address map, so the port
never imports the reference: a beat address selects a slice (``slice_of_beat``),
then the slice-local address is spread round-robin across clusters and arrays
(structural rule) and whitened by a multiplicative hash (fractal rule).

The dense simulator maps every beat to its bank on the host before the cycle
loop starts (the numpy functions).  The event-schedule pipeline maps the
candidate burst's beats inside the cycle loop, with the ``*_dev`` tensor
twins, which give the numpy functions' values on int32 tensors of any shape.

Every function is pure.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Knuth multiplicative constants (odd -> bijective mod 2^32)
_MULT1 = np.uint32(0x9E3779B1)
_MULT2 = np.uint32(0x85EBCA77)

SLICE_POLICIES = ("hash", "region")


@dataclass(frozen=True)
class MemoryGeometry:
    """Prototype geometry from §III: X=16 masters, M=4 clusters, N=4 arrays,
    K=16 logic banks per array, beats of 256 bit (32 B).

    ``num_slices`` tiles that prototype: each slice is a full memory instance
    (``total_bytes`` of capacity, ``num_arrays * banks_per_array`` banks), so
    ``beats_total``/``num_banks`` scale with the slice count.
    """

    num_masters: int = 16
    num_clusters: int = 4  # M  (level-1 split)
    arrays_per_cluster: int = 4  # N  (level-2 split)
    banks_per_array: int = 16  # K
    sub_banks: int = 4  # isolation granules per logic bank
    beat_bytes: int = 32  # 256-bit data width
    total_bytes: int = 32 * 2**20  # 32 MB per slice
    num_slices: int = 1  # memory instances behind the interconnect
    slice_policy: str = "hash"  # hash | region
    slice_granule: int = 64  # beats per slice-interleave chunk (hash)

    def __post_init__(self):
        if self.num_slices < 1:
            raise ValueError(f"num_slices must be >= 1; got {self.num_slices}")
        if self.slice_policy not in SLICE_POLICIES:
            raise ValueError(
                f"slice_policy must be one of {SLICE_POLICIES}; got {self.slice_policy!r}"
            )
        if self.slice_granule < 1 or self.beats_per_slice % self.slice_granule:
            raise ValueError(
                f"slice_granule must be >= 1 and divide beats_per_slice "
                f"({self.beats_per_slice}); got {self.slice_granule}"
            )

    @property
    def num_arrays(self) -> int:
        return self.num_clusters * self.arrays_per_cluster

    @property
    def banks_per_slice(self) -> int:
        return self.num_arrays * self.banks_per_array

    @property
    def num_banks(self) -> int:
        """Total banks across every slice (== banks_per_slice at 1 slice)."""
        return self.num_slices * self.banks_per_slice

    @property
    def beats_per_slice(self) -> int:
        return self.total_bytes // self.beat_bytes

    @property
    def beats_total(self) -> int:
        """Total addressable beats across every slice."""
        return self.num_slices * self.beats_per_slice

    def slice_span(self, s: int):
        """[lo, hi) beat span owned by slice ``s`` under the ``"region"`` policy."""
        bps = self.beats_per_slice
        return s * bps, (s + 1) * bps


def _hash32(x):
    """Cheap avalanche hash (xorshift-multiply) on uint32; the wraparound of
    the multiplies is intentional (mod-2^32 multiplicative hashing)."""
    x = np.asarray(x, np.uint32) if not hasattr(x, "dtype") or isinstance(x, np.generic) else x
    with np.errstate(over="ignore"):
        x = x ^ (x >> 16)
        x = x * _MULT1
        x = x ^ (x >> 13)
        x = x * _MULT2
        x = x ^ (x >> 16)
    return x


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m mod 2**32`` for int64 ``x`` in ``[0, 2**32)``: the multiplier
    split into 16-bit halves keeps every intermediate below ``2**49`` (one
    int64 product of two 32-bit values would overflow)."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _hash32_dev(x: torch.Tensor) -> torch.Tensor:
    """Tensor twin of :func:`_hash32`: the same uint32 avalanche in int64
    arithmetic.  ``x`` is read as uint32 (a negative int32 wraps, as a cast
    to uint32 would); the result is int64 in ``[0, 2**32)``."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x ^ (x >> 16)
    x = _mul32(x, int(_MULT1))
    x = x ^ (x >> 13)
    x = _mul32(x, int(_MULT2))
    return x ^ (x >> 16)


def _hash_mod(x: torch.Tensor, n: int) -> torch.Tensor:
    """``_hash32(x) % n`` as int32: reduced before it enters the signed domain."""
    return (_hash32_dev(x) % n).to(torch.int32)


def slice_of_beat_dev(beat_addr: torch.Tensor, geom: MemoryGeometry = MemoryGeometry()):
    """Tensor twin of :func:`slice_of_beat` in int32 arithmetic."""
    a = beat_addr.to(torch.int32)
    nsl = geom.num_slices
    if nsl == 1:
        return torch.zeros_like(a), a
    if geom.slice_policy == "region":
        bps = geom.beats_per_slice
        return a // bps, a % bps
    g = geom.slice_granule
    chunk = a // g
    rnd = chunk // nsl
    sl = (chunk % nsl + _hash_mod(rnd, nsl)) % nsl
    return sl, rnd * g + a % g


def _map_beat_local_dev(local_addr: torch.Tensor, geom: MemoryGeometry):
    """Tensor twin of :func:`_map_beat_local` in int32 arithmetic."""
    a = local_addr.to(torch.int32)
    mc, na, kb = geom.num_clusters, geom.arrays_per_cluster, geom.banks_per_array
    cluster = a % mc
    hi1 = a // (mc * na)
    arr = ((a // mc) % na + _hash_mod(hi1, na)) % na
    bank = (hi1 % kb + _hash_mod(hi1 // kb + 0x5BD1, kb)) % kb
    return cluster, arr, bank


def flat_bank_id_dev(beat_addr: torch.Tensor, geom: MemoryGeometry = MemoryGeometry()):
    """Tensor twin of :func:`flat_bank_id` (int32): the schedule pipeline's
    in-loop bank map.  Addresses must lie in ``[0, beats_total)``."""
    sl, local = slice_of_beat_dev(beat_addr, geom)
    c, a, b = _map_beat_local_dev(local, geom)
    flat = (c * geom.arrays_per_cluster + a) * geom.banks_per_array + b
    return sl * geom.banks_per_slice + flat


def slice_of_beat(beat_addr, geom: MemoryGeometry = MemoryGeometry()):
    """Slice-select level above the cluster split: beat address ->
    ``(slice, slice_local_addr)``, a bijection onto
    ``num_slices x [0, beats_per_slice)``.

      * ``"region"``: a slice owns a contiguous span; local = offset within it.
      * ``"hash"``: ``slice_granule``-beat chunks round-robin across slices with
        a per-round hash offset, so linear streams balance across slices.

    ``num_slices=1`` returns the address unchanged.
    """
    a = np.asarray(beat_addr).astype(np.int64)
    nsl = geom.num_slices
    if nsl == 1:
        return np.zeros_like(a, dtype=np.int32), a
    if geom.slice_policy == "region":
        bps = geom.beats_per_slice
        return (a // bps).astype(np.int32), a % bps
    g = geom.slice_granule
    chunk = a // g
    rnd = chunk // nsl
    sl = (chunk + _hash32(rnd.astype(np.uint32)).astype(np.int64)) % nsl
    local = rnd * g + a % g
    return sl.astype(np.int32), local


def _map_beat_local(local_addr, geom: MemoryGeometry):
    """Slice-local beat address -> (cluster, array, bank-in-array)."""
    a = np.asarray(local_addr).astype(np.int64)
    mc = geom.num_clusters
    na = geom.arrays_per_cluster
    kb = geom.banks_per_array
    cluster = a % mc
    arr = (a // mc) % na
    # fractal whitening of the array index by higher address bits
    hi1 = (a // (mc * na)).astype(np.int64)
    arr = (arr + _hash32(hi1.astype(np.uint32)).astype(np.int64)) % na
    bank = hi1 % kb
    hi2 = (hi1 // kb).astype(np.int64)
    bank = (bank + _hash32((hi2 + 0x5BD1).astype(np.uint32)).astype(np.int64)) % kb
    return cluster.astype(np.int32), arr.astype(np.int32), bank.astype(np.int32)


def map_beat(beat_addr, geom: MemoryGeometry = MemoryGeometry()):
    """Map a beat-granular address to (cluster, array, bank-in-array) within
    its slice (use :func:`slice_of_beat` for the slice index itself)."""
    _, local = slice_of_beat(beat_addr, geom)
    return _map_beat_local(local, geom)


def flat_bank_id(beat_addr, geom: MemoryGeometry = MemoryGeometry()):
    """Global bank id in [0, num_banks) for a beat address, slice-major:
    bank ``i`` lives in slice ``i // banks_per_slice``."""
    sl, local = slice_of_beat(beat_addr, geom)
    c, a, b = _map_beat_local(local, geom)
    flat = (c * geom.arrays_per_cluster + a) * geom.banks_per_array + b
    return (np.asarray(sl).astype(np.int64) * geom.banks_per_slice + flat).astype(np.int32)


def slice_of_bank(bank_id, geom: MemoryGeometry = MemoryGeometry()):
    """Which slice a global bank id (from :func:`flat_bank_id`) lives in."""
    return (np.asarray(bank_id) // geom.banks_per_slice).astype(np.int32)


def master_home_slices(num_masters: int, geom: MemoryGeometry = MemoryGeometry()) -> np.ndarray:
    """Home slice per master port: contiguous blocks of the geometry's
    ``num_masters`` ports attach to each slice.  Rows past the geometry's
    port count (inert padding rows) clip to the last slice."""
    m = np.arange(max(num_masters, 1), dtype=np.int64)
    ports = max(geom.num_masters, 1)
    home = (m * geom.num_slices) // ports
    return np.minimum(home, geom.num_slices - 1).astype(np.int32)


def slice_hops(beat_addr, home_slice, geom: MemoryGeometry = MemoryGeometry()) -> np.ndarray:
    """Inter-slice hop count a beat pays: ring distance between the issuing
    master's home slice and the beat's target slice (0 when local)."""
    sl, _ = slice_of_beat(beat_addr, geom)
    d = np.abs(np.asarray(sl, np.int64) - np.asarray(home_slice, np.int64))
    return np.minimum(d, geom.num_slices - d).astype(np.int32)


def sub_bank_id(beat_addr, geom: MemoryGeometry = MemoryGeometry()):
    """Isolation granule: which sub-bank of its logic bank a beat lands in."""
    a = np.asarray(beat_addr).astype(np.int64)
    region = a // (geom.beats_total // geom.sub_banks)
    return np.clip(region, 0, geom.sub_banks - 1).astype(np.int32)


def fractal_permute(n: int, seed: int = 0) -> np.ndarray:
    """Deterministic whitening permutation of range(n).

    Used where the framework assigns *slots* in a shared pool (MoE capacity
    slots, KV blocks): consumers iterating linearly get spread the same way the
    paper spreads burst beats.  Bijection built from the same hash family.
    """
    idx = np.arange(n, dtype=np.uint32)
    with np.errstate(over="ignore"):
        keys = _hash32(idx + np.uint32(seed) * _MULT2)
    return np.argsort(keys, kind="stable").astype(np.int32)
