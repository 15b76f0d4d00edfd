"""``banked_copy``'s launch plan and the Hopper kernel's walk over it.

The CUDA kernel (``src/repro_torch/kernels/banked_copy/csrc/banked_copy.cu``)
cannot run on the CPU.  ``walk`` replays what it does, byte for byte: CTA c
takes chunk c, reads its table entry and, where the entry is live, moves the
chunk's bytes from the burst to its pool row.  The replay over
``ops.copy_plan``'s plan, and over a finer plan that cuts every tile into
many chunks, is held to the port's plain version, the
JAX package's ``banked_copy_ref`` and its Pallas kernel in interpret mode
(as ``tests/test_kernels.py`` runs it); the plan itself is held to its
contract at small sizes and, by arithmetic alone, at the serving paths'
bursts.  All sizes small: the file takes seconds.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.banked_copy.kernel import banked_copy as pallas_banked_copy  # noqa: E402
from repro.kernels.banked_copy.ref import banked_copy_ref as jax_banked_copy_ref  # noqa: E402
from chip_smoke import COPY_BURSTS  # noqa: E402
from repro_torch.kernels.banked_copy.ops import MAX_CHUNK, copy_plan  # noqa: E402
from repro_torch.kernels.banked_copy.ref import banked_copy_ref  # noqa: E402

#: streaming multiprocessors of an H100 SXM
H100_SMS = 132
#: (torch dtype, JAX dtype, unsigned numpy type of the same width)
DTYPES = {
    "float32": (torch.float32, jnp.float32, np.uint32),
    "bfloat16": (torch.bfloat16, jnp.bfloat16, np.uint16),
    "int32": (torch.int32, jnp.int32, np.uint32),
}


def chunks(B: int, nblk: int, tile_bytes: int, chunk_bytes: int):
    """``(tile, offset, bytes)`` of chunk c = 0, 1, ...: part c % per_tile of
    tile c // per_tile = b * nblk + j.  The same formula as the first lines
    of ``banked_copy_kernel`` (``csrc/banked_copy.cu``)."""
    per_tile = -(-tile_bytes // chunk_bytes)
    for c in range(B * nblk * per_tile):
        tile = c // per_tile
        off = (c - tile * per_tile) * chunk_bytes
        yield tile, off, min(chunk_bytes, tile_bytes - off)


def walk(pool: torch.Tensor, new_kv: torch.Tensor, table: torch.Tensor, chunk_bytes, grid):
    """The kernel's copy replayed on bytes, in place: CTA c of ``grid`` takes
    chunk c, and moves its bytes from the burst to the pool row of its table
    entry where that lies in ``[0, NB)``.  Returns ``pool``."""
    NB = pool.shape[0]
    dst = pool.view(torch.uint8).reshape(-1)
    src = new_kv.view(torch.uint8).reshape(-1)
    tile_bytes = dst.numel() // NB
    tbl = table.reshape(-1).tolist()
    plan = list(chunks(*table.shape, tile_bytes, chunk_bytes))
    assert len(plan) == grid  # one CTA a chunk
    for tile, off, n in plan:
        row = tbl[tile]
        if 0 <= row < NB:
            d = row * tile_bytes + off
            dst[d : d + n] = src[tile * tile_bytes + off : tile * tile_bytes + off + n]
    return pool


def _data(rng, shape, dtype):
    """Bit patterns of ``dtype`` as numpy (no NaN), the same on both sides."""
    if dtype == "int32":
        return rng.integers(0, 100, shape).astype(np.int32).view(np.uint32)
    bits = rng.normal(size=shape).astype(np.float32).view(np.uint32)
    return bits if dtype == "float32" else (bits >> 16).astype(np.uint16)


def _torch(bits: np.ndarray, dtype) -> torch.Tensor:
    signed = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16}[bits.dtype]
    return torch.from_numpy(bits.view(signed).copy()).view(DTYPES[dtype][0])


def _jax(bits: np.ndarray, dtype):
    return jax.lax.bitcast_convert_type(jnp.asarray(bits), DTYPES[dtype][1])


def _bits(x, dtype) -> np.ndarray:
    unsigned = DTYPES[dtype][2]
    if torch.is_tensor(x):
        signed = {np.uint32: torch.int32, np.uint16: torch.int16}[unsigned]
        return x.view(signed).numpy().view(unsigned)
    return np.asarray(jax.lax.bitcast_convert_type(x, unsigned))


def _table(rng, B, nblk, NB, used):
    """``[B, nblk]`` int32: ``used[b]`` distinct pool rows each, -1 after."""
    tbl = np.full((B, nblk), -1, np.int32)
    rows = rng.choice(NB, sum(used), replace=False)
    k = 0
    for b, n in enumerate(used):
        tbl[b, :n] = rows[k : k + n]
        k += n
    return tbl


# (case, B, nblk, NB, bs, W, used rows per request, dtypes)
WALK_CASES = [
    ("jax_2_4_32_16_128", 2, 4, 32, 16, 128, (4, 3), ("float32", "bfloat16", "int32")),
    ("jax_3_2_16_8_256", 3, 2, 16, 8, 256, (2, 1, 2), ("float32", "bfloat16", "int32")),
    ("jax_1_8_64_32_64", 1, 8, 64, 32, 64, (5,), ("float32", "bfloat16", "int32")),
    ("unaligned_3x5", 2, 3, 16, 3, 5, (3, 2), ("float32", "bfloat16")),
    ("under_one_chunk", 1, 1, 8, 2, 8, (1,), ("float32", "bfloat16", "int32")),
    ("all_skipped", 2, 4, 32, 16, 128, (0, 0), ("float32", "bfloat16", "int32")),
    ("ragged_tails_b3", 3, 5, 32, 16, 128, (5, 3, 1), ("float32", "bfloat16", "int32")),
]


@functools.cache
def _case(case, dtype):
    """A case's pool, burst and table bits, and the pool after the copy by
    the port's plain version, held first to the JAX oracle and the Pallas
    kernel in interpret mode (computed once for both plans)."""
    _, B, nblk, NB, bs, W, used, _ = next(c for c in WALK_CASES if c[0] == case)
    rng = np.random.default_rng(B * 1000 + nblk * 100 + W)
    pool, new = _data(rng, (NB, bs, W), dtype), _data(rng, (B, nblk, bs, W), dtype)
    tbl = _table(rng, B, nblk, NB, used)
    plain = banked_copy_ref(_torch(pool, dtype), _torch(new, dtype), torch.from_numpy(tbl))
    want = _bits(plain, dtype)
    oracle = jax_banked_copy_ref(_jax(pool, dtype), _jax(new, dtype), jnp.asarray(tbl))
    pallas = pallas_banked_copy(
        _jax(pool, dtype), _jax(new, dtype), jnp.asarray(tbl), interpret=True
    )
    np.testing.assert_array_equal(_bits(oracle, dtype), want)
    np.testing.assert_array_equal(_bits(pallas, dtype), want)
    return pool, new, tbl, want


@pytest.mark.parametrize("plan", ["h100", "fine"])
@pytest.mark.parametrize(
    "case,dtype",
    [(c[0], d) for c in WALK_CASES for d in c[7]],
    ids=[f"{c[0]}-{d}" for c in WALK_CASES for d in c[7]],
)
def test_walk_over_plan_matches_references(case, dtype, plan):
    """The kernel's walk, replayed over the plan, against the port's plain
    version, the JAX oracle and the Pallas kernel in interpret mode, bit for
    bit.  ``fine`` cuts each tile into chunks of 48 bytes (12 unaligned), so
    that every tile has many chunks and a short last one."""
    pool, new, tbl, want = _case(case, dtype)
    B, nblk, _, bs, W = tbl.shape + pool.shape
    tile_bytes = bs * W * DTYPES[dtype][2]().itemsize
    aligned = tile_bytes % 16 == 0
    chunk, grid = copy_plan(B, nblk, tile_bytes, aligned, H100_SMS)
    if plan == "fine":
        chunk = 48 if aligned else 12
        grid = B * nblk * -(-tile_bytes // chunk)
    got = walk(_torch(pool, dtype), _torch(new, dtype), torch.from_numpy(tbl), chunk, grid)
    np.testing.assert_array_equal(_bits(got, dtype), want)
    if case == "all_skipped":
        np.testing.assert_array_equal(want, pool)


def _check_plan(B, nblk, tile_bytes, aligned, num_sms=H100_SMS):
    chunk, grid = copy_plan(B, nblk, tile_bytes, aligned, num_sms)
    per_tile = -(-tile_bytes // chunk)
    assert 0 < chunk <= MAX_CHUNK
    assert chunk % (128 if aligned else 4) == 0
    assert grid == B * nblk * per_tile  # one CTA a chunk
    # the tile's chunks end to end: none crosses its end, the last one is not empty
    last = tile_bytes - (per_tile - 1) * chunk
    assert 0 < last <= chunk
    return chunk, grid


PLAN_SHAPES = [
    (2, 4, 8192),
    (3, 2, 8192),
    (1, 8, 8192),
    (2, 3, 60),
    (2, 3, 32),
    (1, 1, 64),
    (3, 5, 8192),
    (1, 64, 65536),
    (1, 14, 196608),
    (4, 7, 20000),
    (2, 9, 49168),
    (1, 200, 16400),
]


@pytest.mark.parametrize(
    "B,nblk,tile_bytes,aligned",
    [(*shape, a) for shape in PLAN_SHAPES for a in (True, False) if not (a and shape[2] % 16)],
)
@pytest.mark.parametrize("num_sms", [H100_SMS, 3])
def test_plan_covers_every_byte_once(B, nblk, tile_bytes, aligned, num_sms):
    """Every byte of every tile in exactly one chunk, every chunk inside its
    tile and on the unit the alignment asks for."""
    chunk, grid = _check_plan(B, nblk, tile_bytes, aligned, num_sms)
    hits = np.zeros((B * nblk, tile_bytes), np.int32)
    for tile, off, n in chunks(B, nblk, tile_bytes, chunk):
        assert off % chunk == 0 and off + n <= tile_bytes
        hits[tile, off : off + n] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("arch", list(COPY_BURSTS))
def test_plan_fills_the_card_at_the_serving_bursts(arch):
    """At each serving path's burst (``chip_smoke.COPY_BURSTS``: bf16, blocks
    of 16) the grid holds at least 132 CTAs wherever the burst has at least
    132 x 4 KB."""
    _, nblk, W, *_ = COPY_BURSTS[arch]
    tile_bytes = 16 * W * 2
    chunk, grid = _check_plan(1, nblk, tile_bytes, True)
    if nblk * tile_bytes >= H100_SMS * 4096:
        assert grid >= H100_SMS
