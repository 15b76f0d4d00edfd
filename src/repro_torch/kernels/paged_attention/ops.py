"""Entry point of paged decode attention.

``paged_attention`` is what each decode step's attention calls, once per
layer, over that layer's K and V views of the pool.  On CUDA tensors it
launches the hand-written Hopper kernels (``csrc/paged_attention.cu``): the
split pass, one launch for every (group, request, span of the KV length),
counted in ``repro_torch.kernels.LAUNCHES["paged_attention"]``, then the
merge pass, counted under ``"paged_attention_merge"``.  The number of splits
comes from the block table's width, so the wrapper reads no device tensor on
the host.  On CPU tensors it runs the plain version (``ref.py``).  There is
no fallback between the two.

``window > 0`` (h2o-danube's sliding window) makes request ``b`` attend to
its tokens ``max(0, lengths[b] - window) .. lengths[b] - 1``: the splits
wholly before that start exit at once and write no partial, the one that
holds it masks the rows below it, and the merge starts at that split.  The
launches stay one split and one merge a call.  The latent call takes no
window (MLA's configs have none) and refuses one.

MLA's absorbed decode (deepseek-v2) makes a call of its own shape
(``LATENT``): one KV group of 16 query heads, K the layer's latent rows of
576 and V the first 512 columns of the same rows, passed as a view of K's
first columns (same storage, same strides).  The wrapper sees V's narrower
width.  In bf16 it launches ``paged_latent_bf16``, one kernel that reads
each row once on the tensor cores and merges through a thread-block
cluster per request (``LATENT_CLUSTER`` CTAs), counted under
``"paged_attention"`` alone; in float32 (the check path) the split pass
``paged_latent_split_f32`` and the merge at V's width, counted under the
same two names as the GQA call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

#: head dims the kernel is built for (16-byte pieces of a token row per lane;
#: 80: stablelm-3b and h2o-danube)
HEAD_DIMS = (16, 32, 64, 80, 128)
#: query heads per KV group the kernel holds in registers
MAX_HEADS_PER_GROUP = 8
#: most splits the merge stages in shared memory (48 KB)
MAX_SPLITS = 6144
#: tokens a split covers at least: whole pool blocks, ceil(SPLIT_TOKENS / bs) of them
SPLIT_TOKENS = 256
#: MLA's latent call: (query heads, K width, V width), one KV group
LATENT = (16, 576, 512)
#: CTAs per request of the bf16 latent call: one thread-block cluster, each
#: CTA ceil(length / LATENT_CLUSTER) of the request's tokens
LATENT_CLUSTER = 16
#: token rows of a stage of the bf16 latent kernel (``stage_rows`` of the plain replay)
LATENT_STAGE_ROWS = 32
#: block table entries of a request that the bf16 latent call stages (the kernel's ``kMaxTbl``)
LATENT_MAX_TABLE = 1024
#: tokens a split of the float32 latent call covers at least: one batch of its kernel's rows
LATENT_SPLIT_TOKENS = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fns: dict = {}


def _kernel_fns():
    if not _fns:
        lib = _build.load("paged_attention")
        split = lib.paged_attention_split
        split.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 2
        split.argtypes += [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        latent = lib.paged_attention_latent
        latent.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
        latent.argtypes += [ctypes.c_float, ctypes.c_void_p]
        latent_split = lib.paged_attention_latent_split
        latent_split.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        latent_split.argtypes += [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p]
        merge = lib.paged_attention_merge
        merge.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
        for fn in (split, latent, latent_split, merge):
            fn.restype = ctypes.c_int
        _fns.update(split=split, latent=latent, latent_split=latent_split, merge=merge)
    return _fns


def blocks_per_split(block_size: int, *, latent: bool = False) -> int:
    """Pool blocks per split: the fewest whole blocks covering
    ``SPLIT_TOKENS`` (``LATENT_SPLIT_TOKENS`` for the latent call)."""
    return -(-(LATENT_SPLIT_TOKENS if latent else SPLIT_TOKENS) // block_size)


def _is_prefix_view(k_pool: torch.Tensor, v_pool: torch.Tensor) -> bool:
    """Whether ``v_pool`` is ``k_pool[..., :Dv]``: the same rows, fewer columns."""
    return (
        v_pool.data_ptr() == k_pool.data_ptr()
        and v_pool.stride() == k_pool.stride()
        and v_pool.shape[:3] == k_pool.shape[:3]
        and v_pool.shape[3] <= k_pool.shape[3]
    )


def _check_latent(q, k_pool, v_pool, block_table, lengths) -> None:
    """The latent call's shapes (``LATENT``); the rest as ``_check``."""
    H, Dk, Dv = LATENT
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.dim() != 4:
        raise ValueError(
            f"q must be [B, H, D] and the pools [NB, bs, G, D]; got {tuple(q.shape)}, "
            f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}"
        )
    if (q.shape[1:], k_pool.shape[2:], v_pool.shape[2:]) != ((H, Dk), (1, Dk), (1, Dv)):
        raise ValueError(
            f"a V width of its own is the latent call: q [B, {H}, {Dk}], K [NB, bs, 1, {Dk}] "
            f"and V [NB, bs, 1, {Dv}]; got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(v_pool.shape)}"
        )
    if not _is_prefix_view(k_pool, v_pool):
        raise ValueError("the latent call's V must be a view of K's first columns")
    if k_pool.stride(3) != 1:
        raise ValueError(f"latent rows must be contiguous; strides {k_pool.stride()}")
    if block_table.dim() == 2 and block_table.shape[1] > LATENT_MAX_TABLE:
        raise ValueError(
            f"the latent call takes block tables of at most {LATENT_MAX_TABLE} entries; "
            f"got {block_table.shape[1]}"
        )
    _check_common(q, k_pool, v_pool, block_table, lengths, latent=True)


def _check(q, k_pool, v_pool, block_table, lengths) -> None:
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"q must be [B, H, D] and k/v pools one [NB, bs, G, D] shape; got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}"
        )
    B, H, D = q.shape
    NB, bs, G, Dk = k_pool.shape
    if Dk != D or H % G or D not in HEAD_DIMS or H // G > MAX_HEADS_PER_GROUP:
        raise ValueError(
            f"H={H}, G={G}, D={D}: the kernel takes D in {HEAD_DIMS} and at most "
            f"{MAX_HEADS_PER_GROUP} query heads per KV group"
        )
    for pool in (k_pool, v_pool):
        if pool.stride()[2:] != (D, 1):
            raise ValueError(f"pool views need contiguous [G, D] rows; strides {pool.stride()}")
    if k_pool.stride() != v_pool.stride():
        raise ValueError(f"k/v pool strides differ: {k_pool.stride()} vs {v_pool.stride()}")
    _check_common(q, k_pool, v_pool, block_table, lengths, latent=False)


def _check_common(q, k_pool, v_pool, block_table, lengths, *, latent: bool) -> None:
    B = q.shape[0]
    bs, G = k_pool.shape[1], k_pool.shape[2]
    if block_table.dim() != 2 or block_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError(
            f"block_table must be [B, mb] and lengths [B]; got {tuple(block_table.shape)}, "
            f"{tuple(lengths.shape)}"
        )
    if q.dtype not in _DTYPES or {k_pool.dtype, v_pool.dtype} != {q.dtype}:
        raise TypeError(f"q/k/v must share float32 or bfloat16; got {q.dtype}/{k_pool.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    devices = {q.device, k_pool.device, v_pool.device, block_table.device, lengths.device}
    if q.device.type != "cuda" or len(devices) != 1:
        raise ValueError(f"all inputs must lie on one CUDA device; got {devices}")
    if not (q.is_contiguous() and block_table.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("q, block_table and lengths must be contiguous")
    vec = 16 // q.element_size()
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)) or k_pool.stride(0) % vec or (
        k_pool.stride(1) % vec
    ):
        raise ValueError("q and the pools must start on 16 bytes and step by 16-byte rows")
    nsplit = -(-block_table.shape[1] // blocks_per_split(bs, latent=latent))
    if B >= 2**16 or G >= 2**31 or nsplit > MAX_SPLITS:
        raise ValueError(f"grid too large: B={B}, G={G}, splits={nsplit}")


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale=None,
    window: int = 0,
    return_lse: bool = False,
):
    """q ``[B, H, D]``; k pool ``[NB, bs, G, D]``, v pool ``[NB, bs, G, Dv]``
    (strided views allowed, ``[G, D]`` contiguous; ``Dv == D``, or the
    latent call, ``LATENT``, with V a view of K's first columns);
    block_table ``[B, mb]`` int32 (-1 = unused); lengths ``[B]`` int32;
    ``window`` 0 (none) or the most recent tokens a request attends to.
    Returns ``[B, H, Dv]`` in q's dtype; ``scale`` defaults to ``D ** -0.5``.
    ``return_lse``: ``(out, lse)``, ``lse [B, H]`` float32 each head's
    log-sum-exp of its scaled scores (-inf where no token is valid),
    written by the merge (the bf16 latent call: by its cluster's merge)
    beside the output, what a merge across ranks that split a sequence's
    tokens weighs each rank's output by."""
    window = int(window)
    if window < 0 or window >= 2**31:
        raise ValueError(f"window must be 0 (none) or a positive token count; got {window}")
    if q.device.type == "cpu":
        return paged_attention_ref(
            q, k_pool, v_pool, block_table, lengths, scale=scale, window=window,
            return_lse=return_lse,
        )
    latent = v_pool.dim() == 4 and v_pool.shape[3] != q.shape[-1]
    if latent and window:
        raise ValueError("the latent call takes no window (MLA's configs have none)")
    if latent:
        _check_latent(q, k_pool, v_pool, block_table, lengths)
    else:
        _check(q, k_pool, v_pool, block_table, lengths)
    B, H, D = q.shape
    _, bs, G, Dv = v_pool.shape
    mb = block_table.shape[1]
    scale = float(scale if scale is not None else D**-0.5)
    out = q.new_empty((B, H, Dv))
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    lse_ptr = lse.data_ptr() if return_lse else None
    if B == 0:
        return (out, lse) if return_lse else out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fns = _kernel_fns()
    ptrs = (q.data_ptr(), k_pool.data_ptr())
    if latent and q.dtype == torch.bfloat16:
        err = fns["latent"](
            *ptrs,
            block_table.data_ptr(),
            lengths.data_ptr(),
            out.data_ptr(),
            lse_ptr,
            B,
            mb,
            bs,
            k_pool.stride(0),
            k_pool.stride(1),
            scale,
            stream,
        )
        if err != 0:
            raise RuntimeError(f"paged_attention latent kernel launch failed: cudaError_t {err}")
        LAUNCHES["paged_attention"] += 1
        return (out, lse) if return_lse else out
    bps = blocks_per_split(bs, latent=latent)
    nsplit = -(-mb // bps)
    part_acc = torch.empty((B, H, nsplit, Dv), dtype=torch.float32, device=q.device)
    part_ms = torch.empty((B, H, nsplit, 2), dtype=torch.float32, device=q.device)
    parts = (part_acc.data_ptr(), part_ms.data_ptr())
    tail = (k_pool.stride(0), k_pool.stride(1), scale)
    if nsplit and latent:
        err = fns["latent_split"](
            *ptrs, block_table.data_ptr(), lengths.data_ptr(), *parts, B, mb, bs, bps, *tail, stream
        )
    elif nsplit:
        err = fns["split"](
            *ptrs,
            v_pool.data_ptr(),
            block_table.data_ptr(),
            lengths.data_ptr(),
            *parts,
            B,
            H,
            G,
            D,
            mb,
            bs,
            bps,
            *tail,
            window,
            _DTYPES[q.dtype],
            stream,
        )
    if nsplit:
        if err != 0:
            raise RuntimeError(f"paged_attention split kernel launch failed: cudaError_t {err}")
        LAUNCHES["paged_attention"] += 1
    err = fns["merge"](
        *parts,
        lengths.data_ptr(),
        out.data_ptr(),
        B,
        H,
        Dv,
        mb,
        bs,
        bps,
        window,
        _DTYPES[q.dtype],
        lse_ptr,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_attention merge kernel launch failed: cudaError_t {err}")
    LAUNCHES["paged_attention_merge"] += 1
    return (out, lse) if return_lse else out
