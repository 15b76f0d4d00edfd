"""Foundation layers and the ParamSpec system of the port.

Parameters are described declaratively, as in the reference: ``param_specs``
(``models/model.py``) returns a nested dict of :class:`ParamSpec`, with the
layer stack's leaves stacked ``[L, ...]`` as the reference stacks them, and
``init_leaf`` draws each leaf.  Each leaf draws from its own
``torch.Generator``, seeded from a stable digest of the seed and the leaf's
path, so a leaf's values do not depend on the order of the tree or on the
process.  A stacked layer leaf is drawn one layer at a time (a hybrid
stack's one block, or block and position, at a time), each from a generator
of its own (the digest also takes the index), so no float32 copy of a whole
stack exists (chameleon-34b's ``w_gate`` alone would be 34.6 GB; one layer
of it is 0.72 GB; jamba's MoE ``w_gate`` at one position and 8 experts 6.4
GB).  (The reference folds Python's
salted ``hash`` of the path into its key, so its weights differ between
processes; parity with it goes through ``repro_torch.interop``.)
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim, as in the reference
    init: str = "normal"  # normal | zeros | ones | fan_in
    stddev: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")

    def stacked(self, n: int) -> "ParamSpec":
        return ParamSpec((n, *self.shape), (None, *self.axes), self.init, self.stddev)


def keystr(keys) -> str:
    """A leaf's path as the reference's ``keystr`` writes it (``['layers']['attn']['wq']``)."""
    return "".join(f"['{k}']" for k in keys)


def leaf_seed(seed: int, keys, layer=None) -> int:
    """The CRC of the seed and the leaf's path, and of the slice's index
    (an int, or a tuple such as a hybrid stack's ``(block, position)``) for
    one slice of a stacked leaf."""
    idx = () if layer is None else layer if isinstance(layer, tuple) else (layer,)
    tag = f"{seed}:{keystr(keys)}" + "".join(f"[{i}]" for i in idx)
    return zlib.crc32(tag.encode())


def init_leaf(spec: ParamSpec, seed: int, device, shape=None) -> torch.Tensor:
    """One float32 leaf on ``device``: the reference's init rules (``fan_in``
    reads the second-to-last dim of ``spec``, as the reference's does).
    ``shape`` draws only that part (one layer of a stacked leaf,
    ``spec.shape[1:]``) by the same rules."""
    shape = spec.shape if shape is None else shape
    if spec.init == "zeros":
        return torch.zeros(shape, device=device)
    if spec.init == "ones":
        return torch.ones(shape, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device)
    if spec.init == "fan_in":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return x.mul_(1.0 / math.sqrt(fan_in))
    return x.mul_(spec.stddev)


def iter_specs(specs, prefix=()):
    """``(keys, ParamSpec)`` for every leaf of a nested spec dict."""
    for key, val in specs.items():
        keys = (*prefix, key)
        if isinstance(val, ParamSpec):
            yield keys, val
        else:
            yield from iter_specs(val, keys)


# ---------------------------------------------------------------------------
# Norms (computed in float32, returned in the input's dtype)
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_spec(cfg, d: int) -> dict:
    spec = {"scale": ParamSpec((d,), (None,), init="ones")}
    if cfg.norm_type == "layernorm":
        spec["bias"] = ParamSpec((d,), (None,), init="zeros")
    return spec


class Norm(torch.nn.Module):
    """LayerNorm or RMSNorm as the config names it; scale and bias stay
    float32 whatever the compute dtype, as the reference reads them."""

    def __init__(self, cfg, d: int):
        super().__init__()
        self.eps = cfg.norm_eps
        self.scale = torch.nn.Parameter(torch.ones(d), requires_grad=False)
        self.bias = None
        if cfg.norm_type == "layernorm":
            self.bias = torch.nn.Parameter(torch.zeros(d), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            return rmsnorm(x, self.scale, self.eps)
        return layernorm(x, self.scale, self.bias, self.eps)


# ---------------------------------------------------------------------------
# Rotary embeddings (half-split llama convention, partial-rotary capable)
# ---------------------------------------------------------------------------


def rope_frequencies(rot_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta**exps)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10_000.0, fraction: float = 1.0
) -> torch.Tensor:
    """x: ``[..., seq, heads, head_dim]``; positions: ``[..., seq]`` (int).
    Rotates the first ``fraction`` of each head's dims, in float32."""
    head_dim = x.shape[-1]
    rot_dim = int(head_dim * fraction) // 2 * 2
    if rot_dim == 0:
        return x
    freqs = rope_frequencies(rot_dim, theta, x.device)
    angles = (positions.float()[..., None] * freqs)[..., None, :]  # [..., s, 1, rot/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    inv = 1.0 / (10_000.0 ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    ang = positions.float()[..., None] * inv.to(positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(num_pos: int, d: int, device=None) -> torch.Tensor:
    """The classic sin/cos table ``[num_pos, d]``, float32, sines then
    cosines (whisper's encoder; the reference's ``sinusoidal_positions``)."""
    return _sinusoid(torch.arange(num_pos, device=device), d)


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The same table at integer ``positions [..., S]`` -> ``[..., S, d]``
    (whisper's decoder, at absolute positions in decode; the reference's
    ``sinusoidal_at``)."""
    return _sinusoid(positions, d)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def vocab_mask_bias(vocab_size: int, padded: int, device=None) -> torch.Tensor:
    """Additive float32 bias masking the padded vocabulary columns out of
    the softmax (-1e9 past ``vocab_size``)."""
    cols = torch.arange(padded, device=device)
    return torch.where(cols < vocab_size, 0.0, -1e9).float()


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, vocab_size: int, ignore_id: int = -1
) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is not
    ``ignore_id``; logits ``[..., Vp]`` are upcast to float32 and their
    padded columns masked, as the reference computes it."""
    from torch.distributed.tensor import DTensor

    if isinstance(logits, DTensor):
        return _cross_entropy_sharded(logits, labels, vocab_size, ignore_id)
    logits = logits.float() + vocab_mask_bias(vocab_size, logits.shape[-1], logits.device)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return ((lse - picked) * mask).sum() / mask.sum().clamp_min(1.0)


def _cross_entropy_sharded(logits, labels, vocab_size: int, ignore_id: int):
    """``cross_entropy`` on DTensor logits (a sharded step), as each rank's
    code with explicit collectives (DTensor's gather over a vocab-sharded
    dim is not usable here): the vocab-parallel log-sum-exp (the max over
    the vocab's ranks, then the sum of exponentials) and target logit, and
    the mean over the batch's ranks.  Logits stay split over the mesh dims
    that split their batch (dim 0) or their vocab (last dim); the loss
    comes out replicated."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed import comm

    mesh, last = logits.device_mesh, logits.ndim - 1
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    vocab = [i for i, pl in enumerate(logits.placements) if pl.is_shard(last)]
    batch = [i for i, pl in enumerate(logits.placements) if pl.is_shard(0)]
    l_pl = [
        Shard(last) if i in vocab else Shard(0) if i in batch else Replicate()
        for i in range(mesh.ndim)
    ]
    y_pl = [Shard(0) if i in batch else Replicate() for i in range(mesh.ndim)]
    Vp = logits.shape[-1]

    def local(lg, y):
        lo = 0
        for i in vocab:
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
        lo *= lg.shape[-1]
        bias = vocab_mask_bias(vocab_size, Vp, lg.device)[lo : lo + lg.shape[-1]]
        lg = lg.float() + bias
        m = lg.detach().amax(-1)
        for i in vocab:
            dist.all_reduce(m, dist.ReduceOp.MAX, group=mesh.get_group(i))
        se = torch.exp(lg - m[..., None]).sum(-1)
        mask = (y != ignore_id).float()
        y = y.long().clamp_min(0)
        mine = (y >= lo) & (y < lo + lg.shape[-1])
        picked = torch.gather(lg, -1, torch.where(mine, y - lo, 0)[..., None])[..., 0]
        picked = picked * mine.to(picked.dtype)
        for i in vocab:
            se = comm.all_reduce(se, mesh.get_group(i))
            picked = comm.all_reduce(picked, mesh.get_group(i))
        total, count = ((m + torch.log(se) - picked) * mask).sum(), mask.sum()
        for i in batch:
            total = comm.all_reduce(total, mesh.get_group(i))
            count = comm.all_reduce(count, mesh.get_group(i))
        return total / count.clamp_min(1.0)

    run = local_map(
        local,
        out_placements=[Replicate()] * mesh.ndim,
        in_placements=(l_pl, y_pl),
        in_grad_placements=(l_pl, y_pl),
        device_mesh=mesh,
        redistribute_inputs=True,
    )
    return run(logits, labels)
