"""Streaming P² quantile accumulators: fixed-size latency summaries.

The port of the reference package's ``core/percentile.py``.  The exact
collection path keeps one acceptance and one completion timestamp per
transaction; ``collect="stream"`` keeps instead, per (view, class, direction)
group, the five markers of the P² algorithm (Jain & Chlamtac, CACM 1985) for
each tracked quantile: 5 heights, 5 marker positions and one count, nothing
sized by the transaction count.

The simulator completes several transactions per cycle, so :func:`p2_update`
ingests a whole masked batch of observations per call: marker positions
advance by the count of observations below each marker, each inner marker
then takes up to :data:`ADJUST_PASSES` unit parabolic/linear adjustments, and
while a group has seen fewer than 5 observations the heights are a sorted
sample buffer, seeded into markers by the call that crosses 5.

Every in-loop tensor carries a leading lane axis ``B``.  The arithmetic is the
reference's, operation for operation and in its order, so the float32 results
round as the reference's do.  Inside its compiled cycle loop the reference's
compiler contracts each multiply that feeds an add into one fused
multiply-add, rounded once; :func:`_fma` does the same here.  :func:`p2_quantiles` and
:func:`p2_merge_quantile` are numpy copies of the reference's host-side
read-out and cross-lane merge.
"""

from __future__ import annotations

import math

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

#: percentiles every streaming run tracks (matches ``scenarios.sweep``)
STREAM_PCTS: Tuple[float, ...] = (50.0, 95.0, 99.0)

#: documented rank tolerance of the streaming estimate, percentile points
P2_RANK_TOL_PCT = 10.0
#: relative slack on the rank band (float32 accumulation)
P2_REL_TOL = 5e-3
#: sample count below which the documented bound does not apply
P2_MIN_SAMPLES = 40

#: unit marker adjustments per batched update call
ADJUST_PASSES = 3

#: large-but-finite filler for empty buffer slots (float32-safe)
_FILL = float(np.float32(3.0e38))


def p2_desired_fracs(qs: Sequence[float]) -> np.ndarray:
    """[NQ, 5] marker CDF positions (0, q/2, q, (1+q)/2, 1) per quantile."""
    q = np.asarray(qs, np.float32)
    return np.stack([np.zeros_like(q), q / 2, q, (1 + q) / 2, np.ones_like(q)], axis=-1)


@lru_cache(maxsize=None)
def desired_fracs(qs: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """:func:`p2_desired_fracs` of the percentiles ``qs`` as a float32 tensor
    on ``device``, made once (a CUDA graph may replay an update, but cannot
    capture a copy from host memory)."""
    return torch.from_numpy(p2_desired_fracs([q / 100.0 for q in qs])).to(device)


def p2_init(num_lanes: int, num_groups: int, num_q: int, device=None):
    """Zero-observation state of ``num_lanes`` lanes: (heights [B, G, NQ, 5],
    marker positions [B, G, NQ, 5], counts [B, G]); heights start at the
    empty-slot filler."""
    shape = (num_lanes, num_groups, num_q, 5)
    pos = torch.arange(1.0, 6.0, dtype=torch.float32, device=device)
    return (
        torch.full(shape, _FILL, dtype=torch.float32, device=device),
        pos.expand(shape).contiguous(),
        torch.zeros((num_lanes, num_groups), dtype=torch.int32, device=device),
    )


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """``a * b + c`` in float32 with one rounding, as a fused multiply-add.

    The float64 product of two float32 values is exact.  Its float64 sum
    with ``c`` is rounded to odd (round-to-odd: where the sum is inexact,
    TwoSum gives its exact error, and a sum whose last mantissa bit is even
    steps one ulp towards that error), and only then to float32: with 53
    bits against float32's 24 (at least 24 + 2), the two roundings give the
    one rounding of the exact ``a * b + c``.  (A plain float64 sum rounded
    again to float32 could differ where the sum lies within 2**-53 of a
    float32 midpoint.)"""
    p = a.double() * b.double()
    c = c.double() if torch.is_tensor(c) else float(c)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, err * math.inf), s)
    return s.float()


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, 1.0, x)


def _adjust_once(h, n, desired, active):
    """One unit adjustment pass over the inner markers (i = 1, 2, 3);
    ``h``, ``n``, ``desired`` [B, G, NQ, 5], ``active`` [B, G]."""
    h, n = list(h.unbind(-1)), list(n.unbind(-1))
    for i in (1, 2, 3):
        d = desired[..., i] - n[i]
        nl, ni, nr = n[i - 1], n[i], n[i + 1]
        hl, hi, hr = h[i - 1], h[i], h[i + 1]
        s = torch.where(
            (d >= 1) & (nr - ni > 1), 1.0, torch.where((d <= -1) & (nl - ni < -1), -1.0, 0.0)
        )
        move = (s != 0) & active[..., None]
        up = (ni - nl + s) * (hr - hi) / _safe(nr - ni)
        down = (nr - ni - s) * (hi - hl) / _safe(ni - nl)
        par = _fma(s / _safe(nr - nl), up + down, hi)
        lin_n = torch.where(s > 0, nr, nl)
        lin_h = torch.where(s > 0, hr, hl)
        lin = hi + s * (lin_h - hi) / _safe(lin_n - ni)
        new_h = torch.where((hl < par) & (par < hr), par, lin)
        h[i] = torch.where(move, new_h, hi)
        n[i] = torch.where(move, ni + s, ni)
    return torch.stack(h, -1), torch.stack(n, -1)


def p2_update(height, npos, count, values, gid, mask, *, qs: Sequence[float] = STREAM_PCTS):
    """Ingest one masked batch of observations per lane into every group.

    ``height``/``npos``: [B, G, NQ, 5] float32, ``count``: [B, G] int32 (the
    state from :func:`p2_init`), ``values``: [B, M] float32 observations,
    ``gid``: [B, M] group per observation, ``mask``: [B, M] bool.  Returns the
    updated (height, npos, count).  Reads nothing back to the host.

    An all-False ``mask`` is a bit-exact no-op; the simulator's idle-cycle
    time skip relies on it."""
    B, G, NQ, _ = height.shape
    dev = height.device
    frac = desired_fracs(tuple(qs), dev)  # [NQ, 5]
    groups = torch.arange(G, device=dev)
    onehot = mask[:, None, :] & (gid[:, None, :] == groups[None, :, None])  # [B, G, M]
    k = onehot.sum(2, dtype=torch.int32)  # [B, G]
    total = count + k
    vals = values[:, None, :]
    vals_g = torch.where(onehot, vals, _FILL)  # [B, G, M]

    # --- steady path (count >= 5): counted marker advance + adjustment ---
    gmin = vals_g.amin(2)
    gmax = torch.where(onehot, vals, -_FILL).amax(2)
    h_lo = torch.minimum(height[..., 0], gmin[..., None])
    h_hi = torch.maximum(height[..., 4], torch.where(k > 0, gmax, -_FILL)[..., None])
    h = torch.stack([h_lo, height[..., 1], height[..., 2], height[..., 3], h_hi], -1)
    # observations strictly below an inner marker advance its position;
    # every observation advances the max marker
    below = (values[:, None, None, None, :] < height[..., 1:4, None]) & onehot[
        :, :, None, None, :
    ]  # [B, G, NQ, 3, M]
    n_in = npos[..., 1:4] + below.sum(-1, dtype=torch.int32).to(torch.float32)
    n_hi = npos[..., 4] + k[..., None].to(torch.float32)
    n = torch.cat([npos[..., :1], n_in, n_hi[..., None]], -1)
    desired = _fma(frac, total[..., None, None] - 1.0, 1.0)
    active = k > 0
    for _ in range(ADJUST_PASSES):
        h, n = _adjust_once(h, n, desired, active)

    # --- init path (count < 5): sorted buffer, seed markers on crossing ---
    slot_live = torch.arange(5, device=dev) < count[..., None]
    buf = torch.cat([torch.where(slot_live, height[:, :, 0, :], _FILL), vals_g], 2)
    sbuf = torch.sort(buf, dim=2).values  # [B, G, 5 + M]
    tc = torch.clamp(total, min=1)
    top = (tc - 1).to(torch.float32)[..., None, None]
    pick = torch.round(frac * (tc[..., None, None] - 1.0))
    idx = torch.minimum(torch.clamp(pick, min=0), top).to(torch.int32)  # [B, G, NQ, 5]
    # steady groups (count >= 5) may point past the buffer; their pick is
    # discarded below, so clamp it as the reference's gather does
    at = torch.clamp(idx, max=sbuf.shape[2] - 1).reshape(B, G, NQ * 5).long()
    picked = torch.gather(sbuf, 2, at).reshape(B, G, NQ, 5)
    crossed = (total >= 5)[..., None, None]
    ones = torch.ones((1, 1, NQ, 1), device=dev)
    init_h = torch.where(crossed, picked, sbuf[:, :, None, :5] * ones)
    init_n = torch.where(crossed, idx.to(torch.float32) + 1.0, torch.arange(1.0, 6.0, device=dev))

    use_init = (count < 5)[..., None, None]
    return torch.where(use_init, init_h, h), torch.where(use_init, init_n, n), total


def p2_quantiles(height, npos, count, *, qs: Sequence[float] = STREAM_PCTS) -> np.ndarray:
    """Host-side read-out of one lane: [G, NQ] estimates (NaN for empty
    groups).  Groups still in the init regime (< 5 observations) interpolate
    their sorted sample buffer exactly; steady groups report the central
    marker."""
    h = np.asarray(height, np.float64)
    c = np.asarray(count)
    G, NQ, _ = h.shape
    out = np.full((G, NQ), np.nan)
    for g in range(G):
        if c[g] <= 0:
            continue
        if c[g] < 5:
            buf = np.sort(h[g, 0, :])[: c[g]]
            out[g] = [np.percentile(buf, q) for q in qs]
        else:
            out[g] = h[g, :, 2]
    return out


def p2_merge_quantile(heights, nposs, counts, q: float) -> float:
    """Merge per-lane P² states into one quantile estimate (host-side).

    ``heights``/``nposs``: [B, 5] (one tracked quantile's markers per lane),
    ``counts``: [B].  Each lane's markers define a piecewise-linear CDF
    (height_j at rank npos_j / count); the merged estimate inverts the
    count-weighted mixture of those CDFs at ``q`` (a fraction in [0, 1]).
    """
    h = np.asarray(heights, np.float64)
    n = np.asarray(nposs, np.float64)
    c = np.asarray(counts, np.float64)
    live = c > 0
    if not live.any():
        return float("nan")
    h, n, c = h[live], n[live], c[live]
    # init-regime lanes: markers past the count are filler; clamp their CDF
    # to the populated prefix
    xs = np.unique(
        np.concatenate([hk[: max(int(min(ck, 5)), 1)] for hk, ck in zip(np.sort(h, axis=1), c)])
    )
    cdf = np.zeros_like(xs)
    for hk, nk, ck in zip(h, n, c):
        m = max(int(min(ck, 5)), 1)
        hk, nk = hk[:m], nk[:m]
        order = np.argsort(hk, kind="stable")
        cdf += ck * np.interp(
            xs, hk[order], np.maximum.accumulate(nk[order]) / ck, left=0.0, right=1.0
        )
    cdf /= c.sum()
    return float(np.interp(q, cdf, xs))
