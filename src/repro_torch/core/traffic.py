"""Traffic generators for the paper's experiments (§III-A), numpy copies.

Every generator returns a :class:`~repro_torch.core.simulator.Trace`
([X, N] arrays, beat-granular addresses) and gives the same trace as the
reference package's generator of the same name for the same arguments and
seed.  ``full_duplex`` splits each master into an independent read port and
write port (AXI R/W channels issue independently: 2X internal ports).
The packed ``EventSchedule`` form arrives with the schedule pipeline.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.address import MemoryGeometry
from repro_torch.core.simulator import Trace

BEAT = 32  # bytes per 256-bit beat


def pad_rows(rows: Sequence[np.ndarray], n: Optional[int] = None) -> np.ndarray:
    """Stack variable-length 1-D rows into an [X, n] int32 array, zero-padded
    (burst==0 entries are ignored by the simulator)."""
    n = n or max(len(r) for r in rows)
    out = np.zeros((len(rows), n), np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def pad_trace(trace: Trace, num_masters: int, num_txns: int) -> Trace:
    """Grow a trace to [num_masters, num_txns] with inert padding (burst 0)."""
    X, N = trace.is_write.shape
    if X > num_masters or N > num_txns:
        raise ValueError(f"cannot shrink trace {X}x{N} to {num_masters}x{num_txns}")

    def grow(a, fill=0):
        out = np.full((num_masters, num_txns), fill, np.int32)
        out[:X, :N] = a
        return out

    start = None if trace.start is None else grow(trace.start)
    prio = None
    if trace.prio is not None:  # padding masters never issue; level 0 is inert
        prio = np.zeros((num_masters,), np.int32)
        prio[:X] = np.asarray(trace.prio, np.int32)
    return Trace(grow(trace.is_write), grow(trace.burst), grow(trace.addr), start, prio)


def stack_traces(traces: Sequence[Trace]) -> List[Trace]:
    """Pad a batch of traces to their common [X, N] envelope."""
    X = max(t.is_write.shape[0] for t in traces)
    N = max(t.is_write.shape[1] for t in traces)
    return [pad_trace(t, X, N) for t in traces]


def random_uniform(
    num_masters: int,
    num_txns: int,
    *,
    burst: int = 16,
    read_fraction: float = 0.5,
    seed: int = 0,
    geom: MemoryGeometry = MemoryGeometry(),
    full_duplex: bool = True,
) -> Trace:
    """Fig. 4 traffic: random beat-aligned addresses, 100 % injection."""
    rng = np.random.default_rng(seed)
    hi = geom.beats_total - burst

    def rows(n, is_w):
        return (
            np.full((num_masters, n), is_w, np.int32),
            np.full((num_masters, n), burst, np.int32),
            rng.integers(0, hi, (num_masters, n)).astype(np.int32),
        )

    if not full_duplex:
        iw = (rng.random((num_masters, num_txns)) >= read_fraction).astype(np.int32)
        b = np.full((num_masters, num_txns), burst, np.int32)
        a = rng.integers(0, hi, (num_masters, num_txns)).astype(np.int32)
        return Trace(iw, b, a)
    n_r = int(num_txns * read_fraction)
    n_w = num_txns - n_r
    n = max(n_r, n_w)
    iw_r, b_r, a_r = rows(n, 0)
    iw_w, b_w, a_w = rows(n, 1)
    b_r[:, n_r:] = 0
    b_w[:, n_w:] = 0
    return Trace(
        np.concatenate([iw_r, iw_w]), np.concatenate([b_r, b_w]), np.concatenate([a_r, a_w])
    )


def random_bursty(
    num_masters: int,
    num_txns: int,
    *,
    burst: int = 8,
    gap: int = 200,
    jitter: int = 8,
    read_fraction: float = 0.5,
    seed: int = 0,
    geom: MemoryGeometry = MemoryGeometry(),
) -> Trace:
    """Frame-cadence traffic: random addresses, transaction *k* offered at
    cycle ``k * gap`` (+ up to ``jitter``): cameras/radars on a cadence."""
    rng = np.random.default_rng(seed)
    hi = geom.beats_total - burst
    iw = (rng.random((num_masters, num_txns)) >= read_fraction).astype(np.int32)
    b = rng.integers(1, burst + 1, (num_masters, num_txns)).astype(np.int32)
    a = rng.integers(0, hi, (num_masters, num_txns)).astype(np.int32)
    jit = rng.integers(0, max(jitter, 1), (num_masters, num_txns))
    start = (np.arange(num_txns)[None, :] * gap + jit).astype(np.int32)
    return Trace(iw, b, a, start=start)


def bulk_linear(
    num_masters: int,
    payload_bytes: int,
    *,
    burst: int = 16,
    is_write: bool = False,
    outstanding_region: bool = True,
    geom: MemoryGeometry = MemoryGeometry(),
) -> Trace:
    """Fig. 5 traffic: every master streams one linear payload from its own
    non-overlapping region (isolation requirement)."""
    beats = payload_bytes // BEAT
    n = int(np.ceil(beats / burst))
    region = geom.beats_total // max(num_masters, 1)
    rows_b, rows_a, rows_w = [], [], []
    for m in range(num_masters):
        rows_a.append(m * region + np.arange(n) * burst)
        rows_b.append(np.full(n, burst))
        rows_w.append(np.full(n, int(is_write)))
    return Trace(pad_rows(rows_w), pad_rows(rows_b), pad_rows(rows_a))


# ---------------------------------------------------------------------------
# ML / ADAS traces (Fig. 6/7)
# ---------------------------------------------------------------------------


def ssd_net_trace(
    master: int, *, region_beats: int, seed: int = 0, max_txns: int = 4000
) -> Tuple[np.ndarray, ...]:
    """Single-shot-detection-style trace: per-layer feature maps 4 KB-260 KB,
    strided row re-reads (a portion of a line, then jump to the next line),
    weights read linearly, outputs written back; bursts of 4/8."""
    rng = np.random.default_rng(seed + master)
    iw, b, a = [], [], []
    base = master * region_beats
    # plausible SSD300 layer pyramid (feature bytes halve, channels grow)
    layer_kb = [260, 190, 128, 96, 64, 32, 16, 8, 4]
    for li, kb in enumerate(layer_kb):
        feat_beats = kb * 1024 // BEAT
        line = max(16, feat_beats // 38)  # ~38 rows per map
        burst = 4 if li % 2 == 0 else 8
        # read features: part of a line, jump to the next line
        for row in range(0, 38):
            off = (row * line) % max(region_beats - 64, 1)
            frac = rng.integers(line // 2, line + 1)
            for chunk in range(0, int(frac), burst):
                iw.append(0)
                b.append(burst)
                a.append(base + (off + chunk) % (region_beats - 16))
        # weights: linear read, burst 8
        w_beats = min(feat_beats // 2, 2048)
        for chunk in range(0, w_beats, 8):
            iw.append(0)
            b.append(8)
            a.append(base + (region_beats // 2 + chunk) % (region_beats - 16))
        # write activations out, burst 8
        for chunk in range(0, feat_beats // 2, 8):
            iw.append(1)
            b.append(8)
            a.append(base + (region_beats // 3 + chunk) % (region_beats - 16))
        if len(iw) > max_txns:
            break
    return np.array(iw[:max_txns]), np.array(b[:max_txns]), np.array(a[:max_txns])


def roi_image_trace(
    master: int, *, region_beats: int, seed: int = 0, max_txns: int = 4000
) -> Tuple[np.ndarray, ...]:
    """1080p YUV422 ROI trace: continuous line-after-line access across the
    full ROI (2 MB clip), burst 16, read-in then write-out."""
    line_beats = 1920 * 2 // BEAT  # 120 beats per line
    rows = min(1080, (region_beats // line_beats) - 1)
    iw, b, a = [], [], []
    base = master * region_beats
    for r in range(rows):
        off = r * line_beats
        for chunk in range(0, line_beats, 16):
            iw.append(0)
            b.append(16)
            a.append(base + off + chunk)
        if len(iw) > max_txns:
            break
    # write a processed half-resolution copy
    for r in range(0, rows, 2):
        off = region_beats // 2 + r * line_beats // 2
        for chunk in range(0, line_beats // 2, 16):
            iw.append(1)
            b.append(16)
            a.append(base + off + chunk)
        if len(iw) > max_txns:
            break
    return np.array(iw[:max_txns]), np.array(b[:max_txns]), np.array(a[:max_txns])


def adas_mixed_trace(
    num_masters: int = 16,
    *,
    max_txns: int = 3000,
    geom: MemoryGeometry = MemoryGeometry(),
    seed: int = 0,
) -> Trace:
    """Fig. 6/7 workload: masters 0-7 run the SSD detection net, masters 8-15
    stream camera ROIs; each master owns a disjoint region."""
    region = geom.beats_total // num_masters
    rows = []
    for m in range(num_masters):
        gen = ssd_net_trace if m < num_masters // 2 else roi_image_trace
        rows.append(gen(m, region_beats=region, seed=seed, max_txns=max_txns))
    n = max(len(r[0]) for r in rows)
    return Trace(*(pad_rows([r[i] for r in rows], n) for i in range(3)))
