"""Per-master ADAS traffic models (§II-C master mixes, Figs. 6–7), numpy copies.

Each generator gives the same rows as the reference package's generator of
the same name for the same arguments.

Each generator emits one master's transaction stream as four parallel 1-D
int32 arrays ``(is_write, burst, addr, start)`` — beat-granular addresses
confined to the master's region ``[lo, hi)`` and earliest-issue cycles that
encode the sensor's injection timing (camera vblank cadence, Radar chirp
bursts, Lidar rotation, rate-limited CPU scatter).

The models follow the master mixes catalogued for embedded ADAS platforms
(redundant cameras + Radar + Lidar contending with an AI accelerator and CPU
housekeeping): each is a caricature with the *access-pattern shape* the
memory subsystem cares about — linearity, stride, burst size, duty cycle —
not a functional sensor model.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

TraceRow = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _finalize(iw, b, a, s, lo, hi, max_txns) -> TraceRow:
    iw = np.asarray(iw, np.int32)[:max_txns]
    b = np.asarray(b, np.int32)[:max_txns]
    a = np.asarray(a, np.int64)[:max_txns]
    s = np.asarray(s, np.int64)[:max_txns]
    # clamp every burst inside the region (defensive: generators already do)
    a = np.clip(a, lo, np.maximum(hi - b, lo))
    return iw, b, a.astype(np.int32), np.clip(s, 0, 2**30).astype(np.int32)


def _rate_starts(bursts, rate: float, offset: int = 0) -> np.ndarray:
    """Earliest-issue times that cap a stream at ``rate`` beats/cycle."""
    bursts = np.asarray(bursts, np.int64)
    cum = np.concatenate([[0], np.cumsum(bursts)[:-1]])
    r = min(max(float(rate), 1e-6), 1.0)
    return offset + (cum / r).astype(np.int64)


def camera_frame_dma(
    lo: int, hi: int, *, txns: int, rate: float, seed: int, params: Dict
) -> TraceRow:
    """Camera frame DMA with vblank periodicity: a sensor writes full lines
    (burst 16) back-to-back for the active part of each frame, then idles
    until the next vblank; frames alternate between two buffers."""
    line_beats = int(params.get("line_beats", 120))  # 1080p YUV422 line
    lines = int(params.get("frame_lines", 16))  # lines modelled/frame
    readback = bool(params.get("readback", False))  # ISP reads prev frame
    chunks = max(line_beats // 16, 1)
    frame_beats = lines * chunks * 16
    # readback beats occupy the same DMA port clock as the writes, so they
    # count toward the frame's active time (and the vblank period below)
    readback_beats = ((lines + 1) // 2) * 16 if readback else 0
    # vblank period: active beats / rate (duty cycle = rate)
    period = int(np.ceil((frame_beats + readback_beats) / min(max(rate, 1e-6), 1.0)))
    # sensors free-run: each camera's vblank has its own phase
    phase = int(np.random.default_rng(seed).integers(0, max(period // 2, 1)))
    buf_beats = min((hi - lo) // 2, frame_beats + 64)
    iw, b, a, s = [], [], [], []
    f = 0
    while len(iw) < txns:
        base = lo + (f % 2) * buf_beats
        t0 = phase + f * period
        beat = 0
        for ln in range(lines):
            for c in range(chunks):
                iw.append(1)
                b.append(16)
                a.append(base + (ln * line_beats + c * 16) % max(buf_beats - 16, 1))
                s.append(t0 + beat)  # 1 beat/cycle DMA pace
                beat += 16
            if readback and ln % 2 == 0:
                other = lo + ((f + 1) % 2) * buf_beats
                iw.append(0)
                b.append(16)
                a.append(other + (ln * line_beats) % max(buf_beats - 16, 1))
                s.append(t0 + beat)
                beat += 16  # readback occupies the DMA clock too
        f += 1
    return _finalize(iw, b, a, s, lo, hi, txns)


def radar_chirp_bursts(
    lo: int, hi: int, *, txns: int, rate: float, seed: int, params: Dict
) -> TraceRow:
    """Radar chirp cadence: every PRI a tight burst of ADC sample writes
    (burst 8) lands in a ring buffer, followed by one FFT-windowed readback
    of the previous chirp — short, periodic, latency-critical."""
    chirp_beats = int(params.get("chirp_beats", 128))
    readback = bool(params.get("readback", True))
    period = int(np.ceil(chirp_beats * (2 if readback else 1) / min(max(rate, 1e-6), 1.0)))
    ring = max(hi - lo - chirp_beats, chirp_beats)
    # independent Radars are not PRI-synchronized: per-sensor chirp phase
    phase = int(np.random.default_rng(seed).integers(0, max(period // 2, 1)))
    iw, b, a, s = [], [], [], []
    c = 0
    while len(iw) < txns:
        t0 = phase + c * period
        base = lo + (c * chirp_beats) % ring
        for j in range(chirp_beats // 8):
            iw.append(1)
            b.append(8)
            a.append(base + j * 8)
            s.append(t0 + j * 8)
        if readback:
            prev = lo + ((c - 1) * chirp_beats) % ring if c else base
            for j in range(chirp_beats // 8):
                iw.append(0)
                b.append(8)
                a.append(prev + j * 8)
                s.append(t0 + chirp_beats + j * 8)
        c += 1
    return _finalize(iw, b, a, s, lo, hi, txns)


def lidar_scatter(
    lo: int, hi: int, *, txns: int, rate: float, seed: int, params: Dict
) -> TraceRow:
    """Lidar point-cloud scatter: returns arrive continuously over a rotation
    and each point is binned into a voxel — short bursts (4) at effectively
    random region offsets, evenly paced in time."""
    burst = int(params.get("burst", 4))
    read_fraction = float(params.get("read_fraction", 0.2))  # tree lookups
    rng = np.random.default_rng(seed)
    iw = (rng.random(txns) < read_fraction).astype(np.int32) ^ 1
    b = np.full(txns, burst, np.int32)
    a = lo + rng.integers(0, max(hi - lo - burst, 1), txns)
    s = _rate_starts(b, rate)
    return _finalize(iw, b, a, s, lo, hi, txns)


def npu_tiled(
    lo: int, hi: int, *, txns: int, rate: float, seed: int, params: Dict
) -> TraceRow:
    """AI-accelerator tiled reads: walk a row-major feature map tile by tile
    (strided row reads, burst 8), stream weights linearly, write the output
    tile back — the bank-conflict-prone pattern of Fig. 6's detection net."""
    map_w = int(params.get("map_width_beats", 512))  # feature-map row
    tile_h = int(params.get("tile", 8))
    tile_w_beats = int(params.get("tile_width_beats", 32))
    region = hi - lo
    w_base = lo + region // 2  # weights live above
    o_base = lo + 3 * region // 4  # outputs above that
    in_span = max(region // 2 - 16, 1)  # wrap spans, kept
    wo_span = max(region // 4 - 16, 1)  # positive for tiny regions
    tiles_per_row = max(map_w // tile_w_beats, 1)
    # each NPU job starts at its own tile offset (different layer/stream)
    t = int(np.random.default_rng(seed).integers(0, 4 * tiles_per_row))
    iw, b, a = [], [], []
    while len(iw) < txns:
        tr, tc = t // tiles_per_row, t % tiles_per_row
        for r in range(tile_h):  # input tile rows
            off = ((tr * tile_h + r) * map_w + tc * tile_w_beats) % in_span
            for c in range(0, tile_w_beats, 8):
                iw.append(0)
                b.append(8)
                a.append(lo + off + c)
        for c in range(0, tile_w_beats, 8):  # weights, linear
            iw.append(0)
            b.append(8)
            a.append(w_base + (t * tile_w_beats + c) % wo_span)
        for c in range(0, tile_w_beats, 8):  # output writeback
            iw.append(1)
            b.append(8)
            a.append(o_base + (t * tile_w_beats + c) % wo_span)
        t += 1
    s = _rate_starts(b, rate)  # pace the whole stream
    return _finalize(iw, b, a, s, lo, hi, txns)


def cpu_scatter(
    lo: int, hi: int, *, txns: int, rate: float, seed: int, params: Dict
) -> TraceRow:
    """CPU housekeeping: cache-line-sized (burst 1–2) random scatter with a
    read-mostly mix, rate-limited — the background noise floor every QoS
    analysis must tolerate."""
    read_fraction = float(params.get("read_fraction", 0.7))
    rng = np.random.default_rng(seed)
    iw = (rng.random(txns) >= read_fraction).astype(np.int32)
    b = rng.choice([1, 2], size=txns).astype(np.int32)
    a = lo + rng.integers(0, max(hi - lo - 2, 1), txns)
    s = _rate_starts(b, rate)
    return _finalize(iw, b, a, s, lo, hi, txns)


def uniform_scatter(
    lo: int, hi: int, *, txns: int, rate: float, seed: int, params: Dict
) -> TraceRow:
    """Neutral region-confined uniform traffic — the scale-sweep workload.

    Fully vectorized (O(txns) numpy, no per-event Python loop), so a
    100k-point grid's shared trace compiles in microseconds regardless of
    ``txns``.  ``burst`` and ``read_fraction`` are the only shape knobs
    the
    stream is paced to ``rate`` beats/cycle like every other generator."""
    burst = int(params.get("burst", 4))
    read_fraction = float(params.get("read_fraction", 0.5))
    rng = np.random.default_rng(seed)
    iw = (rng.random(txns) >= read_fraction).astype(np.int32)
    b = np.full(txns, burst, np.int32)
    a = lo + rng.integers(0, max(hi - lo - burst, 1), txns)
    s = _rate_starts(b, rate)
    return _finalize(iw, b, a, s, lo, hi, txns)


GENERATORS = {
    "camera": camera_frame_dma,
    "radar": radar_chirp_bursts,
    "lidar": lidar_scatter,
    "npu": npu_tiled,
    "cpu": cpu_scatter,
    "uniform": uniform_scatter,
}
