"""Preset ADAS scenarios — the master mixes the paper's SoC must serve (the
port's copy: each preset is the reference's, master for master).

Each preset returns a fresh :class:`Scenario`; tweak via the ``txns``
argument (transactions per master, the knob that trades fidelity for sim
time).  Mixes follow the embedded-ADAS platform surveys: redundant cameras +
Radar + Lidar feeding an AI accelerator, with CPU housekeeping underneath.
"""
from __future__ import annotations

from repro_torch.core.address import MemoryGeometry, master_home_slices
from repro_torch.scenarios.spec import MasterSpec, Scenario


def urban_perception(txns: int = 256, geom: MemoryGeometry = MemoryGeometry()
                     ) -> Scenario:
    """Front + surround cameras feeding two detection NPUs; city speeds."""
    masters = (
        [MasterSpec("camera", qos="safety", rate=0.8, txns=txns, seed=s)
         for s in range(2)] +
        [MasterSpec("camera", qos="realtime", rate=0.6, txns=txns, seed=10 + s)
         for s in range(4)] +
        [MasterSpec("npu", qos="realtime", rate=1.0, txns=txns, seed=20 + s)
         for s in range(2)] +
        [MasterSpec("cpu", qos="besteffort", rate=0.3, txns=txns, seed=30)]
    )
    return Scenario("urban_perception", masters, geom,
                    "6 cameras + 2 NPUs + CPU housekeeping")


def highway_pilot(txns: int = 256, geom: MemoryGeometry = MemoryGeometry()
                  ) -> Scenario:
    """Long-range Radar + Lidar + front camera, fusion NPU, heavier CPU."""
    masters = (
        [MasterSpec("radar", qos="safety", rate=0.7, txns=txns, seed=s)
         for s in range(3)] +
        [MasterSpec("lidar", qos="safety", rate=0.5, txns=txns, seed=10)] +
        [MasterSpec("camera", qos="realtime", rate=0.8, txns=txns, seed=20)] +
        [MasterSpec("npu", qos="realtime", rate=1.0, txns=txns, seed=30)] +
        [MasterSpec("cpu", qos="besteffort", rate=0.4, txns=txns, seed=40 + s)
         for s in range(2)]
    )
    return Scenario("highway_pilot", masters, geom,
                    "3 Radar + Lidar + camera + fusion NPU + 2 CPUs")


def parking_surround(txns: int = 256, geom: MemoryGeometry = MemoryGeometry()
                     ) -> Scenario:
    """Low-speed surround view: many cameras, light compute."""
    masters = (
        [MasterSpec("camera", qos="realtime", rate=0.5, txns=txns, seed=s)
         for s in range(6)] +
        [MasterSpec("npu", qos="realtime", rate=0.6, txns=txns, seed=10)] +
        [MasterSpec("cpu", qos="besteffort", rate=0.2, txns=txns, seed=20)]
    )
    return Scenario("parking_surround", masters, geom,
                    "6-camera surround stitch + light NPU")


def sensor_stress(txns: int = 256, geom: MemoryGeometry = MemoryGeometry()
                  ) -> Scenario:
    """Worst-case contention: every model at full injection on all 16 ports."""
    models = ["camera", "radar", "lidar", "npu"] * 3 + ["cpu"] * 4
    qos = (["safety"] * 4 + ["realtime"] * 8 + ["besteffort"] * 4)
    masters = [MasterSpec(m, qos=q, rate=1.0, txns=txns, seed=i)
               for i, (m, q) in enumerate(zip(models, qos))]
    return Scenario("sensor_stress", masters, geom,
                    "all 16 ports saturated, every traffic model")


def qos_isolation(txns: int = 256, geom: MemoryGeometry = MemoryGeometry(),
                  aggressors: int = 13) -> Scenario:
    """QoS isolation showcase: a deadline-carrying safety pair (braking-path
    Radar) and one realtime NPU against a wall of full-rate best-effort
    aggressors filling the remaining ports.  With the priority arbiter +
    regulator the safety class's p99 latency stays pinned near its
    alone-latency even when banks are slow enough to congest; with a
    QoS-blind arbiter the aggressors drag it out
    (the reference's ``benchmarks/qos_isolation.py``)."""
    n_npu = aggressors // 3
    n_lidar = aggressors // 3
    n_cpu = aggressors - n_npu - n_lidar
    masters = (
        [MasterSpec("radar", qos="safety", rate=0.9, txns=txns, seed=s,
                    deadline=4096) for s in range(2)] +
        [MasterSpec("npu", qos="realtime", rate=0.9, txns=txns, seed=5)] +
        [MasterSpec("npu", qos="besteffort", rate=1.0, txns=txns, seed=20 + s)
         for s in range(n_npu)] +
        [MasterSpec("lidar", qos="besteffort", rate=1.0, txns=txns,
                    seed=40 + s) for s in range(n_lidar)] +
        [MasterSpec("cpu", qos="besteffort", rate=1.0, txns=txns, seed=60 + s)
         for s in range(n_cpu)]
    )
    return Scenario("qos_isolation", masters, geom,
                    f"2 safety Radar + 1 realtime NPU vs {aggressors} "
                    "saturating best-effort aggressors")


def slice_scaling(num_slices: int = 2, txns: int = 256, *,
                  remote: bool = False) -> Scenario:
    """Multi-slice scaling probe (§IV scalability/modularity): 16 masters
    tiled across ``num_slices`` memory instances, each slice's port group a
    miniature ADAS pipeline — one braking-path Radar (safety, deadline) plus
    saturating NPU streamers — under region-affine slicing so placement
    controls locality.

    ``remote=False`` pins every master's working set to its *home* slice
    (slice-local placement, zero router crossings); ``remote=True`` rotates
    each group's placement one slice over, so every beat pays inter-slice
    hops and ingress credits — the configuration that exposes the router
    penalty in the reference's ``benchmarks/slice_scaling.py``.
    """
    geom = MemoryGeometry(num_slices=num_slices, slice_policy="region")
    X = geom.num_masters
    home = master_home_slices(X, geom)
    masters = []
    prev = -1
    for m in range(X):
        target = int((home[m] + 1) % num_slices) if remote else int(home[m])
        first_of_group = home[m] != prev
        prev = home[m]
        if first_of_group:  # one safety Radar fronts each slice's group
            masters.append(MasterSpec("radar", qos="safety", rate=0.9,
                                      txns=txns, seed=m, deadline=4096,
                                      slice_affinity=target))
        else:  # the rest stream NPU tiles at full rate
            masters.append(MasterSpec("npu", qos="realtime", rate=1.0,
                                      txns=txns, seed=100 + m,
                                      slice_affinity=target))
    name = f"slice_scaling_s{num_slices}_{'remote' if remote else 'local'}"
    return Scenario(name, masters, geom,
                    f"{num_slices}-slice fabric, per-slice Radar+NPU groups, "
                    f"{'remote' if remote else 'slice-local'} placement")


def preset_scenarios(txns: int = 256):
    """All presets sharing the default single-slice geometry, for sweeps and
    benchmarks (``slice_scaling`` is separate: its geometry varies with the
    slice count, so it cannot share a batched sweep's static envelope)."""
    return [urban_perception(txns), highway_pilot(txns),
            parking_surround(txns), sensor_stress(txns),
            qos_isolation(txns)]
