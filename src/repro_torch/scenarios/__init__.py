"""Declarative ADAS scenario engine (paper §II-C, Figs. 6–7), the port's copy.

A :class:`~repro_torch.scenarios.spec.Scenario` composes per-master traffic
sources (camera frame DMA, Radar chirps, Lidar scatter, AI-accelerator tiles,
CPU scatter, or recorded LLM-serving streams) with QoS classes, memory-region
placement, and injection rates.
Every workload goes through one interface: ``TrafficSource.emit →
Scenario.compile() → CompiledScenario.simulate`` (or ``.simulate_batch`` for a
parameter grid as lanes of one batch); ``scenarios.sweep.run_sweep`` does the
same for scenario × parameter grids.  Runs go to the CUDA device unless the
caller passes ``device="cpu"``.  ``serving`` turns a recorded serving run
into fabric traffic (the co-sim); ``fuzz`` samples random specs and judges
them with the property oracles of ``properties``.
"""

from repro_torch.scenarios.fuzz import (
    FuzzCase,
    FuzzConfig,
    FuzzOutcome,
    case_from_json,
    case_to_json,
    evaluate_cases,
    load_reproducer,
    replay_case,
    run_fuzz,
    sample_case,
    shrink_case,
)
from repro_torch.scenarios.generators import GENERATORS
from repro_torch.scenarios.library import (
    highway_pilot,
    parking_surround,
    preset_scenarios,
    qos_isolation,
    sensor_stress,
    slice_scaling,
    urban_perception,
)
from repro_torch.scenarios.properties import (
    ORACLES,
    OracleBounds,
    PropertyContext,
    Violation,
    check_properties,
)
from repro_torch.scenarios.serving import ServingSource, serving_scenario
from repro_torch.scenarios.spec import (
    QOS_CLASSES,
    QOS_PRIORITY,
    CompiledScenario,
    MasterSpec,
    Scenario,
    SyntheticSource,
    TrafficSource,
    compile_scenario,
)
from repro_torch.scenarios.sweep import (
    DEPRECATED_METRIC_KEYS,
    MetricAliasDict,
    SweepPoint,
    SweepResult,
    run_sweep,
    summarize_compiled,
    summarize_point,
)
from repro_torch.serving.record import record_serving_run

__all__ = [
    "CompiledScenario",
    "MasterSpec",
    "Scenario",
    "SyntheticSource",
    "TrafficSource",
    "QOS_CLASSES",
    "QOS_PRIORITY",
    "compile_scenario",
    "GENERATORS",
    "DEPRECATED_METRIC_KEYS",
    "MetricAliasDict",
    "SweepPoint",
    "SweepResult",
    "run_sweep",
    "summarize_compiled",
    "summarize_point",
    "ServingSource",
    "serving_scenario",
    "record_serving_run",
    "highway_pilot",
    "parking_surround",
    "preset_scenarios",
    "qos_isolation",
    "sensor_stress",
    "slice_scaling",
    "urban_perception",
    "FuzzCase",
    "FuzzConfig",
    "FuzzOutcome",
    "case_from_json",
    "case_to_json",
    "evaluate_cases",
    "load_reproducer",
    "replay_case",
    "run_fuzz",
    "sample_case",
    "shrink_case",
    "ORACLES",
    "OracleBounds",
    "PropertyContext",
    "Violation",
    "check_properties",
]
