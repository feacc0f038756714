"""repro_torch.scenario — workload-drift scenarios and reactivity telemetry.

Describe workload *dynamics* (`DriftScenario`: diurnal shifts, flash
crowds, hot-set churn, mixed read/write phases) as deterministic seeded
schedules, replay them over a live ``KGService`` — synchronously or
through the ``repro_torch.stream`` admission loop — and measure how the layout
reacts: degradation depth, time-to-recover, and migration+replica bytes
per recovery, adaptive vs frozen. See ``benchmarks/bench_drift.py`` for
the experiment harness and ``docs/api.md`` for a tour.
"""
from repro_torch.scenario.schedule import (Phase, Window, DriftScenario, diurnal,
                                     flash_crowd, hot_set_churn,
                                     mixed_read_write, hot_feature_writer)
from repro_torch.scenario.driver import (WindowRecord, Recovery, ReactivityReport,
                                   reactivity, run_scenario, stream_schedule)

__all__ = [
    "Phase", "Window", "DriftScenario", "diurnal", "flash_crowd",
    "hot_set_churn", "mixed_read_write", "hot_feature_writer",
    "WindowRecord", "Recovery", "ReactivityReport", "reactivity",
    "run_scenario", "stream_schedule",
]
