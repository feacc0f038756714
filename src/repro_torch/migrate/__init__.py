"""repro_torch.migrate — online migration engine.

Turns an accepted adaptation into a :class:`MigrationSession`: the
``MigrationPlan`` is chunked (hottest workload features first, bounded by a
per-step bytes budget) and applied incrementally while queries keep being
served against the consistent hybrid layout in between. See
``docs/api.md`` ("Migration sessions") for the lifecycle.
"""
from repro_torch.core.migration import (MigrationChunk, MigrationPlan, chunk_plan,
                                  feature_heat, migration_seconds)
from repro_torch.migrate.session import MigrationSession

__all__ = [
    "MigrationChunk",
    "MigrationPlan",
    "MigrationSession",
    "chunk_plan",
    "feature_heat",
    "migration_seconds",
]
