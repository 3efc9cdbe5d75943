"""The benchmark's general machinery. Nothing here names a configuration, a
traffic mix or a per-layer metric: `spec` finds each by the name that
BENCHMARK.json gives it."""
