"""The benchmark's own machinery: cells from BENCHMARK.json, the run loop,
the profiler's reduction, the card's description and the result line."""
