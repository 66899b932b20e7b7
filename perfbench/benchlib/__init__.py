"""The benchmark's own library: cell loading, traffic generation,
statistics, the roofline yardstick and the profiler's reduction.  It
imports nothing of the program under test; the drivers do."""
