"""CPU tests of the benchmark harness (no card needed)."""
