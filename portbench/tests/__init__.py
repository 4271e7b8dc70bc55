"""CPU tests of the benchmark harness (the chip runs the benchmark itself)."""
