"""The harness: manifest, traffic, weights, drivers, trace reading and the yardstick."""
