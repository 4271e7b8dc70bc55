"""Port of ``repro.core``: deltas, magnitude selection, adapter trees."""
