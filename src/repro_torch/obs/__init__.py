"""Port of ``repro.obs`` (the shared monotonic clock only)."""
