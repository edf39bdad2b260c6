"""Per-layer metric readers, one module per metric, found by the metric's
name: ``read(run)`` returns the number, or None where the run has nothing
for it to read (the harness then leaves the metric out)."""
