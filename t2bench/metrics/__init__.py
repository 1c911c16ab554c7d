"""Per-layer metric readers: ``<metric>.py`` holds ``read(run)``, which
returns the metric from a run's ``harness.Outcome``, or None where the run
holds nothing to read it from (the result line then leaves it out)."""
