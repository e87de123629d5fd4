"""The harness of the benchmark of ``convexadam_torch``."""
