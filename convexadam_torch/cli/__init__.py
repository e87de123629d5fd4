"""Command-line entry points of the port (counterparts of
``convexadam_tpu/cli``); each takes ``--device`` (default ``cuda``)."""
