"""Self-configuration and Learn2Reg evaluation (counterpart of
``convexadam_tpu/selfconfig``); so far the per-case evaluator."""
