"""Self-configuration and Learn2Reg evaluation (counterpart of
``convexadam_tpu/selfconfig``): the two-stage random search over convex and
Adam settings scored by rank aggregation (``engine.py``, ``paired.py``,
``settings.py``, ``rank.py``, ``checkpoint.py``), test-set inference with
the chosen settings (``infer.py``), and the Learn2Reg task driver and its
per-case evaluator (``l2r.py``).
``protocol.py`` runs the whole protocol over both stages, with its fixture
and log table.
"""

from convexadam_torch.selfconfig.settings import (  # noqa: F401
    Stage1PairedSetting,
    Stage1Setting,
    Stage2Setting,
    decode_adam_variant,
    stage1_paired_settings,
    stage1_settings,
    stage2_settings,
)
from convexadam_torch.selfconfig.engine import (  # noqa: F401
    run_stage1_sweep,
    run_stage2_sweep,
)
