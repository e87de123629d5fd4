"""Work spread over several ranks: rank grids, batch registration over
pairs (:mod:`convexadam_torch.parallel.batch`), one volume split along H
with explicit halo exchanges (:mod:`convexadam_torch.parallel.spatial`)
and the process group (:mod:`convexadam_torch.parallel.distributed`)."""

from convexadam_torch.parallel.batch import (  # noqa: F401
    Mesh,
    make_mesh,
    make_sweep_mesh,
    register_pairs_batched,
    register_pairs_sharded,
)
from convexadam_torch.parallel.distributed import init_distributed, is_multiprocess  # noqa: F401
