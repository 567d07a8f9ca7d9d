"""Multi-process rendering and training over torch.distributed
(rt_tpu/parallel): init_distributed, the (tile, sample) mesh over the
ranks, and the sharded renderer."""

from rt_tpu_torch.parallel.mesh import make_mesh, default_mesh  # noqa: F401
from rt_tpu_torch.parallel.sharded import (  # noqa: F401
    render_block, render_sharded)
