"""Sharded training and evaluation over a world of gloo ranks (port of
``millieye_tpu/parallel``): the mesh and its layouts (``mesh.py``), the
collectives the models call (``collectives.py``), the rank launcher
(``world.py``) and the explicit per-shard twin of the step
(``shard_map_step.py``)."""
from millieye_torch.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated,
    param_sharding,
    shard_batch,
    shard_train_state,
    sharded_step,
)
