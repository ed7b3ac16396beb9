"""Data-parallel training over `torch.distributed`: the world (`make_mesh`),
replicated parameters, averaged gradients and the gathers of sharded eval.
The data-parallel steps are the pipelines' `make_sharded_train_step`."""

from neurad_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    make_mesh,
    shard_batch,
)
