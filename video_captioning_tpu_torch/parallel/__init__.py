"""Data, vocabulary and context parallelism over ``torch.distributed``
(counterpart of video_captioning_tpu/parallel/, under its names)."""

from .mesh import make_mesh  # noqa: F401
from .multihost import dryrun_multihost  # noqa: F401
from .sharding import (  # noqa: F401
    batch_sharding,
    batch_spec,
    param_shardings,
    param_specs,
    replicated,
    shard_batch,
)
