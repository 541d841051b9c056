"""Device mesh, process group and batch/parameter placement helpers."""

from eve_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh, make_mesh, shard_batch, replicate,
    is_primary_process, local_data_slice)
