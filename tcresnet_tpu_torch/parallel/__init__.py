from tcresnet_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedGenerator,
    batch_rows,
    launch,
    make_mesh,
)

__all__ = ["Mesh", "ShardedGenerator", "batch_rows", "launch", "make_mesh"]
