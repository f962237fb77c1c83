from noise_flow_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
