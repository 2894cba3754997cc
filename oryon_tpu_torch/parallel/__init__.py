from oryon_tpu_torch.parallel.mesh import (Mesh, init_distributed, make_mesh,
                                           replicate, serving_mesh, shard_batch)
