from neural_imaging_tpu_torch.parallel.mesh import (Mesh, make_mesh, replicate,  # noqa: F401
                                                    shard_batch)
from neural_imaging_tpu_torch.parallel import multihost, train  # noqa: F401
