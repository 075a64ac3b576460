from quadruped_tpu_torch.distributed.mesh import (  # noqa: F401
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
)
from quadruped_tpu_torch.distributed.runtime import (  # noqa: F401
    initialize_from_env,
    global_mesh,
    host_local_to_global,
    global_to_host_local,
)
from quadruped_tpu_torch.distributed.solver_sp import (  # noqa: F401
    solve_cone_sp,
)
