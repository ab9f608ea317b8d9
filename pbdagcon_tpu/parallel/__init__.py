"""Multi-chip / multi-host execution: device mesh, sharded DP dispatch,
target manifest sharding, and the completed-target journal.

The reference is single-node pthreads over a shared-memory queue
(`BoundedBuffer.hpp` + reader/worker/writer in `src/cpp/main.cpp`,
SURVEY.md §2 C5–C6 — reconstructed; mount empty). The accelerator design
replaces that with data-parallel target sharding over a
`jax.sharding.Mesh` (the only parallel axis this workload has, SURVEY.md
§2 parallelism inventory): each host parses/builds its own shard of
targets, batched DP runs on its chips with the batch dimension sharded,
and global throughput metrics are combined with `psum`. Crash recovery
is a per-target journal — per-target statelessness makes reruns cheap,
so there is no checkpoint state beyond "which targets are done"
(SURVEY.md §5).
"""

from pbdagcon_tpu.parallel.mesh import (  # noqa: F401
    dp_scores_sharded,
    make_mesh,
    metrics_allreduce,
)
from pbdagcon_tpu.parallel.journal import TargetJournal  # noqa: F401
from pbdagcon_tpu.parallel.scheduler import (  # noqa: F401
    BucketScheduler,
    shard_for_host,
)
