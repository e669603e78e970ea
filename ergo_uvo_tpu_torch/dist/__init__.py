"""Device meshes and distributed BA on ``torch.distributed`` (one process a rank).

Counterpart of ``ergo_uvo_tpu/dist/``, with the same names:

* ``mesh``: the world (NCCL on the card, gloo on the CPU), 1-D and 2-D
  ``DeviceMesh`` construction, sharding placements and per-rank rows;
* ``sharded_ba``: landmark-sharded Schur-complement BA, two ``all_reduce``
  calls an LM iteration;
* ``window_ba``: window-parallel BA on a 2-D ``('kf', 'lm')`` mesh with a
  ring exchange of the Schur cross-pose blocks;
* ``data_parallel``: independent mono streams over the ranks, and sharded
  frame ingestion;
* ``dryrun``: ``python -m ergo_uvo_tpu_torch.dist.dryrun`` spawns a world
  and runs sharded BA and per-process ingestion in it.
"""

from ergo_uvo_tpu_torch.dist.mesh import (  # noqa: F401
    init_world,
    landmark_sharding,
    local_rows,
    make_mesh,
    make_mesh_2d,
    replicated,
)
from ergo_uvo_tpu_torch.dist.window_ba import (  # noqa: F401
    make_window_sharded_ba_step,
    window_sharded_ba_solve,
)
from ergo_uvo_tpu_torch.dist.sharded_ba import (  # noqa: F401
    make_sharded_ba_run,
    make_sharded_ba_step,
    sharded_ba_solve,
)
from ergo_uvo_tpu_torch.dist.data_parallel import (  # noqa: F401
    run_mono_vo_batch,
    shard_frame_batches,
    shard_frame_batches_multiprocess,
)
