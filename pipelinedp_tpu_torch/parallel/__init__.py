"""Multi-GPU execution: a mesh of ranks over ``torch.distributed``.

``make_mesh`` makes a rank's mesh inside a process group;
``launch.RankPool`` / ``launch.run_ranks`` start the ranks. The elastic
pieces of the JAX package's module (``reform_mesh``,
``resilient_make_mesh``) wait for ROADMAP step 5b.
"""

from pipelinedp_tpu_torch.parallel.sharded import (Mesh, MeshTopology,
                                                   make_mesh,
                                                   sharded_fused_aggregate,
                                                   topology_of)

__all__ = ["Mesh", "MeshTopology", "make_mesh", "sharded_fused_aggregate",
           "topology_of"]
