"""Multi-GPU execution: a mesh of ranks over ``torch.distributed``.

``make_mesh`` makes a rank's mesh inside a process group;
``launch.RankPool`` / ``launch.run_ranks`` start the ranks (an elastic
pool lets them outlive a lost peer). ``reform_mesh`` re-forms a mesh over
the survivors of a loss; ``resilience.health.resilient_make_mesh`` makes
one behind the device probe, degrading to a CPU mesh when the card is
wedged.
"""

from pipelinedp_tpu_torch.parallel.sharded import (Mesh, MeshDeparted,
                                                   MeshTopology, make_mesh,
                                                   reform_mesh,
                                                   sharded_fused_aggregate,
                                                   topology_of)

__all__ = ["Mesh", "MeshDeparted", "MeshTopology", "make_mesh",
           "reform_mesh", "sharded_fused_aggregate", "topology_of"]
