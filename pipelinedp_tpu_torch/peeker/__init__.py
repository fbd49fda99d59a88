"""Interactive utility-analysis helpers — the 'peeker' workflow
(``DataPeeker`` sketching and sampling, ``PeekerEngine`` approximate DP
aggregation over sketches). A port of ``pipelinedp_tpu/peeker``."""

from pipelinedp_tpu_torch.peeker.data_peeker import (DataPeeker,
                                                     SampleParams)
from pipelinedp_tpu_torch.peeker.peeker_engine import (PeekerEngine,
                                                       aggregate_sketch_true)

__all__ = ["DataPeeker", "PeekerEngine", "SampleParams",
           "aggregate_sketch_true"]
