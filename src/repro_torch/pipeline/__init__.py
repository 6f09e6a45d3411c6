"""Pipeline parallelism as a tensor-relational rewrite.

Three layers, mirroring the core stack:

  * partition — cut the EinGraph into a chain of stage subgraphs
    (min cut-edge bytes under a compute-balance cap);
  * plan — per-stage §8 DP through the canonical plan cache, stitched
    back into one full-graph plan (the bit-identity baseline);
  * schedule + exec — the static GPipe cell schedule with ppermute
    handoffs over the ``pp`` mesh axis, run by every rank of a mesh of
    ``torch.distributed`` ranks that carries the combined (pp, intra)
    axes.
"""
from repro_torch.pipeline.partition import (PipelineSpec, Stage, batch_splittable,
                                            cut_tensors, partition_stages,
                                            scale_graph_batch)
from repro_torch.pipeline.plan import plan_pipeline, stage_priced_cost
from repro_torch.pipeline.schedule import PipelineSchedule, build_pipeline_schedule

__all__ = [
    "PipelineSpec", "Stage", "batch_splittable", "cut_tensors",
    "partition_stages", "scale_graph_batch", "plan_pipeline",
    "stage_priced_cost", "PipelineSchedule", "build_pipeline_schedule",
    "make_pipeline_runner",
]


def make_pipeline_runner(g, psched, mesh):
    from repro_torch.pipeline.exec import make_pipeline_runner as _mk
    return _mk(g, psched, mesh)
