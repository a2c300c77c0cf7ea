"""Parallelism on torch.distributed: tensor and data parallelism
(`sharding`), GPipe pipelines (`pipeline`), ring-attention prefill
(`ring`), the collective audit (`collectives_audit`), a launcher of
worlds on one host (`launch`) and multi-controller serving across hosts
(`multihost`, a submodule, as in the JAX package). The counterpart of
`llm_tpu/parallel/`."""

from llm_tpu_torch.parallel.sharding import (
    MeshConfig,
    make_mesh,
    shard_cache,
    shard_params,
    batched_forward_step,
)
from llm_tpu_torch.parallel.pipeline import (
    make_pipeline_mesh,
    pipeline_forward_batched,
    pipeline_step,
    shard_cache_pipeline,
    shard_params_pipeline,
)

__all__ = [
    "MeshConfig",
    "make_mesh",
    "shard_cache",
    "shard_params",
    "batched_forward_step",
    "make_pipeline_mesh",
    "pipeline_forward_batched",
    "pipeline_step",
    "shard_cache_pipeline",
    "shard_params_pipeline",
]
