"""The dataplane: collectives over W ranks on one device, the
sequence-parallel attentions over them (ring and Ulysses), the
tensor-parallel pieces (shard views, rank GEMMs, the tp all-reduce, the
vocabulary-parallel embedding and logits), the data-parallel bucketed
gradient all-reduce, the GPipe pipeline schedule, and the multi-slice
tier (hybrid meshes, the hierarchical and multi-axis allreduces, the
process group that spans slices)."""

from .bucketing import (Bucket, BucketPlan, bucketed_allreduce,
                        make_bucket_plan, make_ddp_train_step,
                        plan_from_buckets)
from .collectives import RankCollectives, multi_axis_ring_allreduce
from .mesh import (RankGroup, RankMesh, communicator_from_mesh, cpu_mesh,
                   make_group, make_mesh, mesh_from_communicator)
from .multislice import (HybridMesh, distributed_init,
                         hierarchical_allreduce,
                         hierarchical_allreduce_sharded, hybrid_mesh,
                         slice_count)
from .pipeline import pipeline_apply, pipeline_sharded
from .ring_attention import (block_update, ring_attention,
                             ring_attention_fwd, ring_attention_ref,
                             ring_attention_sharded,
                             ring_rounding_magnitudes)
from .tensor_parallel import (rank_matmul, shard_view, tp_allreduce,
                              vocab_parallel_embed, vocab_parallel_logits)
from .tree import Tree2DCollectives
from .ulysses import (heads_to_seq, seq_to_heads, ulysses_attention,
                      ulysses_attention_sharded)

__all__ = ["Bucket", "BucketPlan", "HybridMesh", "RankCollectives",
           "RankGroup", "RankMesh", "Tree2DCollectives", "block_update",
           "bucketed_allreduce", "communicator_from_mesh", "cpu_mesh",
           "distributed_init", "heads_to_seq",
           "hierarchical_allreduce", "hierarchical_allreduce_sharded",
           "hybrid_mesh", "make_bucket_plan", "make_ddp_train_step",
           "make_group", "make_mesh", "mesh_from_communicator",
           "multi_axis_ring_allreduce", "pipeline_apply",
           "pipeline_sharded",
           "plan_from_buckets", "rank_matmul",
           "ring_attention",
           "ring_attention_fwd", "ring_attention_ref",
           "ring_attention_sharded", "ring_rounding_magnitudes",
           "seq_to_heads", "shard_view", "slice_count", "tp_allreduce",
           "ulysses_attention", "ulysses_attention_sharded",
           "vocab_parallel_embed", "vocab_parallel_logits"]
