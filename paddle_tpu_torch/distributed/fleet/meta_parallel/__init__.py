"""``fleet.meta_parallel`` of the port: the TP layers, the RNG tracker,
ZeRO (``sharding``), the hybrid optimizer, and the pipeline: its layer
descriptions (``pp_layers``), the eager trainer with its 1F1B,
zero-bubble and GPipe schedules (``pipeline_parallel``) and the
explicit-rank SPMD schedule the stacked GPT runs (``spmd_pipeline``)."""
from .mp_layers import (ColumnParallelLinear, RowParallelLinear,
                        VocabParallelEmbedding, ParallelCrossEntropy)
from .pp_layers import LayerDesc, SharedLayerDesc, PipelineLayer
from .pipeline_parallel import (PipelineParallel, MicroBatchSplitError,
                                PipelineSpecMismatch)
from .hybrid_optimizer import HybridParallelOptimizer
from .sharding import (group_sharded_parallel, save_group_sharded_model,
                       GroupShardedStage2, GroupShardedStage3,
                       GroupShardedOptimizerStage2)
from .random import (RNGStatesTracker, get_rng_state_tracker,
                     model_parallel_random_seed)
