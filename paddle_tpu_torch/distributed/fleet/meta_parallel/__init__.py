"""``fleet.meta_parallel`` of the port: the TP layers, the RNG tracker,
ZeRO (``sharding``) and the hybrid optimizer. The pipeline's classes are
importable and raise on use (ROADMAP A7)."""
from .mp_layers import (ColumnParallelLinear, RowParallelLinear,
                        VocabParallelEmbedding, ParallelCrossEntropy)
from .pp_layers import (LayerDesc, SharedLayerDesc, PipelineLayer,
                        PipelineParallel)
from .hybrid_optimizer import HybridParallelOptimizer
from .sharding import (group_sharded_parallel, save_group_sharded_model,
                       GroupShardedStage2, GroupShardedStage3,
                       GroupShardedOptimizerStage2)
from .random import (RNGStatesTracker, get_rng_state_tracker,
                     model_parallel_random_seed)
