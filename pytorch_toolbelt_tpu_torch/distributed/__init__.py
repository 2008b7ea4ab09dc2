from .comm import (
    DistributedGuard,
    all_gather,
    broadcast_from_master,
    is_dist_avail_and_initialized,
    master_node_only,
    reduce_dict_sum,
    split_across_nodes,
)
from .mesh import get_rank, get_world_size, is_main_process, master_print, scale_learning_rate_for_ddp
from .tiled import clear_sharded_cache, read_sharded_window, tiled_apply_sharded

__all__ = [
    "DistributedGuard",
    "all_gather",
    "broadcast_from_master",
    "is_dist_avail_and_initialized",
    "master_node_only",
    "reduce_dict_sum",
    "split_across_nodes",
    "clear_sharded_cache",
    "read_sharded_window",
    "tiled_apply_sharded",
    "get_rank",
    "get_world_size",
    "is_main_process",
    "master_print",
    "scale_learning_rate_for_ddp",
]
