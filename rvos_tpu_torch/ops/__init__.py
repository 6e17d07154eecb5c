from .cuda_local import local_match, local_match_plain
from .cuda_matching import global_seg_map, global_seg_map_plain
from .entropy import shannon_entropy
from .kmeans import ClusterBanks, cluster_matching, cluster_objects
from .matching import (
    WRONG_LABEL_PADDING_DISTANCE,
    compact_reference_bank,
    compact_reference_bank_occupancy,
    foreground2background,
    global_matching_flat,
    global_matching_flat_segmented,
    local_matching_bank_stacked,
    proxy_matching,
    squash_distance,
)
from .proxies import AttentionHeads, attention_heads, proxy_reconstructed_embedding
from .resize import resize_hw, resize_nchw

__all__ = [
    "WRONG_LABEL_PADDING_DISTANCE",
    "AttentionHeads",
    "ClusterBanks",
    "attention_heads",
    "cluster_matching",
    "cluster_objects",
    "compact_reference_bank",
    "compact_reference_bank_occupancy",
    "foreground2background",
    "global_matching_flat",
    "global_matching_flat_segmented",
    "global_seg_map",
    "global_seg_map_plain",
    "local_match",
    "local_match_plain",
    "local_matching_bank_stacked",
    "proxy_matching",
    "proxy_reconstructed_embedding",
    "resize_hw",
    "resize_nchw",
    "shannon_entropy",
    "squash_distance",
]
