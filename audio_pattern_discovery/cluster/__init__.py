from audio_pattern_discovery.cluster.agglomerative import (  # noqa: F401
    cluster_distance_matrix,
    cut_linkage,
    linkage,
)
