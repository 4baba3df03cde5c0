from audio_pattern_discovery.parallel.mesh import (  # noqa: F401
    ae_param_sharding,
    data_sharding,
    make_mesh,
    replicated,
)
from audio_pattern_discovery.parallel.pair_scheduler import (  # noqa: F401
    all_pairs_distances,
    enumerate_pair_blocks,
)
from audio_pattern_discovery.parallel.wavefront import (  # noqa: F401
    dtw_wavefront_sharded,
    shard_b_for_wavefront,
)
