from audio_pattern_discovery.ops.spectrogram import (  # noqa: F401
    batched_spectrogram,
    spectrogram_from_config,
    frame_energy,
    mel_filterbank,
    dct_ortho,
)
from audio_pattern_discovery.ops.dtw import (  # noqa: F401
    dtw_batch,
    dtw_batch_with_dirs,
    dtw_pair,
    pairwise_cost,
)
from audio_pattern_discovery.ops.backtrace import walk_path, paths_from_dirs  # noqa: F401
from audio_pattern_discovery.ops.segmentation import segment_corpus  # noqa: F401
from audio_pattern_discovery.ops.spectrogram import spectrogram_corpus  # noqa: F401
from audio_pattern_discovery.ops.dtw_long import dtw_long_batch  # noqa: F401
