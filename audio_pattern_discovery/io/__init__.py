from audio_pattern_discovery.io.wavio import read_wav, write_wav  # noqa: F401
from audio_pattern_discovery.io.corpus import (  # noqa: F401
    Clip,
    load_corpus,
    pad_and_stack,
)
