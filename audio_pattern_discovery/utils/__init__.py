from audio_pattern_discovery.utils.logging import get_logger, StageCounters  # noqa: F401
from audio_pattern_discovery.utils.timer import DeviceTimer  # noqa: F401
