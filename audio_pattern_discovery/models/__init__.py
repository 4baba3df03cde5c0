from audio_pattern_discovery.models.autoencoder import (  # noqa: F401
    AutoEncoder,
    FeatureScaler,
    TrainState,
    encode_frames,
    train_autoencoder,
)
