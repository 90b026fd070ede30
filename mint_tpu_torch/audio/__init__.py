"""The port's audio DSP frontend (counterpart of ``mint_tpu/audio``).

Re-implements the feature extraction behavior of the reference's librosa
calls (reference ``tools/preprocessing.py:77-118``): onset strength
envelope, 20 MFCCs, 12-dim CENS chroma, onset peak one-hot and beat one-hot
at SR 30720 Hz / hop 512 (60 feature frames per second), concatenated into a
35-dim per-frame feature.

The FFT / filterbank / DCT / CQT work runs in torch on the device the
caller names (the card by default); sequential host logic (peak picking,
the dynamic-programming beat tracker, the tuning histogram, CENS) stays
NumPy on the host.
"""

from mint_tpu_torch.audio.frontend import (  # noqa: F401
    AudioFeatureExtractor,
    FPS,
    HOP_LENGTH,
    SR,
    extract_audio_features,
    tempo_from_name,
)
