"""Audio preprocessing (host-side).

The port's copy of ``aniportrait_tpu/utils/audio_util.py`` (held to it by
``tests/test_torch_copies.py``).

Parity target: reference ``src/utils/audio_util.py`` — load audio at 16 kHz
(librosa) + Wav2Vec2FeatureExtractor zero-mean/unit-var normalisation;
``seq_len = ceil(samples / sr * fps)``.  librosa is not in this image, so
WAV decoding uses scipy + polyphase resampling (numerically equivalent
pipeline for 16 kHz mono features: wav2vec2-base's processor only
normalises — do_normalize=True, no padding).  Non-WAV containers
(mp3/m4a/mp4/ogg/...) are decoded through ffmpeg, matching librosa's
any-format capability.
"""

from __future__ import annotations

import math
import subprocess

import numpy as np


def _ffmpeg_decode(path: str, sampling_rate: int) -> np.ndarray:
    """Decode any container ffmpeg understands to f32 mono PCM."""
    import shutil

    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            f"cannot decode {path!r}: not a plain WAV and ffmpeg is not "
            "installed (non-WAV audio decode requires ffmpeg on PATH)"
        )
    proc = subprocess.run(
        [
            "ffmpeg", "-v", "error", "-i", path,
            "-f", "f32le", "-acodec", "pcm_f32le",
            "-ac", "1", "-ar", str(sampling_rate), "-",
        ],
        capture_output=True,
        check=True,
    )
    return np.frombuffer(proc.stdout, np.float32).copy()


def load_audio(path: str, sampling_rate: int = 16000) -> np.ndarray:
    """Load an audio file to float32 mono at ``sampling_rate``.

    WAV goes through scipy directly; anything else (or a WAV scipy cannot
    parse, e.g. float64 or exotic chunks) falls back to ffmpeg.
    """
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    try:
        sr, data = wavfile.read(path)
    except ValueError:
        return _ffmpeg_decode(path, sampling_rate)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim == 2:
        x = x.mean(axis=1)
    if sr != sampling_rate:
        g = math.gcd(sr, sampling_rate)
        x = resample_poly(x, sampling_rate // g, sr // g).astype(np.float32)
    return x


def normalize_audio(x: np.ndarray) -> np.ndarray:
    """Wav2Vec2FeatureExtractor zero-mean unit-variance normalisation."""
    return ((x - x.mean()) / np.sqrt(x.var() + 1e-7)).astype(np.float32)


def prepare_audio_feature(
    wav_file: str, fps: float = 30, sampling_rate: int = 16000, **_unused
) -> dict:
    """Reference audio_util.py:20-28 equivalent."""
    x = normalize_audio(load_audio(wav_file, sampling_rate))
    seq_len = math.ceil(len(x) / sampling_rate * fps)
    return {"audio_feature": x, "seq_len": seq_len}
