"""The audio models (port of ``aniportrait_tpu/audio``): the wav2vec2-base
encoder, Audio2Mesh (per-frame mesh offsets) and Audio2Pose (the
autoregressive head-pose decoder), float32, with the reference checkpoints'
module names."""
