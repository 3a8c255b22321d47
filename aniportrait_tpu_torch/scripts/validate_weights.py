"""Check a checkpoint zoo against the port's models (port of ``scripts/validate_weights.py``).

    python -m aniportrait_tpu_torch.scripts.validate_weights --config configs/prompts/animation.yaml \
        [--audio-config configs/prompts/animation_audio.yaml] [--film film_net_fp16.pt]

Every file the prompt config names (the reference's weight contract) is
read through the port's loader (``weights/load.py``: the SD-1.5 UNet folder
overlaid by ``reference_unet.pth`` for the ReferenceNet, and by
``motion_module.pth`` then ``denoising_unet.pth`` for the denoising UNet;
the VAE and image-encoder folders; ``pose_guider.pth``), and its keys and
shapes are held to the full-size models' (``weights/validate.py``): no key
left unconsumed, no parameter unfilled, every shape exact.  The audio
checkpoints may hold the wav2vec2 encoder under ``audio_encoder.`` or leave
it to the ``model_path`` folder (read without its CTC ``lm_head``); where
neither has it, the heads alone are checked.  ``--film`` checks a
TorchScript FiLM blob.  Exit code 0 when every family passes, 1 with the
problems listed.  A config may be a YAML or an importable ``.py`` file.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

import torch

from aniportrait_tpu_torch.config import Config, load_config
from aniportrait_tpu_torch.scripts.loader import audio_checkpoint, inference_settings, sub_config
from aniportrait_tpu_torch.weights import convert as cv
from aniportrait_tpu_torch.weights.load import find_weights, load_torch_state_dict
from aniportrait_tpu_torch.weights.validate import check_file, fullsize_model_trees


def _audio_state(path: str, model_path: str) -> dict:
    """An audio checkpoint's state, its encoder from ``model_path`` where
    the checkpoint has none and the folder holds weights."""
    state = load_torch_state_dict(path)
    if not any(k.startswith("audio_encoder.") for k in state):
        try:
            find_weights(model_path)
        except FileNotFoundError:
            return state
        return audio_checkpoint(path, model_path)
    return cv.merge_pos_conv_weight_norm(state, "audio_encoder.")


def validate(config: Config, audio_config: Config | None = None, film: str | None = None,
             size: str = "full") -> List[str]:
    """The problems of every family's files (empty = pass); prints each
    family's status."""
    overrides, _, _ = inference_settings(config)
    trees = fullsize_model_trees(size, overrides)
    problems: List[str] = []

    def run(family, state, want=None):
        found = check_file(state, trees[family] if want is None else want, family)
        problems.extend(found)
        print(f"checked {family}: {'OK' if not found else 'see problems'}")

    base = load_torch_state_dict(find_weights(str(config.pretrained_base_model_path), "unet"))
    run("vae", load_torch_state_dict(find_weights(str(config.pretrained_vae_path))))
    run("clip", load_torch_state_dict(find_weights(str(config.image_encoder_path))))
    run("reference_unet", {**base, **load_torch_state_dict(str(config.reference_unet_path))})
    denoising = dict(base)
    if config.get("motion_module_path"):
        denoising.update(load_torch_state_dict(str(config.motion_module_path)))
    denoising.update(load_torch_state_dict(str(config.denoising_unet_path)))
    run("denoising_unet", denoising)
    run("pose_guider", load_torch_state_dict(str(config.pose_guider_path)))

    if audio_config is not None:
        acfg = (sub_config(audio_config.audio_inference_config)
                if audio_config.get("audio_inference_config") else audio_config)
        for family, model_cfg, ckpt in (("audio2mesh", acfg.a2m_model, "a2m_ckpt"),
                                        ("audio2pose", acfg.a2p_model, "a2p_ckpt")):
            state = _audio_state(str(acfg.pretrained_model[ckpt]), str(model_cfg.model_path))
            want = trees[family]
            if not any(k.startswith("audio_encoder.") for k in state):
                want = {k: s for k, s in want.items() if not k.startswith("audio_encoder.")}
            run(family, state, want)

    if film:
        run("film", torch.jit.load(film, map_location="cpu").state_dict())
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="prompt config (animation.yaml shape)")
    ap.add_argument("--audio-config", default=None,
                    help="audio prompt config (animation_audio.yaml shape)")
    ap.add_argument("--film", default=None, help="FiLM TorchScript .pt")
    ap.add_argument("--size", choices=("full", "micro"), default="full",
                    help="the model size the files are held to (micro: the tests' models)")
    args = ap.parse_args(argv)
    if args.film and not os.path.exists(args.film):
        raise SystemExit(f"--film {args.film!r} not found")
    audio = load_config(args.audio_config) if args.audio_config else None
    problems = validate(load_config(args.config), audio, args.film, args.size)
    if problems:
        print("\nVALIDATION FAILED:")
        for p in problems:
            print(" -", p)
        return 1
    print("\nall checkpoint families match the models' keys and shapes — OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
