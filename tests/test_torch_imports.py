"""(f) The port imports nothing of JAX or of the JAX package: a fresh
interpreter imports every module of aniportrait_tpu_torch, and neither jax,
flax, aniportrait_tpu, the root scripts package nor the root bench.py (or
any module under them) is in sys.modules.  The GPU smoke's path (factory,
pipeline, kernels, a whole-clip generation; the loader and the pose2vid
CLI's generation; the audio models, the audio loader and the serving core's
request on arrays; FiLM interpolation on a clip tensor, LPIPS and the model
trees of weight validation; the pipeline over a mesh) loads none of them
either."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import aniportrait_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
# top-level packages the port and the smoke path must not load: JAX, flax,
# the JAX package, and the JAX package's root scripts package and bench.py
REFUSED = ("jax", "jaxlib", "flax", "aniportrait_tpu", "scripts", "bench")


def test_port_imports_no_jax():
    names = sorted(
        m.name for m in pkgutil.walk_packages(aniportrait_tpu_torch.__path__,
                                              "aniportrait_tpu_torch.")
    )
    assert {"aniportrait_tpu_torch.pipelines.pose2vid", "aniportrait_tpu_torch.audio.wav2vec2",
            "aniportrait_tpu_torch.scripts.serve", "aniportrait_tpu_torch.scripts.app",
            "aniportrait_tpu_torch.models.film_net", "aniportrait_tpu_torch.utils.quality",
            "aniportrait_tpu_torch.utils.frame_interpolation",
            "aniportrait_tpu_torch.weights.validate",
            "aniportrait_tpu_torch.scripts.quality_gate",
            "aniportrait_tpu_torch.scripts.quality_speed_gate",
            "aniportrait_tpu_torch.scripts.validate_weights",
            "aniportrait_tpu_torch.parallel.mesh", "aniportrait_tpu_torch.parallel.zero",
            "aniportrait_tpu_torch.parallel.launch",
            "aniportrait_tpu_torch.scripts.vid2pose",
            "aniportrait_tpu_torch.scripts.generate_ref_pose",
            "aniportrait_tpu_torch.scripts.prepare_video",
            "aniportrait_tpu_torch.scripts.preprocess_dataset"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {REFUSED!r})\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_smoke_path_loads_nothing_of_the_jax_package():
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from aniportrait_tpu_torch import factory\n"
        "pipe = factory.build_pipeline('micro', device='cpu')\n"
        "rs = np.random.RandomState(0)\n"
        "img = rs.randint(0, 255, (64, 64, 3), np.uint8)\n"
        "pipe(img, [img, img], None, 64, 64, 2, num_inference_steps=1)\n"
        "import chip_smoke\n"
        "from aniportrait_tpu_torch.config import Config\n"
        "from aniportrait_tpu_torch.scripts import bench, loader, pose2vid, vid2vid\n"
        "pipe = loader.load_pipeline(Config(chip_smoke.ENTRY_CONFIG), random_init=True,\n"
        "                            size='micro', device='cpu')\n"
        "args = pose2vid.parse_args(['-W', '64', '-H', '64', '--steps', '1'])\n"
        "case = dict(ref_image=img, pose_images=[img, img], kw=dict(video_length=2))\n"
        "(_, grid), = pose2vid.generate(pipe, [case], args)\n"
        "assert grid.shape == (3, 2, 64, 64, 3), grid.shape\n"
        "from aniportrait_tpu_torch.scripts import app, audio2vid, serve, serving_core\n"
        "audio = {**chip_smoke.AUDIO_CONFIG['audio_inference_config']}\n"
        "for k in ('a2m_model', 'a2p_model'):\n"
        "    audio[k] = {**audio[k], 'latent_dim': 16}\n"
        "a2m, a2p = loader.load_audio_models(Config(audio), random_init=True, device='cpu',\n"
        "                                    wav2vec2=chip_smoke.TINY_WAV2VEC2)\n"
        "models = serving_core.ServingModels(pipe=pipe, a2m=a2m, a2p=a2p)\n"
        "face = dict(lmks3d=np.zeros((468, 3)), trans_mat=np.eye(4))\n"
        "sample = dict(audio_feature=rs.randn(3200).astype(np.float32), seq_len=6)\n"
        "video = serving_core.animate(models, sample, face, img, None, size=64, steps=1,\n"
        "                             length=2, seed=0, pose_maps=[img])\n"
        "assert video.shape == (2, 64, 64, 3), video.shape\n"
        "from aniportrait_tpu_torch.scripts import quality_speed_gate, validate_weights\n"
        "from aniportrait_tpu_torch.utils import frame_interpolation as fi, quality\n"
        "from aniportrait_tpu_torch.weights import validate\n"
        "film = fi._load_film(None, random_init=True, device='cpu')\n"
        "clip = torch.from_numpy(np.stack([img, img]))\n"
        "out = fi.batch_images_interpolation_tool(clip, film, 2, return_device=True)\n"
        "assert out.shape == (1, 4, 64, 64, 3), out.shape\n"
        "w = {f'conv{i}_w': np.zeros((k, k, c0, c1), np.float32) for i, (c1, k, _, _), c0 in\n"
        "     zip(range(5), quality._ALEX_CONVS, (3, 64, 192, 384, 256))}\n"
        "w.update({f'conv{i}_b': np.zeros(c, np.float32) for i, (c, *_) in enumerate(quality._ALEX_CONVS)})\n"
        "w.update({f'lin{i}': np.ones(c, np.float32) for i, (c, *_) in enumerate(quality._ALEX_CONVS)})\n"
        "assert quality.LPIPS(w)(img, img).shape == (1,)\n"
        "assert 'film' in validate.fullsize_model_trees('micro')\n"
        "from aniportrait_tpu_torch.parallel import make_mesh\n"
        "from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline\n"
        "meshed = Pose2VideoPipeline(pipe.m, dtype=pipe.dtype, mesh=make_mesh())\n"
        "assert meshed(img, [img, img], None, 64, 64, 2, num_inference_steps=1).shape == "
        "(2, 64, 64, 3)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {REFUSED!r})\n"
        "assert not bad, bad\n"
    )
    # one intra-op thread, as the in-process port tests run (test_torch_modules.one_thread)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
