"""The port's audio path against the JAX package's, on the CPU.

The models at the tiny sizes of tests/test_audio_stack.py (wav2vec2 32 wide,
2 layers; Audio2Pose's decoder 16 wide, 2 layers, 4 heads), weights filled
from a numpy seed on the JAX side and carried into the port by
weights/from_jax.py; audio made from a seed.  JAX runs at the highest
matmul precision, the port in float32.

Bounds: wav2vec2's hidden states, Audio2Mesh's offsets 1e-4; Audio2Pose's
autoregressive output and ``generate_head_pose`` 2e-4 (each frame is fed
back, so a difference in the last float32 place grows along the clip).  The
last chunk of ``generate_head_pose`` follows ROADMAP F7: the port gives
``seq_len`` poses where the JAX function fails or falls short.

The audio loader reads the reference's ``.pt`` files (weight norm un-merged,
packed in_proj) and the wav2vec2 model folder; its models meet the JAX
package's conversion of the same files.  The audio2vid CLI meets the JAX
CLI at micro size.
"""

import random
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

import chip_smoke
import scripts.loader as jax_loader
from aniportrait_tpu.audio import wav2vec2 as jax_w2v
from aniportrait_tpu.audio.audio2mesh import Audio2MeshModel as JaxA2M
from aniportrait_tpu.audio.audio2pose import Audio2PoseModel as JaxA2P
from aniportrait_tpu.pipelines.pose2vid import Pose2VideoPipeline as JaxPipeline
from aniportrait_tpu.utils import image as jax_image
from aniportrait_tpu.utils import mp_utils as jax_mp
from aniportrait_tpu.utils import util as jax_util
from aniportrait_tpu.weights import convert as jax_convert
from aniportrait_tpu_torch.audio import wav2vec2 as port_w2v
from aniportrait_tpu_torch.audio.audio2mesh import Audio2MeshModel
from aniportrait_tpu_torch.audio.audio2pose import Audio2PoseModel
from aniportrait_tpu_torch.config import Config
from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline
from aniportrait_tpu_torch.scripts import audio2vid as port_audio2vid
from aniportrait_tpu_torch.scripts import loader as port_loader
from aniportrait_tpu_torch.scripts import pose2vid as port_pose2vid
from aniportrait_tpu_torch.utils import mp_utils as port_mp
from aniportrait_tpu_torch.weights import from_jax
from scripts import audio2vid as jax_audio2vid
from test_audio_stack import TINY_W2V
from test_torch_cli import faces, modules  # noqa: F401  (fixtures)
from test_torch_modules import init_jax, run_jax
from test_torch_pipeline import opencv_portable

ROOT = Path(__file__).resolve().parents[1]
ATOL, AR_ATOL = 1e-4, 2e-4
DECODER = dict(out_dim=6, latent_dim=16, num_layers=2, heads=4)


def _jax_enc_kw():
    kw = dict(TINY_W2V)
    kw["enc_layers"] = kw.pop("layers")
    kw["enc_heads"] = kw.pop("heads")
    return kw


def seeded_wav(n, seed=0, batch=None):
    shape = (n,) if batch is None else (batch, n)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def pose_models():
    """A tiny JAX Audio2Pose with numpy-filled parameters and the port's
    model holding the same weights."""
    jm = JaxA2P(**DECODER, **_jax_enc_kw())
    params = init_jax(jm, jnp.zeros((1, 3200), jnp.float32), 10, jnp.asarray([3]))["params"]
    pm = Audio2PoseModel(**DECODER, wav2vec2=TINY_W2V).eval()
    pm.load_state_dict(from_jax.audio2pose_from_jax(pm, params))
    return jm, params, pm


def test_tiny_sizes_are_the_smokes():
    assert chip_smoke.TINY_WAV2VEC2 == TINY_W2V


@pytest.mark.parametrize("t,seq_len", [(10, 30), (30, 7), (12, 1), (9, 9)],
                         ids=["up", "down", "one", "same"])
def test_linear_interpolation_matches_jax(t, seq_len):
    x = np.random.RandomState(t).randn(2, t, 5).astype(np.float32)
    want = np.asarray(jax_w2v.linear_interpolation(jnp.asarray(x), seq_len))
    got = port_w2v.linear_interpolation(torch.from_numpy(x), seq_len).numpy()
    assert got.shape == (2, seq_len, 5)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n,seq_len", [(3200, 30), (800, 120), (3200, 1)],
                         ids=["down", "up", "one"])
def test_wav2vec2_hidden_states_match_jax(n, seq_len):
    """Every hidden state (the encoder's input and each layer's output);
    the conv features are 319 frames at 3200 samples, 79 at 800."""
    wav = seeded_wav(n, seed=1, batch=2)
    jm = jax_w2v.Wav2Vec2Model(**TINY_W2V)
    params = init_jax(jm, jnp.asarray(wav), seq_len, True)
    _, want = run_jax(jm, params, jnp.asarray(wav), seq_len=seq_len,
                      output_hidden_states=True)
    pm = port_w2v.Wav2Vec2Model(**TINY_W2V).eval()
    pm.load_state_dict(from_jax.wav2vec2_from_jax(pm, params["params"]))
    with torch.no_grad():
        last, got = pm(torch.from_numpy(wav), seq_len, output_hidden_states=True)
    assert len(got) == len(want) == TINY_W2V["layers"] + 1
    for g, w in zip(got, want):
        assert g.shape == (2, seq_len, TINY_W2V["hidden"])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(last.numpy(), got[-1].numpy())


@pytest.mark.parametrize("only_last", [True, False], ids=["last", "mean"])
def test_audio2mesh_matches_jax(only_last):
    wav = seeded_wav(3200, seed=2, batch=1)
    jm = JaxA2M(out_dim=1404, latent_dim=16, only_last_features=only_last, **TINY_W2V)
    params = init_jax(jm, jnp.asarray(wav), 24)
    want = np.asarray(run_jax(jm, params, jnp.asarray(wav), seq_len=24))
    pm = Audio2MeshModel(out_dim=1404, latent_dim=16, only_last_features=only_last,
                         wav2vec2=TINY_W2V).eval()
    pm.load_state_dict(from_jax.audio2mesh_from_jax(pm, params["params"]))
    with torch.no_grad():
        got = pm(torch.from_numpy(wav), 24).numpy()
    assert got.shape == (1, 24, 1404) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_audio2pose_matches_jax_scan(pose_models):
    """The KV-cached decode against the JAX ``nn.scan``: two clips in one
    batch, speaker ids 3 and 7."""
    jm, params, pm = pose_models
    wav = seeded_wav(3200, seed=3, batch=2)
    ids = np.array([3, 7])
    want = np.asarray(run_jax(jm, {"params": params}, jnp.asarray(wav), seq_len=12,
                              id_seed=jnp.asarray(ids)))
    with torch.no_grad():
        got = pm(torch.from_numpy(wav), 12, torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 12, 6)
    np.testing.assert_allclose(got, want, atol=AR_ATOL, rtol=0)
    with torch.no_grad():  # the speaker id changes the sequence
        other = pm(torch.from_numpy(wav[:1]), 12, torch.tensor([7])).numpy()
    assert np.abs(other[0] - got[0]).max() > 1e-3
    with pytest.raises(ValueError, match="position table"):
        pm(torch.from_numpy(wav[:1]), 601, torch.tensor([0]))


def test_generate_head_pose_matches_jax(pose_models):
    """12 s: chunks of 150, 150 and 60 frames, the 60 merged into the second;
    the first chunk runs alone as the batch of equal chunks, then the tail."""
    jm, params, pm = pose_models
    wav = seeded_wav(16000 * 12, seed=4)
    want = jax_audio2vid.generate_head_pose(jm, params, wav, 360, id_seed=3)
    got = port_audio2vid.generate_head_pose(pm, wav, 360, id_seed=3)
    assert got.shape == want.shape == (360, 6)
    np.testing.assert_allclose(got, want, atol=AR_ATOL, rtol=0)


@pytest.mark.parametrize("secs", [5.0, 10.0])
def test_last_chunk_gets_its_frames(pose_models, secs):
    """ROADMAP F7: where the last 5-s chunk is full, ``seq_len % 150`` is 0.
    At 5.0 s the JAX function fails on a 0-frame decode; at 10.0 s it gives
    150 poses for 300 frames.  The port gives one pose per frame, and its
    10-s result starts as a 150-frame decode of the first 5 s would not: the
    two chunks run as one merged decode."""
    jm, params, pm = pose_models
    seq_len = int(round(secs * 30))
    wav = seeded_wav(int(16000 * secs), seed=5)
    got = port_audio2vid.generate_head_pose(pm, wav, seq_len, id_seed=1)
    assert got.shape == (seq_len, 6) and np.isfinite(got).all()
    if secs == 5.0:
        with pytest.raises(Exception):
            jax_audio2vid.generate_head_pose(jm, params, wav, seq_len, id_seed=1)
    else:
        short = jax_audio2vid.generate_head_pose(jm, params, wav, seq_len, id_seed=1)
        assert short.shape == (150, 6)


def test_wav2vec2_attention_takes_k4_from_1024_frames():
    """The encoder's self-attention goes through the port's dispatch: below
    1024 frames (T * T < FLASH_MIN_LOGITS) the library attention, from 1024
    the flash kernel K4 (on the card; its plain version on the CPU)."""
    from aniportrait_tpu_torch.ops.attention import FLASH_MIN_LOGITS, sdpa_route

    assert FLASH_MIN_LOGITS == 1024 * 1024
    assert sdpa_route(1, 1023, 1023, 12, 64) == "sdpa"
    assert sdpa_route(1, 1024, 1024, 12, 64) == "K4"
    assert sdpa_route(1, 1800, 1800, 12, 64) == "K4"


def test_template_head_pose_mirrors_and_tiles():
    temp = np.arange(5 * 6, dtype=np.float64).reshape(5, 6)
    got = port_audio2vid.template_head_pose(temp, 19)
    order = [0, 1, 2, 3, 4, 3, 2, 1] * 3
    np.testing.assert_array_equal(got, temp[order[:19]])


# ------------------------------------------------------------------ loader
def _tiny_audio_config(**paths):
    cfg = {**chip_smoke.AUDIO_CONFIG["audio_inference_config"]}
    cfg["a2m_model"] = {**cfg["a2m_model"], "latent_dim": 16}
    cfg["a2p_model"] = {**cfg["a2p_model"], "latent_dim": 16}
    if paths:
        cfg["pretrained_model"] = paths
    return cfg


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Tiny audio models (encoder TINY_W2V, decoder 8 layers of 16) and the
    reference's files written from them."""
    root = tmp_path_factory.mktemp("audio_ckpt")
    src = port_loader.load_audio_models(Config(_tiny_audio_config()), random_init=True,
                                        device="cpu", seed=5, wav2vec2=TINY_W2V)
    for model in src:  # the seeded draw's std 0.02 leaves the heads' outputs near 0
        with torch.no_grad():
            for name in ("out_fn", "pose_map_r"):
                if hasattr(model, name):
                    getattr(model, name).weight.normal_(0.0, 0.3)
    paths = chip_smoke.write_audio_checkpoints(*src, str(root))
    return src, paths


def test_audio_checkpoints_load_bit_for_bit(written):
    src, paths = written
    state = torch.load(paths["a2p_ckpt"], weights_only=True)
    key = "audio_encoder.encoder.pos_conv_embed.conv"
    assert {f"{key}.weight_g", f"{key}.weight_v", "PPE.pe", "biased_mask",
            "transformer_decoder.layers.7.multihead_attn.in_proj_weight"} <= set(state)
    assert f"{key}.weight" not in state
    loaded = port_loader.load_audio_models(Config(_tiny_audio_config(**paths)), device="cpu",
                                           wav2vec2=TINY_W2V)
    for a, b in zip(src, loaded):
        assert a.state_dict().keys() == b.state_dict().keys()
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k


def test_audio_checkpoints_meet_the_jax_conversion(written):
    """The same files through the JAX package's ``convert_audio2mesh`` /
    ``convert_audio2pose`` and its models: the port's loaded models give the
    same offsets and poses."""
    src, paths = written
    a2m, a2p = port_loader.load_audio_models(Config(_tiny_audio_config(**paths)),
                                             device="cpu", wav2vec2=TINY_W2V)
    wav = seeded_wav(3200, seed=6, batch=1)
    jm_params, unused = jax_convert.convert_audio2mesh(
        jax_convert.load_torch_state_dict(paths["a2m_ckpt"]))
    assert unused == []
    jm = JaxA2M(out_dim=1404, latent_dim=16, **TINY_W2V)
    want = np.asarray(run_jax(jm, {"params": jm_params}, jnp.asarray(wav), seq_len=20))
    with torch.no_grad():
        got = a2m(torch.from_numpy(wav), 20).numpy()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    jp_params, unused = jax_convert.convert_audio2pose(
        jax_convert.load_torch_state_dict(paths["a2p_ckpt"]))
    assert unused == []  # PPE.pe and biased_mask are skipped by rule
    jp = JaxA2P(out_dim=6, latent_dim=16, **_jax_enc_kw())
    want = np.asarray(run_jax(jp, {"params": jp_params}, jnp.asarray(wav), seq_len=10,
                              id_seed=jnp.asarray([4])))
    with torch.no_grad():
        got = a2p(torch.from_numpy(wav), 10, torch.tensor([4])).numpy()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=AR_ATOL, rtol=0)


def test_audio_loader_raises_on_an_unknown_key(written, tmp_path):
    src, paths = written
    state = torch.load(paths["a2m_ckpt"], weights_only=True)
    state["audio_encoder.encoder.extra_norm.weight"] = torch.ones(3)
    path = str(tmp_path / "audio2mesh.pt")
    torch.save(state, path)
    cfg = Config(_tiny_audio_config(a2m_ckpt=path, a2p_ckpt=paths["a2p_ckpt"]))
    with pytest.raises(ValueError, match="extra_norm"):
        port_loader.load_audio_models(cfg, device="cpu", wav2vec2=TINY_W2V)


def test_audio_loader_reads_the_wav2vec2_folder(written, tmp_path):
    """A task checkpoint with only the heads takes its encoder from the
    wav2vec2 folder, a CTC checkpoint as HF ships wav2vec2-base-960h: its
    keys under ``wav2vec2.``, a ``lm_head`` beside them."""
    src, paths = written
    heads, encoder = {}, {}
    for k, v in torch.load(paths["a2m_ckpt"], weights_only=True).items():
        if k.startswith("audio_encoder."):
            encoder["wav2vec2." + k[len("audio_encoder."):]] = v
        else:
            heads[k] = v
    encoder["lm_head.weight"] = torch.zeros(32, TINY_W2V["hidden"])
    encoder["lm_head.bias"] = torch.zeros(32)
    (tmp_path / "w2v").mkdir()
    torch.save(encoder, tmp_path / "w2v" / "pytorch_model.bin")
    torch.save(heads, tmp_path / "audio2mesh.pt")
    cfg = _tiny_audio_config(a2m_ckpt=str(tmp_path / "audio2mesh.pt"),
                             a2p_ckpt=paths["a2p_ckpt"])
    cfg["a2m_model"] = {**cfg["a2m_model"], "model_path": str(tmp_path / "w2v")}
    a2m, _ = port_loader.load_audio_models(Config(cfg), device="cpu", wav2vec2=TINY_W2V)
    for k, v in src[0].state_dict().items():
        assert torch.equal(v, a2m.state_dict()[k]), k


# --------------------------------------------------------------------- CLI
def _write_inputs(tmp_path, secs=0.5):
    ref = np.random.RandomState(7).randint(0, 255, (48, 40, 3), np.uint8)
    import cv2

    cv2.imwrite(str(tmp_path / "ref.png"), ref)
    rs = np.random.RandomState(8)
    n = int(16000 * secs)
    wavfile.write(str(tmp_path / "speech.wav"), 16000,
                  (0.2 * rs.randn(n) * 32767).clip(-32768, 32767).astype(np.int16))
    cfg = tmp_path / "prompt.yaml"
    cfg.write_text(
        f"audio_inference_config: {ROOT / 'configs/inference/inference_audio.yaml'}\n"
        f"inference_config: {ROOT / 'configs/inference/inference_v2.yaml'}\n"
        f"test_cases:\n  \"{tmp_path / 'ref.png'}\":\n    - \"{tmp_path / 'speech.wav'}\"\n")
    return str(cfg)


def test_audio2vid_cli_matches_jax(monkeypatch, tmp_path, modules, faces):  # noqa: F811
    """Each side's ``main()`` on the same prompt YAML, reference PNG and
    seeded WAV (0.5 s: 15 frames, -L 4), with the micro pipeline and tiny
    audio models over the same weights, the fixture's landmarks, the same
    speaker draw and numpy noise.  Audio2Mesh's ``out_fn`` is zero as the
    reference initialises it, so the projected mesh moves with the head
    pose only and both sides draw the same pose maps; the grids' reference
    and pose rows are equal, the result rows within one uint8 level."""
    monkeypatch.chdir(tmp_path)
    cfg = _write_inputs(tmp_path)
    jm, pm = modules
    jax_a2m = JaxA2M(out_dim=1404, latent_dim=16, **TINY_W2V)
    a2m_params = init_jax(jax_a2m, jnp.zeros((1, 3200), jnp.float32), 8)["params"]
    a2m_params["out_fn"] = jax.tree.map(np.zeros_like, a2m_params["out_fn"])
    jax_a2p = JaxA2P(**DECODER, **_jax_enc_kw())
    a2p_params = init_jax(jax_a2p, jnp.zeros((1, 3200), jnp.float32), 8,
                          jnp.asarray([0]), seed=1)["params"]
    port_a2m = Audio2MeshModel(out_dim=1404, latent_dim=16, wav2vec2=TINY_W2V).eval()
    port_a2m.load_state_dict(from_jax.audio2mesh_from_jax(port_a2m, a2m_params))
    port_a2p = Audio2PoseModel(**DECODER, wav2vec2=TINY_W2V).eval()
    port_a2p.load_state_dict(from_jax.audio2pose_from_jax(port_a2p, a2p_params))

    argv = ["--config", cfg, "-W", "64", "-H", "64", "-L", "4", "--steps", "2",
            "--seed", "3"]
    noise = lambda shape: np.random.RandomState(0).randn(*shape).astype(np.float32)
    grids = {}

    def extractor(mp):
        cls = mp.LMKExtractor

        def make():
            ext = cls(backend="unavailable")
            ext.backend = mp._CallableBackend(lambda img: faces[1])
            return ext
        return make

    def save(side):
        return lambda grid, path, fps=30.0: grids.setdefault(side, []).append(
            (np.asarray(grid), Path(path).name, fps))

    with monkeypatch.context() as m:
        m.setattr(jax_loader, "load_audio_models",
                  lambda cfg, **kw: ((jax_a2m, a2m_params), (jax_a2p, a2p_params)))
        m.setattr(jax_loader, "load_pipeline", lambda config, **kw: JaxPipeline(jm))
        m.setattr(jax_mp, "LMKExtractor", extractor(jax_mp))
        m.setattr(jax_util, "save_videos_grid", save("jax"))
        m.setattr(jax.random, "normal",
                  lambda key, shape, dtype=jnp.float32: jnp.asarray(noise(shape)))
        resize = jax_image._resize

        def portable_resize(*args, **kw):
            with opencv_portable():
                return resize(*args, **kw)

        m.setattr(jax_image, "_resize", portable_resize)
        m.setattr(sys, "argv", ["main", *argv])
        random.seed(11)
        with jax.default_matmul_precision("highest"):
            jax_audio2vid.main()
    with monkeypatch.context() as m:
        m.setattr(port_audio2vid, "load_audio_models",
                  lambda cfg, **kw: (port_a2m, port_a2p))
        m.setattr(port_pose2vid, "load_pipeline", lambda config, **kw: Pose2VideoPipeline(pm))
        m.setattr(port_audio2vid, "LMKExtractor", extractor(port_mp))
        m.setattr(port_audio2vid, "save_videos_grid", save("port"))
        m.setattr(torch, "randn", lambda shape, **kw: torch.from_numpy(noise(shape)))
        random.seed(11)
        port_audio2vid.main([*argv, "--device", "cpu"])

    (gj, name_j, fps_j), = grids["jax"]
    (gp, name_p, fps_p), = grids["port"]
    untimed = lambda name: re.sub(r"_\d{4}(?=(_noaudio)?\.mp4$)", "", name)
    assert (untimed(name_p), fps_p) == (untimed(name_j), fps_j)
    assert gp.shape == gj.shape == (3, 4, 64, 64, 3)
    np.testing.assert_array_equal(gp[0], gj[0])
    np.testing.assert_array_equal(gp[1], gj[1])
    assert (gp[1].sum(-1) > 0).sum() > 100  # the mesh is drawn
    assert np.abs(gp[2] - gj[2]).max() <= 1.0 / 255 + 1e-6


def test_audio2vid_acc_raises_before_any_model_is_built(monkeypatch):
    def no_models(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(port_audio2vid, "load_audio_models", no_models)
    monkeypatch.setattr(port_pose2vid, "load_pipeline", no_models)
    with pytest.raises(NotImplementedError, match="M8"):
        port_audio2vid.main(["-acc", "--device", "cpu"])
