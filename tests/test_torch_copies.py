"""The port's own copies of JAX-free modules of the JAX package equal the
originals: the weight-naming rules (weights/convert.py, the FiLM rules
included) key for key and transform for transform, in order (the quality
metrics and ``check_regression``: tests/test_torch_quality.py); the context-window tables
(pipelines/context.py) entry for entry; and the entry points' host front
end (config, the quality gate, the landmark graph, pose math and
retargeting, the pose drawing, the IO helpers, the audio loading) output for
output; the audio weight rules' conversions tree for tree; and the trainer's
dataset, tracker and prefetch thread batch for batch."""

import zipfile
from pathlib import Path

import numpy as np
import pytest

from aniportrait_tpu import config as jax_config
from aniportrait_tpu.landmark import anchors as jax_anchors
from aniportrait_tpu.landmark import blazeface as jax_blazeface
from aniportrait_tpu.landmark import geometry as jax_geometry
from aniportrait_tpu.landmark import pipeline as jax_landmark
from aniportrait_tpu.pipelines import context as jax_context
from aniportrait_tpu.utils import audio_util as jax_audio
from aniportrait_tpu.utils import draw_util as jax_draw
from aniportrait_tpu.utils import mp_utils as jax_mp
from aniportrait_tpu.utils import pose_util as jax_pose
from aniportrait_tpu.utils import quality_gate as jax_gate
from aniportrait_tpu.utils import util as jax_util
from aniportrait_tpu.weights import convert as jax_convert
from aniportrait_tpu_torch import config as port_config
from aniportrait_tpu_torch.landmark import anchors as port_anchors
from aniportrait_tpu_torch.landmark import blazeface as port_blazeface
from aniportrait_tpu_torch.landmark import geometry as port_geometry
from aniportrait_tpu_torch.landmark import pipeline as port_landmark
from aniportrait_tpu_torch.pipelines import context as port_context
from aniportrait_tpu_torch.utils import audio_util as port_audio
from aniportrait_tpu_torch.scripts.vid2vid import (
    retarget_pose_and_expression as port_retarget,
)
from aniportrait_tpu_torch.utils import draw_util as port_draw
from aniportrait_tpu_torch.utils import mp_utils as port_mp
from aniportrait_tpu_torch.utils import pose_util as port_pose
from aniportrait_tpu_torch.utils import quality_gate as port_gate
from aniportrait_tpu_torch.utils import util as port_util
from aniportrait_tpu_torch.weights import convert as port_convert
from scripts.vid2vid import retarget_pose_and_expression as jax_retarget

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "landmark_golden.npz"

RULE_LISTS = [
    ("unet_rules", ()),
    ("vae_rules", ()),
    ("clip_vision_rules", ()),
    ("pose_guider_rules", ()),
    ("_attention_block_rules", (r"down_blocks\.0\.attentions\.1", "attn_down_0_1")),
    ("_resnet_rules", (r"mid_block\.resnets\.0", "mid_resnet_0")),
    ("_motion_rules", (r"up_blocks\.1\.motion_modules\.2", "up_1_motion_2")),
    ("wav2vec2_rules", ("audio_encoder.",)),
    ("film_rules", ()),
]


def _spelled(rules):
    return [(pat, tmpl, fn.__name__) for pat, tmpl, fn in rules]


@pytest.mark.parametrize("name,args", RULE_LISTS, ids=[n for n, _ in RULE_LISTS])
def test_rule_lists_equal_the_originals(name, args):
    port = getattr(port_convert, name)(*args)
    ref = getattr(jax_convert, name)(*args)
    assert len(port) > 0
    assert _spelled(port) == _spelled(ref)


def test_transforms_and_apply_rules_equal_the_originals():
    rs = np.random.RandomState(0)
    for fn in ("t_none", "t_linear", "t_conv2d", "t_conv1x1_dense", "t_conv1d"):
        w = rs.randn(*{"t_conv2d": (4, 3, 2, 2), "t_conv1x1_dense": (4, 3, 1, 1),
                       "t_conv1d": (4, 3, 5)}.get(fn, (4, 3))).astype(np.float32)
        np.testing.assert_array_equal(getattr(port_convert, fn)(w),
                                      getattr(jax_convert, fn)(w))
    sd = {"conv_layers.0.weight": rs.randn(3, 3, 3, 3).astype(np.float32),
          "conv_layers.1.running_mean": rs.randn(3).astype(np.float32),
          "conv_layers.1.num_batches_tracked": np.zeros((), np.float32),
          "not_a_key": np.zeros(1, np.float32)}
    p_params, p_stats, p_unused = port_convert.apply_rules(
        sd, port_convert.pose_guider_rules())
    j_params, j_stats, j_unused = jax_convert.apply_rules(
        sd, jax_convert.pose_guider_rules())
    assert p_unused == j_unused == ["not_a_key"]
    np.testing.assert_array_equal(p_params["stem_0"]["conv"]["kernel"],
                                  j_params["stem_0"]["conv"]["kernel"])
    np.testing.assert_array_equal(p_stats["stem_0"]["bn"]["mean"],
                                  j_stats["stem_0"]["bn"]["mean"])


def _tree_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            _tree_equal(a[key], b[key])
        else:
            np.testing.assert_array_equal(a[key], b[key])


def _audio_state(model, parametrized=False):
    """A model's state dict as the reference's files hold it: the
    positional conv's weight norm un-merged (``weight_g``/``weight_v``, or
    the newer ``parametrizations.weight.original0/1``), with the tensors a
    rule skips and one no rule takes."""
    import torch

    rs = np.random.RandomState(9)
    state = {k: torch.from_numpy(rs.randn(*v.shape).astype(np.float32))
             for k, v in model.state_dict().items()}
    base = "audio_encoder.encoder.pos_conv_embed.conv"
    w = state.pop(f"{base}.weight")
    g, v = w.norm(dim=(0, 1), keepdim=True), w
    if parametrized:
        state[f"{base}.parametrizations.weight.original0"] = g
        state[f"{base}.parametrizations.weight.original1"] = v
    else:
        state[f"{base}.weight_g"], state[f"{base}.weight_v"] = g, v
    state["audio_encoder.masked_spec_embed"] = torch.zeros(w.shape[0])
    state["not_a_key"] = torch.zeros(1)
    return state


@pytest.mark.parametrize("parametrized", [False, True], ids=["weight_g", "original0"])
def test_audio_conversions_equal_the_originals(parametrized):
    """``convert_audio2mesh``, ``convert_audio2pose`` (with ``PPE.pe`` and
    ``biased_mask``), ``convert_wav2vec2`` and ``merge_pos_conv_weight_norm``
    of the port and of the JAX package on the same seeded state dicts."""
    import torch

    from aniportrait_tpu_torch.audio.audio2mesh import Audio2MeshModel
    from aniportrait_tpu_torch.audio.audio2pose import Audio2PoseModel

    tiny = dict(hidden=32, layers=2, heads=4, intermediate=64, pos_conv_kernel=16,
                pos_conv_groups=4, conv_layers=((16, 10, 5), (16, 3, 2)))
    mesh = _audio_state(Audio2MeshModel(latent_dim=16, wav2vec2=tiny), parametrized)
    pose = _audio_state(Audio2PoseModel(latent_dim=16, wav2vec2=tiny), parametrized)
    pose["PPE.pe"], pose["biased_mask"] = torch.zeros(1, 600, 16), torch.zeros(8, 4, 4)
    for fn, state in (("convert_audio2mesh", mesh), ("convert_audio2pose", pose)):
        p_params, p_unused = getattr(port_convert, fn)(state)
        j_params, j_unused = getattr(jax_convert, fn)(state)
        assert p_unused == j_unused == ["not_a_key"]
        _tree_equal(p_params, j_params)
    encoder = {k[len("audio_encoder."):]: v for k, v in mesh.items()
               if k.startswith("audio_encoder.")}
    p_params, p_unused = port_convert.convert_wav2vec2(encoder)
    j_params, j_unused = jax_convert.convert_wav2vec2(encoder)
    assert p_unused == j_unused == []
    _tree_equal(p_params, j_params)
    merged = port_convert.merge_pos_conv_weight_norm(mesh, "audio_encoder.")
    _tree_equal(merged, jax_convert.merge_pos_conv_weight_norm(mesh, "audio_encoder."))
    assert "audio_encoder.encoder.pos_conv_embed.conv.weight" in merged
    for part in range(3):
        np.testing.assert_array_equal(
            port_convert._split_in_proj(pose, "transformer_decoder.layers.1.self_attn")[0][part],
            jax_convert._split_in_proj(pose, "transformer_decoder.layers.1.self_attn")[0][part])


def test_audio_util_equals_the_original(tmp_path):
    """WAV decoding (int16 stereo at 22.05 kHz, resampled; int32; uint8;
    float32), the normalisation and ``prepare_audio_feature``; a file that is
    no WAV needs ffmpeg."""
    import shutil

    from scipy.io import wavfile

    rs = np.random.RandomState(10)
    files = {
        "s16_stereo.wav": (22050, (rs.randn(5000, 2) * 6000).astype(np.int16)),
        "s32.wav": (16000, (rs.randn(4000) * 2e8).astype(np.int32)),
        "u8.wav": (8000, rs.randint(0, 255, 3000).astype(np.uint8)),
        "f32.wav": (16000, (0.1 * rs.randn(4321)).astype(np.float32)),
    }
    for name, (rate, data) in files.items():
        path = str(tmp_path / name)
        wavfile.write(path, rate, data)
        a, b = port_audio.load_audio(path), jax_audio.load_audio(path)
        assert a.dtype == b.dtype == np.float32 and a.ndim == 1
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(port_audio.normalize_audio(a), jax_audio.normalize_audio(b))
        pa, pb = port_audio.prepare_audio_feature(path), jax_audio.prepare_audio_feature(path)
        assert pa["seq_len"] == pb["seq_len"]
        np.testing.assert_array_equal(pa["audio_feature"], pb["audio_feature"])
    assert port_audio.prepare_audio_feature(str(tmp_path / "f32.wav"), fps=25)["seq_len"] == 7
    if shutil.which("ffmpeg") is None:
        (tmp_path / "a.mp3").write_bytes(b"ID3 not audio")
        for mod in (port_audio, jax_audio):
            with pytest.raises(RuntimeError, match="ffmpeg"):
                mod.load_audio(str(tmp_path / "a.mp3"))


@pytest.mark.parametrize("length,frames,stride,overlap",
                         [(24, 8, 3, 2), (16, 16, 1, 4), (40, 12, 2, 3)])
def test_context_windows_equal_the_originals(length, frames, stride, overlap):
    for step in range(4):
        port = port_context.uniform_context_windows(step, length, frames, stride, overlap)
        ref = jax_context.uniform_context_windows(step, length, frames, stride, overlap)
        np.testing.assert_array_equal(port, ref)


# ---------------------------------------------------------------- host front end
# The entry points' JAX-free host modules, copied into the port: config,
# the quality gate, the landmark graph (anchors, detection decode, NMS,
# geometry, native runner), pose math, the pose drawing and the IO helpers.
CONFIG_FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*")
                      if p.suffix in (".yaml", ".py"))


@pytest.mark.parametrize("path", CONFIG_FILES)
def test_config_equals_the_original(path):
    port = port_config.load_config(str(ROOT / path))
    ref = jax_config.load_config(str(ROOT / path))
    assert port.to_dict() == ref.to_dict() and len(port) == len(ref)
    for key in ref:
        assert (port[key] == ref[key]) if not isinstance(ref[key], jax_config.Config) \
            else port[key].to_dict() == ref[key].to_dict()
    delta = {"extra": {"a": [1, {"b": 2}]}, next(iter(ref)): "replaced"}
    assert port.merge(delta).to_dict() == ref.merge(delta).to_dict()


GATE_CASES = [(1, False, False, False), (2, False, False, False), (3, False, False, False),
              (3, False, False, True), (4, False, False, False), (1, True, False, False),
              (1, False, True, False), (2, True, True, False)]


@pytest.mark.parametrize("table", ["docs", "empty"])
@pytest.mark.parametrize("k,fusion,rotate,force", GATE_CASES)
def test_quality_gate_equals_the_original(k, fusion, rotate, force, table, tmp_path):
    """Same decision (refusal and its message, or the warnings) for the
    repository's measured table and for no table."""
    table_dir = None if table == "docs" else str(tmp_path)
    if table_dir is None:
        assert port_gate.load_gate_table() == jax_gate.load_gate_table()
    out = []
    for gate in (port_gate, jax_gate):
        printed = []
        try:
            warned = gate.enforce_approximation_gate(k, fusion, rotate, force,
                                                     table_dir=table_dir,
                                                     _print=printed.append)
            out.append(("ok", warned, printed))
        except ValueError as e:
            out.append(("refused", str(e), printed))
    assert out[0] == out[1]
    assert (out[0][0] == "refused") == (k >= 3 and not force)


def _rigid(rs, n):
    return np.stack([jax_pose.euler_and_translation_to_matrix(
        rs.uniform(-25, 25, 3), rs.uniform(-5, 5, 3) + [0, 0, -50]) for _ in range(n)])


def test_pose_util_equals_the_original():
    rs = np.random.RandomState(3)
    pts = rs.randn(5, 468, 3)
    mats = _rigid(rs, 5)
    pose6 = np.concatenate([rs.uniform(-20, 20, (5, 3)), rs.uniform(-3, 3, (5, 3))], 1)
    for fn, args in (("create_perspective_matrix", (0.75,)),
                     ("euler_and_translation_to_matrix", (pose6[0, :3], pose6[0, 3:])),
                     ("matrix_to_euler_and_translation", (mats[1],)),
                     ("project_points", (pts, mats[0], pose6, [512, 384])),
                     ("project_points_with_trans", (pts, mats, [384, 512])),
                     ("smooth_pose_seq", (pose6, 3))):
        port, ref = getattr(port_pose, fn)(*args), getattr(jax_pose, fn)(*args)
        for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (port, ref))):
            np.testing.assert_array_equal(a, b)


def test_retarget_pose_and_expression_equals_the_original():
    rs = np.random.RandomState(4)
    golden = np.load(GOLDEN)
    solver = jax_geometry.GeometrySolver(jax_geometry.load_geometry_metadata(
        jax_landmark.DEFAULT_TASK))
    mesh = solver.solve(golden["solo_lmks"], (512, 512))["mesh"]
    results = [dict(trans_mat=m, lmks3d=mesh + 0.1 * rs.randn(*mesh.shape),
                    bs=rs.uniform(0, 1, 51)) for m in _rigid(rs, 7)]
    ref_result = dict(trans_mat=golden["solo_trans_mat"], lmks3d=mesh)
    for shape in ([512, 512], [720, 1280]):
        np.testing.assert_array_equal(port_retarget(results, ref_result, shape),
                                      jax_retarget(results, ref_result, shape))


def test_anchors_decode_and_nms_equal_the_originals():
    anchors = port_anchors.blazeface_short_range_anchors()
    np.testing.assert_array_equal(anchors, jax_anchors.blazeface_short_range_anchors())
    assert anchors.shape == (896, 4)
    rs = np.random.RandomState(5)
    boxes = rs.randn(896, 16).astype(np.float32) * 8
    boxes[:, 2:4] = np.abs(boxes[:, 2:4]) * 4 + 20
    scores = rs.randn(896, 1).astype(np.float32) * 3
    port = port_blazeface.decode_detections(boxes, scores, anchors)
    ref = jax_blazeface.decode_detections(boxes, scores,
                                          jax_anchors.blazeface_short_range_anchors())
    np.testing.assert_array_equal(port, ref)
    assert 10 < len(ref) < 896
    np.testing.assert_array_equal(port_blazeface.weighted_nms(port),
                                  jax_blazeface.weighted_nms(ref))
    assert port_blazeface.weighted_nms(port[:0]).shape == (0, 17)


@pytest.fixture(scope="module")
def solvers():
    return tuple(g.GeometrySolver(g.load_geometry_metadata(port_landmark.DEFAULT_TASK))
                 for g in (port_geometry, jax_geometry))


@pytest.mark.parametrize(
    "euler", [(0.0, 0.0, 0.0), (20.0, 0.0, 0.0), (0.0, 25.0, 0.0),
              (0.0, 0.0, 15.0), (10.0, -15.0, 5.0), (-25.0, 20.0, -10.0)])
@pytest.mark.parametrize("trans", [(0.0, 0.0, -45.0), (3.0, -4.0, -60.0)])
def test_geometry_solver_equals_the_original(solvers, euler, trans):
    """The pose grid of tests/test_landmark.py:148: landmarks projected from
    the canonical mesh at a known pose, solved by both copies."""
    port, ref = solvers
    np.testing.assert_array_equal(port.canonical, ref.canonical)
    mat = jax_pose.euler_and_translation_to_matrix(list(euler), list(trans))
    proj = jax_pose.project_points_with_trans(ref.canonical[None], mat[None], [512, 512])[0]
    cam = (np.concatenate([ref.canonical, np.ones((468, 1))], 1) @ mat.T)[:, :3]
    lm = np.zeros((478, 3), np.float32)
    lm[:468, :2] = proj / 512
    lm[:468, 2] = (cam[:, 2] - cam[:, 2].mean()) / 100
    a, b = port.solve(lm, (512, 512)), ref.solve(lm, (512, 512))
    for key in ("mesh", "trans_mat"):
        np.testing.assert_array_equal(a[key], b[key])


def test_native_landmark_network_equals_the_original():
    """The landmark graph on both copies' native runner (the in-repo C++
    TFLite interpreter): the same rotated crop of a seeded image, the same
    478-point network outputs, the same end-to-end result."""
    rs = np.random.RandomState(6)
    yy, xx = np.mgrid[0:240, 0:320]
    img = np.stack([127 + 100 * np.sin(xx / 9.0 + c) * np.cos(yy / 7.0) for c in range(3)],
                   -1).astype(np.uint8)
    img = np.clip(img.astype(int) + rs.randint(-20, 20, img.shape), 0, 255).astype(np.uint8)
    port = port_landmark.FaceLandmarkerLite(engine="native")
    ref = jax_landmark.FaceLandmarkerLite(engine="native")
    crop_p, m_p = port._crop(img, 170.0, 110.0, 150.0, 0.2)
    crop_j, m_j = ref._crop(img, 170.0, 110.0, 150.0, 0.2)
    np.testing.assert_array_equal(crop_p, crop_j)
    np.testing.assert_array_equal(m_p, m_j)
    inp = crop_p.astype(np.float32)[None] / 255.0
    outs_p, outs_j = port.lmk.run(inp), ref.lmk.run(inp)
    assert [o.shape for o in outs_p] == [(1434,), (1,), (1,)]
    for a, b in zip(outs_p, outs_j):
        np.testing.assert_array_equal(a, b)
    assert port.blendshape_subset == ref.blendshape_subset
    res_p, res_j = port(img[..., ::-1].copy()), ref(img[..., ::-1].copy())
    assert (res_p is None) == (res_j is None)


@pytest.mark.parametrize("name", ["lyl", "solo", "Aragaki"])
def test_pose_drawing_is_byte_equal(name):
    """The conditioning contract: the port's drawing of the fixture's
    landmarks equals the fixture's pose map and the JAX drawing, byte for
    byte, at 512 and after the resize to another size."""
    golden = np.load(GOLDEN)
    lmks = golden[f"{name}_lmks"].astype(np.float32)
    port = port_draw.FaceMeshVisualizer(forehead_edge=False)
    ref = jax_draw.FaceMeshVisualizer(forehead_edge=False)
    drawn = port.draw_landmarks((512, 512), lmks, normed=True)
    assert drawn.dtype == np.uint8 and (drawn.sum(-1) > 0).sum() > 2000
    np.testing.assert_array_equal(drawn, golden[f"{name}_pose"])
    np.testing.assert_array_equal(drawn, ref.draw_landmarks((512, 512), lmks, normed=True))
    px = lmks[:, :2] * [384, 640]
    np.testing.assert_array_equal(port.draw_landmarks((384, 640), px),
                                  ref.draw_landmarks((384, 640), px))
    wide = port_draw.FaceMeshVisualizer(forehead_edge=True)
    np.testing.assert_array_equal(
        wide.draw_landmarks((512, 512), lmks, normed=True),
        jax_draw.FaceMeshVisualizer(forehead_edge=True).draw_landmarks((512, 512), lmks,
                                                                       normed=True))


def test_landmark_extractor_backends_equal_the_originals(tmp_path):
    golden = np.load(GOLDEN)
    for i, name in enumerate(("lyl", "solo")):
        np.savez(tmp_path / f"{i}.npz", lmks=golden[f"{name}_lmks"],
                 trans_mat=golden[f"{name}_trans_mat"], bs=golden[f"{name}_bs"])
    img = np.zeros((8, 8, 3), np.uint8)
    port = port_mp.LMKExtractor(backend="precomputed", root=str(tmp_path))
    ref = jax_mp.LMKExtractor(backend="precomputed", root=str(tmp_path))
    for _ in range(3):  # two sidecars, then none
        a, b = port(img), ref(img)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    for ext in (port_mp.LMKExtractor(backend="unavailable"),
                jax_mp.LMKExtractor(backend="unavailable")):
        with pytest.raises(RuntimeError, match="No landmark backend"):
            ext(img)


def test_io_helpers_equal_the_originals(tmp_path):
    """A grid written by the port reads back as by the original's writer;
    the landmark-driven face crop takes the same pixels in both branches."""
    rs = np.random.RandomState(7)
    grid = rs.uniform(0, 1, (3, 4, 32, 48, 3)).astype(np.float32)
    port_util.save_videos_grid(grid, str(tmp_path / "p.mp4"), fps=12)
    jax_util.save_videos_grid(grid, str(tmp_path / "j.mp4"), fps=12)
    frames_p = port_util.read_frames(str(tmp_path / "p.mp4"))
    frames_j = jax_util.read_frames(str(tmp_path / "j.mp4"))
    assert len(frames_p) == 4 and frames_p[0].shape == (96, 48, 3)
    for a, b in zip(frames_p, frames_j):
        np.testing.assert_array_equal(a, b)
    assert port_util.get_fps(str(tmp_path / "p.mp4")) == jax_util.get_fps(
        str(tmp_path / "j.mp4")) == 12
    lmks = np.load(GOLDEN)["solo_lmks"]
    img = rs.randint(0, 255, (300, 400, 3), np.uint8)
    for scale in (1.0, 0.3):  # a face filling the image, and a small one
        small = lmks.copy()
        small[:, :2] = 0.5 + (lmks[:, :2] - 0.5) * scale
        fn = lambda _img, small=small: {"lmks": small}
        np.testing.assert_array_equal(port_util.crop_face(img, fn), jax_util.crop_face(img, fn))


# The built library against the shipped one: the shipped .so was compiled
# with -march=native on another CPU, so vector widths and fused multiply-adds
# differ and the outputs agree to float32 rounding, not bit for bit (up to
# 3.7e-7 of the largest output measured).  Each output is held to 2e-6 of
# its largest |shipped value|, a few float32 ulps with room for other CPUs.
NATIVE_REL_TOL = 2e-6


def test_native_runner_builds_its_own_library_when_the_shipped_one_is_missing(
        tmp_path, monkeypatch):
    """Where native/tflite_runner/libtflite_runner.so is missing (or does
    not load), the port compiles tflite_runner.cc into its build directory,
    never under native/; that library runs the models as the shipped one
    does (to ``NATIVE_REL_TOL``) and gives the same bits on every run."""
    from aniportrait_tpu_torch.landmark import native

    content = zipfile.ZipFile(port_landmark.DEFAULT_TASK).read("face_detector.tflite")
    x = np.random.RandomState(8).rand(1, 128, 128, 3).astype(np.float32)
    shipped = native.NativeInterpreter(content).run(x)
    native_files = sorted(p.name for p in (ROOT / "native" / "tflite_runner").iterdir())
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "missing.so"))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    lib = native._load_lib()
    assert (tmp_path / "build" / "libtflite_runner.so").exists()
    monkeypatch.setattr(native, "_LIB", lib)
    built = native.NativeInterpreter(content).run(x)
    again = native.NativeInterpreter(content).run(x)
    assert len(built) == len(shipped) > 0
    for a, b, c in zip(built, shipped, again):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=NATIVE_REL_TOL * float(np.abs(b).max()))
        np.testing.assert_array_equal(a, c)
    assert sorted(p.name for p in (ROOT / "native" / "tflite_runner").iterdir()) == native_files


# ---------------------------------------------------------------- training
# The trainer's JAX-free host modules, copied into the port: the dataset
# (OpenCV), the tracker and the prefetch thread.
def _face_manifest(root, videos=2, frames=10, size=48):
    import json

    import cv2

    rs = np.random.RandomState(12)
    manifest = {}
    for v in range(videos):
        (root / f"v{v}").mkdir()
        paths, lmks = [], []
        for i in range(frames):
            fp, lp = root / f"v{v}" / f"{i}.png", root / f"v{v}" / f"{i}.npy"
            cv2.imwrite(str(fp), rs.randint(0, 255, (size + 8 * v, size, 3), np.uint8))
            np.save(lp, (rs.rand(478, 3) * 0.6 + 0.2).astype(np.float32))
            paths.append(str(fp))
            lmks.append(str(lp))
        manifest[f"v{v}"] = {"video_clip_num": 1,
                             "clip_data_list": [{"frame_path_list": paths, "lmks_list": lmks}]}
    path = root / "train.json"
    path.write_text(json.dumps(manifest))
    return str(path)


@pytest.mark.parametrize("is_image,aug", [(True, False), (False, True)],
                         ids=["stage1", "stage2"])
def test_face_dataset_equals_the_original(is_image, aug, tmp_path):
    """The same seed gives the same batches (frames resized, poses drawn
    from the landmarks, the CLIP image) and validation samples."""
    from aniportrait_tpu.train.dataset import FaceDataset as JaxDataset
    from aniportrait_tpu_torch.train.dataset import FaceDataset as PortDataset

    kw = dict(json_path=_face_manifest(tmp_path), sample_size=(32, 32), sample_stride=2,
              sample_n_frames=4, is_image=is_image, sample_stride_aug=aug, seed=3)
    port, ref = PortDataset(**kw), JaxDataset(**kw)
    assert len(port) == len(ref) == 2
    for a, b in zip(port.batches(2, epochs=2), ref.batches(2, epochs=2)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert a["pixel_values"].shape == (2, 1 if is_image else 4, 32, 32, 3)
    assert a["clip_ref_image"].shape == (2, 224, 224, 3)
    va, vb = port.validation_sample(1), ref.validation_sample(1)
    for k in vb:
        np.testing.assert_array_equal(va[k], vb[k])
    # where the original would loop without end, the copy refuses
    with pytest.raises(ValueError, match="2 videos for batches of 3"):
        next(port.batches(3))


def test_tracker_and_prefetch_equal_the_originals(tmp_path):
    import json

    from aniportrait_tpu.train import prefetch as jax_prefetch
    from aniportrait_tpu.train import trackers as jax_trackers
    from aniportrait_tpu_torch.train import prefetch as port_prefetch
    from aniportrait_tpu_torch.train import trackers as port_trackers

    recs = []
    for mod, name in ((port_trackers, "port"), (jax_trackers, "jax")):
        tracker = mod.Tracker(str(tmp_path / name), "exp", enable_tb=False)
        rec = tracker.log(3, {"loss": np.float32(0.25), "lr": 1e-5})
        tracker.close()
        line = json.loads((tmp_path / name / "train_log.jsonl").read_text())
        recs.append((set(rec), {k: v for k, v in line.items() if k != "elapsed_s"}))
    assert recs[0] == recs[1]

    def items():
        yield from range(5)
        raise KeyError("producer")

    for mod in (port_prefetch, jax_prefetch):
        got = []
        with pytest.raises(KeyError, match="producer"):
            for x in mod.prefetch(items(), depth=2):
                got.append(x)
        assert got == list(range(5))


@pytest.mark.parametrize("name", ["vid2pose", "generate_ref_pose", "prepare_video",
                                  "preprocess_dataset"])
def test_data_prep_scripts_are_copies_of_the_originals(name):
    """The port's data-preparation scripts are the JAX scripts' code with the
    port's utils and an ``argv`` for ``main`` (their outputs are held to the
    originals' in tests/test_torch_dataprep.py)."""
    def code(path, *swaps):
        text = path.read_text().split('"""', 2)[2]  # past the module docstring
        for a, b in swaps:
            text = text.replace(a, b)
        return text.strip()

    port = code(ROOT / "aniportrait_tpu_torch" / "scripts" / f"{name}.py")
    jax = code(ROOT / "scripts" / f"{name}.py",
               ("aniportrait_tpu.utils", "aniportrait_tpu_torch.utils"),
               ("def main():", "def main(argv=None):"),
               ("parser.parse_args()", "parser.parse_args(argv)"))
    assert port == jax
