"""Quality metrics, the quality gates and weight validation of the port
against the JAX package's, on the CPU.

``psnr``, ``ssim`` and ``check_regression`` are copies, held output for
output.  LPIPS: the port's ``nn.Module`` against JAX ``LPIPS`` on the same
random ``.npz`` (the one file format of both), 64x64, within
tests/test_quality.py's 2e-4 / 1e-3; ``convert_lpips_weights`` writes the
same file.  ``compare_videos`` and the gate CLI (frame directories written
with OpenCV) give the JAX package's reports; the bench's ``--quality``
forwards to the CLI.  ``check_bijection`` reports a dropped key, an extra key
and a wrong shape; ``validate_weights`` passes on micro-size checkpoint
files and fails naming a dropped key.  The port's full-size FiLM keys are
the JAX ``FilmInterpolator``'s through ``film_rules``.  The quality gate's
CLI gives the JAX script's rows at micro size, and its weights follow the
JAX gate's initializers (``factory.init_flax_defaults``).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from aniportrait_tpu.models.film_net import FilmInterpolator as JaxFilm
from aniportrait_tpu.utils import quality as jax_quality
from aniportrait_tpu.utils import quality_gate as jax_gate
from aniportrait_tpu.weights import convert as jax_convert
from aniportrait_tpu_torch import factory
from aniportrait_tpu_torch.audio.audio2mesh import Audio2MeshModel
from aniportrait_tpu_torch.audio.audio2pose import Audio2PoseModel
from aniportrait_tpu_torch.scripts import bench as port_bench
from aniportrait_tpu_torch.scripts import quality_gate as port_gate_cli
from aniportrait_tpu_torch.scripts import quality_speed_gate
from aniportrait_tpu_torch.scripts import validate_weights
from aniportrait_tpu_torch.utils import frame_interpolation as port_fi
from aniportrait_tpu_torch.utils import quality as port_quality
from aniportrait_tpu_torch.utils import quality_gate as port_gate
from aniportrait_tpu_torch.weights import validate
from scripts import quality_gate as jax_gate_cli
from test_torch_modules import one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ copies
@pytest.mark.parametrize("shape", [(32, 32), (32, 40, 3)], ids=["gray", "rgb"])
def test_psnr_and_ssim_equal_the_originals(shape):
    rs = np.random.RandomState(0)
    a = rs.randint(0, 256, shape).astype(np.uint8)
    b = np.clip(a + rs.randint(-9, 10, shape), 0, 255).astype(np.uint8)
    for fn in ("psnr", "ssim"):
        assert getattr(port_quality, fn)(a, b) == getattr(jax_quality, fn)(a, b)
    assert port_quality.psnr(a, a) == float("inf")
    np.testing.assert_array_equal(port_quality._gaussian_kernel(),
                                  jax_quality._gaussian_kernel())
    assert port_quality._ALEX_CONVS == jax_quality._ALEX_CONVS
    np.testing.assert_array_equal(port_quality._SHIFT, jax_quality._SHIFT)
    np.testing.assert_array_equal(port_quality._SCALE, jax_quality._SCALE)


GATE_ROWS = [
    [{"mode": "encoder cache k=2", "psnr": 37.0, "ssim": 0.9966}],
    [{"mode": "encoder cache k=2", "psnr": 35.0, "ssim": 0.9900}],
    [{"mode": "window fusion (motion=context)", "psnr": 46.0, "ssim": 0.9995},
     {"mode": "windowed exact (24f)", "psnr": None, "ssim": None},
     {"mode": "context rotate (per-step tables)", "psnr": 48.5, "ssim": 0.9950}],
    [{"mode": "unknown mode", "psnr": 1.0, "ssim": 0.1}],
]


@pytest.mark.parametrize("rows", GATE_ROWS, ids=["within", "regressed", "mixed", "unknown"])
@pytest.mark.parametrize("table", ["docs", "empty"])
def test_check_regression_equals_the_original(rows, table, tmp_path):
    table_dir = None if table == "docs" else str(tmp_path)
    got = port_gate.check_regression(rows, table_dir)
    assert got == jax_gate.check_regression(rows, table_dir)
    assert (port_gate.PSNR_REGRESSION_DB, port_gate.SSIM_REGRESSION) == (
        jax_gate.PSNR_REGRESSION_DB, jax_gate.SSIM_REGRESSION)
    if table == "docs" and rows is GATE_ROWS[1]:
        assert len(got) == 2 and "encoder cache k=2" in got[0]


# ------------------------------------------------------------------ LPIPS
def _rand_lpips_weights(path, seed=0):
    rs = np.random.RandomState(seed)
    w, cin = {}, 3
    for i, (cout, k, _, _) in enumerate(port_quality._ALEX_CONVS):
        w[f"conv{i}_w"] = rs.randn(k, k, cin, cout).astype(np.float32) * 0.05
        w[f"conv{i}_b"] = rs.randn(cout).astype(np.float32) * 0.05
        w[f"lin{i}"] = rs.rand(cout).astype(np.float32)
        cin = cout
    np.savez(path, **w)
    return str(path)


@pytest.fixture
def lpips_npz(tmp_path):
    return _rand_lpips_weights(tmp_path / "lpips.npz")


def test_lpips_matches_jax(lpips_npz):
    rs = np.random.RandomState(1)
    a = rs.rand(2, 64, 64, 3).astype(np.float32) * 2 - 1
    b = rs.rand(2, 64, 64, 3).astype(np.float32) * 2 - 1
    port = port_quality.LPIPS(lpips_npz, device="cpu")
    ref = jax_quality.LPIPS(lpips_npz)
    np.testing.assert_allclose(port(a, b), ref(a, b), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(port(a, a), np.zeros(2), atol=1e-6)
    u8 = [rs.randint(0, 256, (3, 64, 64, 3), np.uint8) for _ in range(2)]
    np.testing.assert_allclose(port(*u8), ref(*u8), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(port(torch.from_numpy(u8[0][0]), u8[1][0]),
                               ref(u8[0][0], u8[1][0]), atol=2e-4, rtol=1e-3)
    with pytest.raises(FileNotFoundError, match="convert_lpips_weights"):
        port_quality.LPIPS(lpips_npz + ".missing")


def test_convert_lpips_weights_writes_the_jax_file(tmp_path):
    rs = np.random.RandomState(2)
    alex, lin, cin = {}, {}, 3
    for i, (fidx, (cout, k, _, _)) in enumerate(zip((0, 3, 6, 8, 10),
                                                    port_quality._ALEX_CONVS)):
        alex[f"features.{fidx}.weight"] = torch.from_numpy(rs.randn(cout, cin, k, k)
                                                           .astype(np.float32))
        alex[f"features.{fidx}.bias"] = torch.from_numpy(rs.randn(cout).astype(np.float32))
        lin[f"lin{i}.model.1.weight"] = torch.from_numpy(rs.rand(1, cout, 1, 1)
                                                         .astype(np.float32))
        cin = cout
    torch.save(alex, tmp_path / "alex.pth")
    torch.save(lin, tmp_path / "lin.pth")
    for mod, name in ((port_quality, "port"), (jax_quality, "jax")):
        mod.convert_lpips_weights(str(tmp_path / "lin.pth"), str(tmp_path / "alex.pth"),
                                  str(tmp_path / f"{name}.npz"))
    port, ref = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(port.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(port[k], ref[k])


def test_compare_videos_and_gate_cli_match_jax(tmp_path, lpips_npz, capsys):
    cv2 = pytest.importorskip("cv2")
    rs = np.random.RandomState(2)
    vid = rs.randint(0, 255, (3, 64, 64, 3), np.uint8)
    noisy = np.clip(vid.astype(np.int32) + rs.randint(-5, 6, vid.shape), 0, 255
                    ).astype(np.uint8)
    rep = port_quality.compare_videos(vid, noisy)
    assert rep == jax_quality.compare_videos(vid, noisy) and "lpips" not in rep
    rep = port_quality.compare_videos(vid, noisy, lpips_npz, device="cpu")
    want = jax_quality.compare_videos(vid, noisy, lpips_npz)
    assert rep["lpips"] == pytest.approx(want["lpips"], rel=1e-3, abs=2e-4)
    with pytest.raises(ValueError, match="shape"):
        port_quality.compare_videos(vid, noisy[:2])

    ours_d, ref_d = tmp_path / "ours", tmp_path / "ref"
    ours_d.mkdir(), ref_d.mkdir()
    for i in range(3):
        cv2.imwrite(str(ours_d / f"{i:03d}.png"), vid[i])
        cv2.imwrite(str(ref_d / f"{i:03d}.png"), noisy[i])
    argv = [str(ours_d), str(ref_d), "--lpips-weights", lpips_npz]
    capsys.readouterr()
    assert jax_gate_cli.main([*argv, "--min-psnr", "30"]) == 0
    jax_report = json.loads(capsys.readouterr().out)
    out = tmp_path / "report.json"
    assert port_gate_cli.main([*argv, "--min-psnr", "30", "--device", "cpu",
                               "--out", str(out)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report == json.loads(out.read_text())
    assert {k: report[k] for k in ("psnr", "ssim", "frames")} == {
        k: jax_report[k] for k in ("psnr", "ssim", "frames")}
    assert report["lpips"] == pytest.approx(jax_report["lpips"], rel=1e-3, abs=2e-4)
    assert port_gate_cli.main([*argv, "--min-psnr", "99", "--device", "cpu"]) == 1
    assert port_gate_cli.main([*argv, "--max-lpips", "0", "--device", "cpu"]) == 1
    # the bench's --quality is the same CLI
    assert port_bench.main(["--quality", *argv, "--min-psnr", "99", "--device", "cpu"]) == 1
    assert port_bench.main(["--quality", str(ours_d), str(ref_d), "--min-psnr", "30"]) == 0


# ------------------------------------------------------- weight validation
def test_check_bijection_reports_each_kind_of_problem():
    want = {"a.weight": (4, 3), "a.bias": (4,), "b.weight": (2, 2)}
    assert validate.check_bijection(dict(want), want, "fam") == []
    got = {"a.weight": (4, 3), "a.bias": (5,), "c.weight": (1,)}
    problems = validate.check_bijection(got, want, "fam")
    assert len(problems) == 3
    assert "1 model params UNFILLED" in problems[0] and "b.weight" in problems[0]
    assert "1 converted paths not in the model" in problems[1] and "c.weight" in problems[1]
    assert "1 shape mismatches" in problems[2] and "a.bias" in problems[2]


def test_fullsize_film_keys_are_the_jax_models():
    """The port's full-size FiLM state dict, through ``film_rules``, fills
    the JAX ``FilmInterpolator``'s parameter tree key for key, shape for
    shape."""
    shapes = validate.fullsize_model_trees("full")["film"]
    state = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    params, unused = jax_convert.convert_film(state)
    assert not unused
    x = jnp.zeros((1, 64, 64, 3))
    tree = jax.eval_shape(lambda k: JaxFilm().init(k, x, x, jnp.full((1,), 0.5)),
                          jax.random.PRNGKey(0))["params"]

    def flat(t, prefix=""):
        out = {}
        for k, v in t.items():
            p = f"{prefix}/{k}" if prefix else k
            out.update(flat(v, p) if isinstance(v, dict) else {p: tuple(v.shape)})
        return out

    assert flat(params) == flat(tree)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 34436667


@pytest.fixture(scope="module")
def micro_zoo(tmp_path_factory):
    """Micro-size checkpoint files as the reference lays them out, and
    ``.py`` prompt configs naming them (micro-size audio models whose
    checkpoints hold their encoders; a traced micro FiLM)."""
    root = tmp_path_factory.mktemp("zoo")
    modules = factory.build_models("micro", "cpu", torch.float32, seed=3)
    paths = chip_smoke.write_checkpoints(modules, str(root))
    sizes = validate.AUDIO_SIZES["micro"]
    a2m = Audio2MeshModel(latent_dim=sizes["latent_dim"], wav2vec2=sizes["wav2vec2"]).eval()
    a2p = Audio2PoseModel(latent_dim=sizes["latent_dim"], num_layers=sizes["num_layers"],
                          heads=sizes["heads"], wav2vec2=sizes["wav2vec2"]).eval()
    audio = chip_smoke.write_audio_checkpoints(a2m, a2p, str(root))
    film = port_fi.random_film(0, **validate.FILM_SIZES["micro"]).eval()
    x = torch.rand(1, 3, 32, 32)
    with torch.no_grad():
        torch.jit.save(torch.jit.trace(film, (x, x, torch.full((1,), 0.5))),
                       str(root / "film.pt"))
    infer = chip_smoke.ENTRY_CONFIG["inference_config"]
    cfg = chip_smoke._py_config(str(root / "prompt.py"), inference_config=infer, **paths)
    audio_cfg = {k: dict(v) for k, v in chip_smoke.AUDIO_CONFIG["audio_inference_config"]
                 .items()}
    audio_cfg["pretrained_model"] = audio
    for k in ("a2m_model", "a2p_model"):
        audio_cfg[k]["model_path"] = str(root / "no_wav2vec2_folder")
    acfg = chip_smoke._py_config(str(root / "audio.py"), audio_inference_config=audio_cfg)
    return root, cfg, acfg, paths


def test_validate_weights_passes_on_a_complete_zoo(micro_zoo, capsys):
    root, cfg, acfg, _ = micro_zoo
    argv = ["--config", cfg, "--audio-config", acfg, "--film", str(root / "film.pt"),
            "--size", "micro"]
    assert validate_weights.main(argv) == 0
    out = capsys.readouterr().out
    for family in ("vae", "clip", "reference_unet", "denoising_unet", "pose_guider",
                   "audio2mesh", "audio2pose", "film"):
        assert f"checked {family}: OK" in out


def test_validate_weights_fails_naming_a_dropped_key(micro_zoo, tmp_path, capsys):
    root, cfg, acfg, paths = micro_zoo
    state = torch.load(paths["pose_guider_path"], weights_only=True)
    dropped = sorted(state)[0]
    del state[dropped]
    torch.save(state, tmp_path / "pose_guider.pth")
    bad = chip_smoke._py_config(str(tmp_path / "prompt.py"),
                     inference_config=chip_smoke.ENTRY_CONFIG["inference_config"],
                     **{**paths, "pose_guider_path": str(tmp_path / "pose_guider.pth")})
    assert validate_weights.main(["--config", bad, "--size", "micro"]) == 1
    out = capsys.readouterr().out
    assert "VALIDATION FAILED" in out and dropped in out and "pose_guider" in out
    # the full-size models refuse the micro files
    assert validate_weights.main(["--config", cfg]) == 1


# ------------------------------------------------------ quality_speed_gate
def test_quality_speed_gate_rows_at_micro_size(tmp_path, capsys):
    """The gate's rows at micro size, 64 px, 2 steps on the CPU: the JAX
    script's modes; finite dB for the encoder cache; with the JAX gate's
    weights the motion modules start as the identity, so in float32 window
    fusion and rotation give the exact path's frames (infinite PSNR);
    ``--check`` holds the rows to the stored full-size table, which the
    micro model's encoder cache misses (exit 1)."""
    out = tmp_path / "rows.json"
    argv = ["--size", "micro", "--device", "cpu", "--res", "64", "--steps", "2",
            "--frames", "4", "--win-frames", "20", "--out", str(out)]
    assert quality_speed_gate.main(argv) == 0
    rows = json.loads(out.read_text())
    assert [r["mode"] for r in rows] == [
        "pose2vid exact (k=1)", "encoder cache k=2", "encoder cache k=3",
        "windowed exact (20f)", "window fusion (motion=context)",
        "window fusion (auto: whole-clip)", "context rotate (per-step tables)"]
    for r in rows:
        assert r["fps"] > 0
        if "exact" in r["mode"]:
            assert r["psnr"] is None and r["ssim"] is None
        elif "encoder cache" in r["mode"]:
            assert 10 < r["psnr"] < 100 and 0 < r["ssim"] < 1
        else:
            assert r["psnr"] == float("inf") and r["ssim"] == 1.0
    assert "| window fusion (motion=context) |" in capsys.readouterr().out
    assert quality_speed_gate.main([*argv, "--skip-fusion", "--check"]) == 1
    assert "encoder cache k=2: PSNR regressed" in capsys.readouterr().err


def test_gate_weights_follow_the_jax_gates_initializers():
    """``factory.init_flax_defaults`` (the quality gate's weights) draws
    the denoising UNet and the PoseGuider by the rule of the JAX gate's
    ``init_random_params``: the same parameters zero (the motion modules'
    ``proj_out``, the PoseGuider's ``final_proj``, biases), the same
    constants, and every other tensor of 1024 or more draws with a spread
    within 20 % of JAX's."""
    from aniportrait_tpu.factory import build_model_defs, pose_feature_shapes
    from aniportrait_tpu.factory import SIZES as JAX_SIZES
    from aniportrait_tpu_torch.weights import convert as cv

    defs = build_model_defs(size="micro", use_motion_module=True)
    key = jax.random.PRNGKey(0)
    x1, t = jnp.zeros((1, 1, 8, 8, 4)), jnp.zeros((1,), jnp.int32)
    ctx = jnp.zeros((1, 1, JAX_SIZES["micro"]["clip"]["projection_dim"]))
    fea = [jnp.zeros(s) for s in pose_feature_shapes(JAX_SIZES["micro"], 1, 1, 8)]
    jax_trees = {
        "denoising_unet": (cv.unet_rules(), jax.jit(lambda k: defs["denoising_unet"].init(
            k, x1, t, ctx, pose_cond_fea=fea))(key)["params"]),
        "pose_guider": (cv.pose_guider_rules(), jax.jit(defs["pose_guider"].init)(
            key, jnp.zeros((1, 1, 64, 64, 3)))["params"]),
    }
    modules = factory.build_models("micro", "cpu", torch.float32, seed=0,
                                   init=factory.init_flax_defaults)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            out.update(flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
        return out

    for name, (rules, jax_params) in jax_trees.items():
        params, _, _ = cv.apply_rules(getattr(modules, name).state_dict(), rules)
        port, ref = flat(params), flat(jax_params)
        assert set(port) == set(ref)
        for k, want in ref.items():
            got = port[k]
            if want.std() == 0:
                np.testing.assert_array_equal(got, want, err_msg=k)
            elif got.size >= 1024:  # enough draws for the spread to show the rule
                assert 0.8 < got.std() / want.std() < 1.25, (k, got.std(), want.std())
            else:
                assert got.std() > 0, k
    assert not modules.denoising_unet.down_blocks[0].motion_modules[0] \
        .temporal_transformer.proj_out.weight.any()
