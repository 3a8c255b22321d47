"""The port's own copies of numpy-only modules of the JAX package equal the
originals: the weight-naming rules (weights/convert.py) key for key and
transform for transform, in order, and the context-window tables
(pipelines/context.py) entry for entry."""

import numpy as np
import pytest

from aniportrait_tpu.pipelines import context as jax_context
from aniportrait_tpu.weights import convert as jax_convert
from aniportrait_tpu_torch.pipelines import context as port_context
from aniportrait_tpu_torch.weights import convert as port_convert

RULE_LISTS = [
    ("unet_rules", ()),
    ("vae_rules", ()),
    ("clip_vision_rules", ()),
    ("pose_guider_rules", ()),
    ("_attention_block_rules", (r"down_blocks\.0\.attentions\.1", "attn_down_0_1")),
    ("_resnet_rules", (r"mid_block\.resnets\.0", "mid_resnet_0")),
    ("_motion_rules", (r"up_blocks\.1\.motion_modules\.2", "up_1_motion_2")),
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


@pytest.mark.parametrize("length,frames,stride,overlap",
                         [(24, 8, 3, 2), (16, 16, 1, 4), (40, 12, 2, 3)])
def test_context_windows_equal_the_originals(length, frames, stride, overlap):
    for step in range(4):
        port = port_context.uniform_context_windows(step, length, frames, stride, overlap)
        ref = jax_context.uniform_context_windows(step, length, frames, stride, overlap)
        np.testing.assert_array_equal(port, ref)
