"""torch <-> flax naming rules of the AniPortrait checkpoints, the port's
own copy.

The same rules as the JAX package's ``aniportrait_tpu/weights/convert.py``
(UNet with motion modules, VAE, CLIP vision tower, PoseGuider, the audio
models: wav2vec2 with its weight-normed positional conv, the Audio2Mesh and
Audio2Pose heads, and the FiLM frame interpolator), kept here so that the port imports nothing of that
package.  Each rule is
``(torch key regex, flax path template, layout transform)``; a template
``skip`` marks a key without a flax counterpart and ``stats:`` one that lives
in the BatchNorm ``batch_stats`` collection.  ``weights/from_jax.py`` applies
the inverse transforms.

Layout transforms (torch -> flax):
  Linear   (O, I)        -> kernel (I, O)
  Conv2d   (O, I, kh, kw)-> kernel (kh, kw, I, O)
  Conv1x1 used as Dense  -> kernel (I, O)
  Conv1d   (O, I/g, K)   -> kernel (K, I/g, O)
  Norm weight/bias       -> scale/bias
  BatchNorm running stats-> batch_stats collection (mean/var)
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Tuple

import numpy as np


# ---------------------------------------------------------------- primitives
def to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t.astype(np.float32)
    # torch tensor
    return t.detach().to("cpu").float().numpy()


def t_linear(w):
    return w.T


def t_conv2d(w):
    return w.transpose(2, 3, 1, 0)


def t_conv1x1_dense(w):
    return w[:, :, 0, 0].T


def t_conv1d(w):
    return w.transpose(2, 1, 0)


def t_none(w):
    return w


def set_in(tree: Dict, path: str, value: np.ndarray):
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


Rule = Tuple[str, str, Callable]  # (regex, flax-path template, transform)


def apply_rules(
    sd: Dict[str, Any], rules: List[Rule], strict_unused: bool = False
) -> Tuple[Dict, Dict, List[str]]:
    """Run rename rules over a torch state dict.

    Returns (params_tree, batch_stats_tree, unused_keys).  Rules whose
    template starts with ``stats:`` write to the batch_stats tree; template
    ``skip`` drops the key.
    """
    params: Dict = {}
    stats: Dict = {}
    unused: List[str] = []
    compiled = [(re.compile(pat), tmpl, tf) for pat, tmpl, tf in rules]
    for key, val in sd.items():
        for creg, tmpl, tf in compiled:
            m = creg.fullmatch(key)
            if m is None:
                continue
            if tmpl == "skip":
                break
            path = m.expand(tmpl)
            arr = tf(to_numpy(val))
            if path.startswith("stats:"):
                set_in(stats, path[len("stats:"):], arr)
            else:
                set_in(params, path, arr)
            break
        else:
            unused.append(key)
    if strict_unused and unused:
        raise ValueError(f"unconverted keys: {unused[:20]} (+{len(unused)-20} more)"
                         if len(unused) > 20 else f"unconverted keys: {unused}")
    return params, stats, unused


# ------------------------------------------------------- shared sub-patterns
def _attention_block_rules(torch_prefix: str, flax_prefix: str) -> List[Rule]:
    """Rules for one diffusers Transformer2D/3D 'attentions.N' module ->
    our SpatialTransformer."""
    tp, fp = torch_prefix, flax_prefix
    return [
        (rf"{tp}\.norm\.weight", f"{fp}/norm_scale", t_none),
        (rf"{tp}\.norm\.bias", f"{fp}/norm_bias", t_none),
        (rf"{tp}\.proj_in\.weight", f"{fp}/proj_in/kernel", t_conv1x1_dense),
        (rf"{tp}\.proj_in\.bias", f"{fp}/proj_in/bias", t_none),
        (rf"{tp}\.proj_out\.weight", f"{fp}/proj_out/kernel", t_conv1x1_dense),
        (rf"{tp}\.proj_out\.bias", f"{fp}/proj_out/bias", t_none),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.norm([123])\.(weight)",
            f"{fp}/block_\\1/norm\\2/scale",
            t_none,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.norm([123])\.(bias)",
            f"{fp}/block_\\1/norm\\2/bias",
            t_none,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.attn([12])\.to_([qkv])\.weight",
            f"{fp}/block_\\1/attn\\2/to_\\3/kernel",
            t_linear,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.attn([12])\.to_out\.0\.weight",
            f"{fp}/block_\\1/attn\\2/to_out_0/kernel",
            t_linear,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.attn([12])\.to_out\.0\.bias",
            f"{fp}/block_\\1/attn\\2/to_out_0/bias",
            t_none,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.ff\.net\.0\.proj\.weight",
            f"{fp}/block_\\1/ff/net_0/proj/kernel",
            t_linear,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.ff\.net\.0\.proj\.bias",
            f"{fp}/block_\\1/ff/net_0/proj/bias",
            t_none,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.ff\.net\.2\.weight",
            f"{fp}/block_\\1/ff/net_2/kernel",
            t_linear,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.ff\.net\.2\.bias",
            f"{fp}/block_\\1/ff/net_2/bias",
            t_none,
        ),
    ]


def _resnet_rules(torch_prefix: str, flax_prefix: str) -> List[Rule]:
    tp, fp = torch_prefix, flax_prefix
    return [
        (rf"{tp}\.norm([12])\.weight", f"{fp}/norm\\1/scale", t_none),
        (rf"{tp}\.norm([12])\.bias", f"{fp}/norm\\1/bias", t_none),
        (rf"{tp}\.conv([12])\.weight", f"{fp}/conv\\1/conv/kernel", t_conv2d),
        (rf"{tp}\.conv([12])\.bias", f"{fp}/conv\\1/conv/bias", t_none),
        (rf"{tp}\.time_emb_proj\.weight", f"{fp}/time_emb_proj/kernel", t_linear),
        (rf"{tp}\.time_emb_proj\.bias", f"{fp}/time_emb_proj/bias", t_none),
        (rf"{tp}\.conv_shortcut\.weight", f"{fp}/conv_shortcut/conv/kernel", t_conv2d),
        (rf"{tp}\.conv_shortcut\.bias", f"{fp}/conv_shortcut/conv/bias", t_none),
    ]


def _motion_rules(torch_prefix: str, flax_prefix: str) -> List[Rule]:
    tp = torch_prefix + r"\.temporal_transformer"
    fp = flax_prefix
    return [
        (rf"{tp}\.norm\.weight", f"{fp}/norm_scale", t_none),
        (rf"{tp}\.norm\.bias", f"{fp}/norm_bias", t_none),
        (rf"{tp}\.proj_in\.weight", f"{fp}/proj_in/kernel", t_linear),
        (rf"{tp}\.proj_in\.bias", f"{fp}/proj_in/bias", t_none),
        (rf"{tp}\.proj_out\.weight", f"{fp}/proj_out/kernel", t_linear),
        (rf"{tp}\.proj_out\.bias", f"{fp}/proj_out/bias", t_none),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.attention_blocks\.(\d+)\.to_([qkv])\.weight",
            f"{fp}/block_\\1/attn_\\2/to_\\3/kernel",
            t_linear,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.attention_blocks\.(\d+)\.to_out\.0\.weight",
            f"{fp}/block_\\1/attn_\\2/to_out_0/kernel",
            t_linear,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.attention_blocks\.(\d+)\.to_out\.0\.bias",
            f"{fp}/block_\\1/attn_\\2/to_out_0/bias",
            t_none,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.attention_blocks\.\d+\.pos_encoder\.pe",
            "skip",
            t_none,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.norms\.(\d+)\.weight",
            f"{fp}/block_\\1/norm_\\2/scale",
            t_none,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.norms\.(\d+)\.bias",
            f"{fp}/block_\\1/norm_\\2/bias",
            t_none,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.ff\.net\.0\.proj\.weight",
            f"{fp}/block_\\1/ff/net_0/proj/kernel",
            t_linear,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.ff\.net\.0\.proj\.bias",
            f"{fp}/block_\\1/ff/net_0/proj/bias",
            t_none,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.ff\.net\.2\.weight",
            f"{fp}/block_\\1/ff/net_2/kernel",
            t_linear,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.ff\.net\.2\.bias",
            f"{fp}/block_\\1/ff/net_2/bias",
            t_none,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.ff_norm\.weight",
            f"{fp}/block_\\1/ff_norm/scale",
            t_none,
        ),
        (
            rf"{tp}\.transformer_blocks\.(\d+)\.ff_norm\.bias",
            f"{fp}/block_\\1/ff_norm/bias",
            t_none,
        ),
    ]


# ----------------------------------------------------------------- UNet
def unet_rules() -> List[Rule]:
    rules: List[Rule] = [
        (r"conv_in\.weight", "conv_in/conv/kernel", t_conv2d),
        (r"conv_in\.bias", "conv_in/conv/bias", t_none),
        (r"time_embedding\.linear_([12])\.weight", "time_embedding/linear_\\1/kernel", t_linear),
        (r"time_embedding\.linear_([12])\.bias", "time_embedding/linear_\\1/bias", t_none),
        (r"conv_norm_out\.weight", "conv_norm_out/scale", t_none),
        (r"conv_norm_out\.bias", "conv_norm_out/bias", t_none),
        (r"conv_out\.weight", "conv_out/conv/kernel", t_conv2d),
        (r"conv_out\.bias", "conv_out/conv/bias", t_none),
        # Down/Upsample3D wrap an InflatedConv (itself containing nn.Conv
        # 'conv'): flax path is <name>/conv/conv/*
        (
            r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.weight",
            "down_\\1_downsample/conv/conv/kernel",
            t_conv2d,
        ),
        (
            r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.bias",
            "down_\\1_downsample/conv/conv/bias",
            t_none,
        ),
        (
            r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.weight",
            "up_\\1_upsample/conv/conv/kernel",
            t_conv2d,
        ),
        (
            r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.bias",
            "up_\\1_upsample/conv/conv/bias",
            t_none,
        ),
    ]
    for i in range(4):
        for j in range(3):
            rules += _resnet_rules(
                rf"down_blocks\.{i}\.resnets\.{j}", f"down_{i}_resnet_{j}"
            )
            rules += _resnet_rules(rf"up_blocks\.{i}\.resnets\.{j}", f"up_{i}_resnet_{j}")
            rules += _attention_block_rules(
                rf"down_blocks\.{i}\.attentions\.{j}", f"attn_down_{i}_{j}"
            )
            rules += _attention_block_rules(
                rf"up_blocks\.{i}\.attentions\.{j}", f"attn_up_{i}_{j}"
            )
            rules += _motion_rules(
                rf"down_blocks\.{i}\.motion_modules\.{j}", f"down_{i}_motion_{j}"
            )
            rules += _motion_rules(
                rf"up_blocks\.{i}\.motion_modules\.{j}", f"up_{i}_motion_{j}"
            )
    for j in range(2):
        rules += _resnet_rules(rf"mid_block\.resnets\.{j}", f"mid_resnet_{j}")
    rules += _attention_block_rules(r"mid_block\.attentions\.0", "attn_mid_0")
    rules += _motion_rules(r"mid_block\.motion_modules\.0", "mid_motion_0")
    # non-parametric / removed-head leftovers
    rules += [
        (r"time_proj\..*", "skip", t_none),
        (r".*attn_temp.*", "skip", t_none),
        (r".*norm_temp.*", "skip", t_none),
    ]
    return rules



# ----------------------------------------------------------------- VAE
def _vae_resnet_rules(tp: str, fp: str) -> List[Rule]:
    return [
        (rf"{tp}\.norm([12])\.weight", f"{fp}/norm\\1/scale", t_none),
        (rf"{tp}\.norm([12])\.bias", f"{fp}/norm\\1/bias", t_none),
        (rf"{tp}\.conv([12])\.weight", f"{fp}/conv\\1/kernel", t_conv2d),
        (rf"{tp}\.conv([12])\.bias", f"{fp}/conv\\1/bias", t_none),
        (rf"{tp}\.conv_shortcut\.weight", f"{fp}/conv_shortcut/kernel", t_conv2d),
        (rf"{tp}\.conv_shortcut\.bias", f"{fp}/conv_shortcut/bias", t_none),
    ]


def vae_rules() -> List[Rule]:
    rules: List[Rule] = []
    for side in ("encoder", "decoder"):
        rules += [
            (rf"{side}\.conv_in\.weight", f"{side}/conv_in/kernel", t_conv2d),
            (rf"{side}\.conv_in\.bias", f"{side}/conv_in/bias", t_none),
            (rf"{side}\.conv_norm_out\.weight", f"{side}/conv_norm_out/scale", t_none),
            (rf"{side}\.conv_norm_out\.bias", f"{side}/conv_norm_out/bias", t_none),
            (rf"{side}\.conv_out\.weight", f"{side}/conv_out/kernel", t_conv2d),
            (rf"{side}\.conv_out\.bias", f"{side}/conv_out/bias", t_none),
        ]
        for j in range(2):
            rules += _vae_resnet_rules(
                rf"{side}\.mid_block\.resnets\.{j}", f"{side}/mid/resnet_{j}"
            )
        # mid attention (diffusers >=0.17 'to_*' names and legacy names)
        for t_name, f_name in (
            ("group_norm", "group_norm"),
            ("to_q", "to_q"),
            ("to_k", "to_k"),
            ("to_v", "to_v"),
            ("query", "to_q"),
            ("key", "to_k"),
            ("value", "to_v"),
        ):
            rules += [
                (
                    rf"{side}\.mid_block\.attentions\.0\.{t_name}\.weight",
                    f"{side}/mid/attn_0/{f_name}/"
                    + ("scale" if f_name == "group_norm" else "kernel"),
                    t_none if f_name == "group_norm" else t_linear,
                ),
                (
                    rf"{side}\.mid_block\.attentions\.0\.{t_name}\.bias",
                    f"{side}/mid/attn_0/{f_name}/bias",
                    t_none,
                ),
            ]
        rules += [
            (
                rf"{side}\.mid_block\.attentions\.0\.(to_out\.0|proj_attn)\.weight",
                f"{side}/mid/attn_0/to_out_0/kernel",
                t_linear,
            ),
            (
                rf"{side}\.mid_block\.attentions\.0\.(to_out\.0|proj_attn)\.bias",
                f"{side}/mid/attn_0/to_out_0/bias",
                t_none,
            ),
        ]
    for i in range(4):
        for j in range(2):
            rules += _vae_resnet_rules(
                rf"encoder\.down_blocks\.{i}\.resnets\.{j}", f"encoder/down_{i}_resnet_{j}"
            )
        for j in range(3):
            rules += _vae_resnet_rules(
                rf"decoder\.up_blocks\.{i}\.resnets\.{j}", f"decoder/up_{i}_resnet_{j}"
            )
        rules += [
            (
                rf"encoder\.down_blocks\.{i}\.downsamplers\.0\.conv\.weight",
                f"encoder/down_{i}_downsample/kernel",
                t_conv2d,
            ),
            (
                rf"encoder\.down_blocks\.{i}\.downsamplers\.0\.conv\.bias",
                f"encoder/down_{i}_downsample/bias",
                t_none,
            ),
            (
                rf"decoder\.up_blocks\.{i}\.upsamplers\.0\.conv\.weight",
                f"decoder/up_{i}_upsample/kernel",
                t_conv2d,
            ),
            (
                rf"decoder\.up_blocks\.{i}\.upsamplers\.0\.conv\.bias",
                f"decoder/up_{i}_upsample/bias",
                t_none,
            ),
        ]
    rules += [
        (r"quant_conv\.weight", "quant_conv/kernel", t_conv2d),
        (r"quant_conv\.bias", "quant_conv/bias", t_none),
        (r"post_quant_conv\.weight", "post_quant_conv/kernel", t_conv2d),
        (r"post_quant_conv\.bias", "post_quant_conv/bias", t_none),
    ]
    return rules



# ----------------------------------------------------------------- CLIP
def clip_vision_rules() -> List[Rule]:
    p = r"vision_model\."
    return [
        (rf"{p}embeddings\.class_embedding", "class_embedding", t_none),
        (
            rf"{p}embeddings\.patch_embedding\.weight",
            "patch_embedding/kernel",
            t_conv2d,
        ),
        (rf"{p}embeddings\.position_embedding\.weight", "position_embedding", t_none),
        (rf"{p}pre_layrnorm\.weight", "pre_layrnorm/scale", t_none),
        (rf"{p}pre_layrnorm\.bias", "pre_layrnorm/bias", t_none),
        (rf"{p}post_layernorm\.weight", "post_layernorm/scale", t_none),
        (rf"{p}post_layernorm\.bias", "post_layernorm/bias", t_none),
        (
            rf"{p}encoder\.layers\.(\d+)\.self_attn\.([qkv]|out)_proj\.weight",
            "layer_\\1/\\2_proj/kernel",
            t_linear,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.self_attn\.([qkv]|out)_proj\.bias",
            "layer_\\1/\\2_proj/bias",
            t_none,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.layer_norm([12])\.weight",
            "layer_\\1/layer_norm\\2/scale",
            t_none,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.layer_norm([12])\.bias",
            "layer_\\1/layer_norm\\2/bias",
            t_none,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.mlp\.fc([12])\.weight",
            "layer_\\1/fc\\2/kernel",
            t_linear,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.mlp\.fc([12])\.bias",
            "layer_\\1/fc\\2/bias",
            t_none,
        ),
        (r"visual_projection\.weight", "visual_projection/kernel", t_linear),
        (r"embeddings\.position_ids", "skip", t_none),
        (rf"{p}embeddings\.position_ids", "skip", t_none),
    ]



# ------------------------------------------------------------ pose guider
def pose_guider_rules() -> List[Rule]:
    rules: List[Rule] = []
    stem_conv_idx = [0, 3, 6, 9, 12, 15, 18, 21]
    for k, idx in enumerate(stem_conv_idx):
        rules += _conv_bn_rules(rf"conv_layers\.{idx}", rf"conv_layers\.{idx + 1}", f"stem_{k}")
    for n, (flax_i, n_convs) in enumerate([(0, 2), (1, 2), (2, 2), (3, 1)]):
        for j in range(n_convs):
            rules += _conv_bn_rules(
                rf"conv_layers_{n + 1}\.{3 * j}",
                rf"conv_layers_{n + 1}\.{3 * j + 1}",
                f"pyr_{flax_i}_{j}",
            )
    rules += [
        (r"final_proj\.weight", "final_proj/kernel", t_conv2d),
        (r"final_proj\.bias", "final_proj/bias", t_none),
        (r"scale", "scale", t_none),
    ]
    for n in range(1, 5):
        fp = f"cross_attn_{n}"
        rules += [
            (rf"cross_attn{n}\.norm\.weight", f"{fp}/norm_scale", t_none),
            (rf"cross_attn{n}\.norm\.bias", f"{fp}/norm_bias", t_none),
            (rf"cross_attn{n}\.proj_in\.weight", f"{fp}/proj_in/kernel", t_conv1x1_dense),
            (rf"cross_attn{n}\.proj_in\.bias", f"{fp}/proj_in/bias", t_none),
            (rf"cross_attn{n}\.proj_out\.weight", f"{fp}/proj_out/kernel", t_conv1x1_dense),
            (rf"cross_attn{n}\.proj_out\.bias", f"{fp}/proj_out/bias", t_none),
        ] + _attention_block_rules(rf"cross_attn{n}", fp)[6:]
    return rules


def _conv_bn_rules(conv_tp: str, bn_tp: str, fp: str) -> List[Rule]:
    return [
        (rf"{conv_tp}\.weight", f"{fp}/conv/kernel", t_conv2d),
        (rf"{conv_tp}\.bias", f"{fp}/conv/bias", t_none),
        (rf"{bn_tp}\.weight", f"{fp}/bn/scale", t_none),
        (rf"{bn_tp}\.bias", f"{fp}/bn/bias", t_none),
        (rf"{bn_tp}\.running_mean", f"stats:{fp}/bn/mean", t_none),
        (rf"{bn_tp}\.running_var", f"stats:{fp}/bn/var", t_none),
        (rf"{bn_tp}\.num_batches_tracked", "skip", t_none),
    ]


# ----------------------------------------------------------------- FiLM
def film_rules() -> List[Rule]:
    """FiLM frame-interpolation net (``film_net_fp16.pt``; dajes/
    frame-interpolation-pytorch module layout, the names of
    ``models/film_net.py``).  TorchScript blobs expose the same state_dict
    keys via ``.state_dict()`` after ``torch.jit.load``."""
    return [
        (r"extract\.extract_sublevels\.convs\.(\d+)\.([01])\.weight",
         r"extract/sub/conv_\1_\2/kernel", t_conv2d),
        (r"extract\.extract_sublevels\.convs\.(\d+)\.([01])\.bias",
         r"extract/sub/conv_\1_\2/bias", t_none),
        (r"predict_flow\.predictors\.(\d+)\.convs\.(\d+)\.weight",
         r"predict_flow/predictor_\1/conv_\2/kernel", t_conv2d),
        (r"predict_flow\.predictors\.(\d+)\.convs\.(\d+)\.bias",
         r"predict_flow/predictor_\1/conv_\2/bias", t_none),
        (r"predict_flow\.predictors\.(\d+)\.conv_bottleneck\.weight",
         r"predict_flow/predictor_\1/conv_bottleneck/kernel", t_conv2d),
        (r"predict_flow\.predictors\.(\d+)\.conv_bottleneck\.bias",
         r"predict_flow/predictor_\1/conv_bottleneck/bias", t_none),
        (r"predict_flow\.predictors\.(\d+)\.conv_out\.weight",
         r"predict_flow/predictor_\1/conv_out/kernel", t_conv2d),
        (r"predict_flow\.predictors\.(\d+)\.conv_out\.bias",
         r"predict_flow/predictor_\1/conv_out/bias", t_none),
        (r"predict_flow\.shared_predictor\.convs\.(\d+)\.weight",
         r"predict_flow/predictor_shared/conv_\1/kernel", t_conv2d),
        (r"predict_flow\.shared_predictor\.convs\.(\d+)\.bias",
         r"predict_flow/predictor_shared/conv_\1/bias", t_none),
        (r"predict_flow\.shared_predictor\.conv_bottleneck\.weight",
         r"predict_flow/predictor_shared/conv_bottleneck/kernel", t_conv2d),
        (r"predict_flow\.shared_predictor\.conv_bottleneck\.bias",
         r"predict_flow/predictor_shared/conv_bottleneck/bias", t_none),
        (r"predict_flow\.shared_predictor\.conv_out\.weight",
         r"predict_flow/predictor_shared/conv_out/kernel", t_conv2d),
        (r"predict_flow\.shared_predictor\.conv_out\.bias",
         r"predict_flow/predictor_shared/conv_out/bias", t_none),
        (r"fuse\.up_convs\.(\d+)\.weight", r"fuse/up_conv_\1/kernel", t_conv2d),
        (r"fuse\.up_convs\.(\d+)\.bias", r"fuse/up_conv_\1/bias", t_none),
        (r"fuse\.convs\.(\d+)\.([01])\.weight", r"fuse/conv_\1_\2/kernel",
         t_conv2d),
        (r"fuse\.convs\.(\d+)\.([01])\.bias", r"fuse/conv_\1_\2/bias", t_none),
        (r"fuse\.output_conv\.weight", r"fuse/output_conv/kernel", t_conv2d),
        (r"fuse\.output_conv\.bias", r"fuse/output_conv/bias", t_none),
    ]


def convert_film(sd: Dict[str, Any]) -> Tuple[Dict, List[str]]:
    params, _, unused = apply_rules(sd, film_rules())
    return params, unused


# --------------------------------------------------------------- wav2vec2
def wav2vec2_rules(prefix: str = "") -> List[Rule]:
    p = re.escape(prefix)
    rules: List[Rule] = [
        (
            rf"{p}feature_extractor\.conv_layers\.(\d+)\.conv\.weight",
            "feature_extractor/conv_\\1/kernel",
            t_conv1d,
        ),
        (
            rf"{p}feature_extractor\.conv_layers\.0\.layer_norm\.weight",
            "feature_extractor/gn_scale",
            t_none,
        ),
        (
            rf"{p}feature_extractor\.conv_layers\.0\.layer_norm\.bias",
            "feature_extractor/gn_bias",
            t_none,
        ),
        (rf"{p}feature_projection\.layer_norm\.weight", "fp_layer_norm/scale", t_none),
        (rf"{p}feature_projection\.layer_norm\.bias", "fp_layer_norm/bias", t_none),
        (rf"{p}feature_projection\.projection\.weight", "fp_projection/kernel", t_linear),
        (rf"{p}feature_projection\.projection\.bias", "fp_projection/bias", t_none),
        (rf"{p}encoder\.pos_conv_embed\.conv\.bias", "pos_conv/bias", t_none),
        (rf"{p}encoder\.layer_norm\.weight", "encoder_layer_norm/scale", t_none),
        (rf"{p}encoder\.layer_norm\.bias", "encoder_layer_norm/bias", t_none),
        (
            rf"{p}encoder\.layers\.(\d+)\.attention\.([qkv]|out)_proj\.weight",
            "layer_\\1/\\2_proj/kernel",
            t_linear,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.attention\.([qkv]|out)_proj\.bias",
            "layer_\\1/\\2_proj/bias",
            t_none,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.layer_norm\.weight",
            "layer_\\1/layer_norm/scale",
            t_none,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.layer_norm\.bias",
            "layer_\\1/layer_norm/bias",
            t_none,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.feed_forward\.intermediate_dense\.weight",
            "layer_\\1/fc1/kernel",
            t_linear,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.feed_forward\.intermediate_dense\.bias",
            "layer_\\1/fc1/bias",
            t_none,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.feed_forward\.output_dense\.weight",
            "layer_\\1/fc2/kernel",
            t_linear,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.feed_forward\.output_dense\.bias",
            "layer_\\1/fc2/bias",
            t_none,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.final_layer_norm\.weight",
            "layer_\\1/final_layer_norm/scale",
            t_none,
        ),
        (
            rf"{p}encoder\.layers\.(\d+)\.final_layer_norm\.bias",
            "layer_\\1/final_layer_norm/bias",
            t_none,
        ),
        (rf"{p}masked_spec_embed", "skip", t_none),
        (rf"{p}quantizer\..*", "skip", t_none),
        (rf"{p}project_q\..*", "skip", t_none),
        (rf"{p}project_hid\..*", "skip", t_none),
    ]
    return rules


def merge_pos_conv_weight_norm(sd: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Fold the weight-normed positional conv (weight_g/weight_v, or
    parametrizations.weight.original0/1) into a single conv kernel."""
    sd = dict(sd)
    base = f"{prefix}encoder.pos_conv_embed.conv"
    pairs = [
        (f"{base}.weight_g", f"{base}.weight_v"),
        (
            f"{base}.parametrizations.weight.original0",
            f"{base}.parametrizations.weight.original1",
        ),
    ]
    for g_key, v_key in pairs:
        if g_key in sd:
            g = to_numpy(sd.pop(g_key))
            v = to_numpy(sd.pop(v_key))
            # torch weight_norm(dim=2): norm over dims (0, 1); guard the
            # all-zero column case (v == 0 -> weight 0, not NaN)
            norm = np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))
            sd[f"{base}.weight"] = g * v / np.where(norm == 0.0, 1.0, norm)
    return sd


def convert_wav2vec2(sd: Dict[str, Any], prefix: str = "") -> Tuple[Dict, List[str]]:
    sd = merge_pos_conv_weight_norm(sd, prefix)
    rules = wav2vec2_rules(prefix) + [
        (re.escape(prefix) + r"encoder\.pos_conv_embed\.conv\.weight", "pos_conv/kernel", t_conv1d),
    ]
    params, _, unused = apply_rules(sd, rules)
    return params, unused


# ------------------------------------------------------------- audio heads
def convert_audio2mesh(sd: Dict[str, Any]) -> Tuple[Dict, List[str]]:
    enc_params, unused_enc = convert_wav2vec2(
        {k: v for k, v in sd.items() if k.startswith("audio_encoder.")},
        prefix="audio_encoder.",
    )
    head_rules: List[Rule] = [
        (r"in_fn\.weight", "in_fn/kernel", t_linear),
        (r"in_fn\.bias", "in_fn/bias", t_none),
        (r"out_fn\.weight", "out_fn/kernel", t_linear),
        (r"out_fn\.bias", "out_fn/bias", t_none),
    ]
    params, _, unused = apply_rules(
        {k: v for k, v in sd.items() if not k.startswith("audio_encoder.")}, head_rules
    )
    params["audio_encoder"] = enc_params
    return params, unused + unused_enc


def _split_in_proj(sd: Dict[str, Any], base: str):
    """torch MultiheadAttention packed in_proj -> (q, k, v) arrays."""
    w = to_numpy(sd[f"{base}.in_proj_weight"])
    b = to_numpy(sd[f"{base}.in_proj_bias"])
    d = w.shape[0] // 3
    return (w[:d], w[d : 2 * d], w[2 * d :]), (b[:d], b[d : 2 * d], b[2 * d :])


def convert_audio2pose(sd: Dict[str, Any], num_layers: int = 8) -> Tuple[Dict, List[str]]:
    enc_params, unused_enc = convert_wav2vec2(
        {k: v for k, v in sd.items() if k.startswith("audio_encoder.")},
        prefix="audio_encoder.",
    )
    params: Dict = {"audio_encoder": enc_params, "decoder": {}}
    consumed = set(k for k in sd if k.startswith("audio_encoder."))

    simple: List[Rule] = [
        (r"in_fn\.weight", "in_fn/kernel", t_linear),
        (r"in_fn\.bias", "in_fn/bias", t_none),
        (r"pose_map\.weight", "decoder/pose_map/kernel", t_linear),
        (r"pose_map\.bias", "decoder/pose_map/bias", t_none),
        (r"pose_map_r\.weight", "decoder/pose_map_r/kernel", t_linear),
        (r"pose_map_r\.bias", "decoder/pose_map_r/bias", t_none),
        (r"id_embed\.weight", "id_embed/embedding", t_none),
        (r"biased_mask", "skip", t_none),
        (r"PPE\.pe", "skip", t_none),
    ]
    rest = {k: v for k, v in sd.items() if k not in consumed and "transformer_decoder" not in k}
    p2, _, unused = apply_rules(rest, simple)
    _deep_merge(params, p2)

    for i in range(num_layers):
        base = f"transformer_decoder.layers.{i}"
        lp: Dict = {}
        (qw, kw, vw), (qb, kb, vb) = _split_in_proj(sd, f"{base}.self_attn")
        lp["self_q"] = {"kernel": qw.T, "bias": qb}
        lp["self_k"] = {"kernel": kw.T, "bias": kb}
        lp["self_v"] = {"kernel": vw.T, "bias": vb}
        lp["self_out"] = {
            "kernel": to_numpy(sd[f"{base}.self_attn.out_proj.weight"]).T,
            "bias": to_numpy(sd[f"{base}.self_attn.out_proj.bias"]),
        }
        # cross attention: only the value/out path matters (diagonal memory
        # mask -> single-key softmax); q/k projections cancel.
        (_, _, cvw), (_, _, cvb) = _split_in_proj(sd, f"{base}.multihead_attn")
        lp["cross_v"] = {"kernel": cvw.T, "bias": cvb}
        lp["cross_out"] = {
            "kernel": to_numpy(sd[f"{base}.multihead_attn.out_proj.weight"]).T,
            "bias": to_numpy(sd[f"{base}.multihead_attn.out_proj.bias"]),
        }
        for t_name, f_name in (
            ("linear1", "linear1"),
            ("linear2", "linear2"),
            ("norm1", "norm1"),
            ("norm2", "norm2"),
            ("norm3", "norm3"),
        ):
            w = to_numpy(sd[f"{base}.{t_name}.weight"])
            b_ = to_numpy(sd[f"{base}.{t_name}.bias"])
            if t_name.startswith("linear"):
                lp[f_name] = {"kernel": w.T, "bias": b_}
            else:
                lp[f_name] = {"scale": w, "bias": b_}
        params["decoder"][f"layer_{i}"] = lp

    return params, unused + unused_enc


def _deep_merge(dst: Dict, src: Dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
