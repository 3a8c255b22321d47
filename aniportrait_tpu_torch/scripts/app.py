"""Gradio serving app (port of ``scripts/app.py``; reference
``scripts/app.py``): a two-tab Blocks UI (Audio2Video / Video2Video) with
face auto-crop and head-pose template extraction.  Needs the ``gradio``
package, imported inside :func:`build_app` only, and the pretrained weights.
The model callbacks live in ``scripts/serving_core.py``, shared with the
stdlib HTTP server ``scripts/serve.py``, which runs without gradio."""

from __future__ import annotations

from aniportrait_tpu_torch.scripts.serving_core import (  # re-exported, as the JAX app does
    get_headpose_temp,
    load_serving_models,
    run_audio2video,
    run_video2video,
)

__all__ = ["get_headpose_temp", "build_app"]


def build_app(config_path: str = "./configs/prompts/animation_audio.yaml",
              device: str = "cuda"):
    import gradio as gr

    models = load_serving_models(config_path, device=device)

    def audio2video(input_audio, ref_img, headpose_video=None, size=512,
                    steps=25, length=150, seed=42):
        return run_audio2video(
            models, input_audio, ref_img, headpose_video,
            size=size, steps=steps, length=length, seed=seed,
            out_dir="output/gradio",
        )

    def video2video(ref_img, source_video, size=512, steps=25, length=150,
                    seed=42):
        return run_video2video(
            models, ref_img, source_video,
            size=size, steps=steps, length=length, seed=seed,
            out_dir="output/gradio",
        )

    with gr.Blocks() as demo:
        gr.Markdown("# AniPortrait")
        with gr.Tab("Audio2Video"):
            with gr.Row():
                a_audio = gr.Audio(type="filepath", label="Input audio")
                a_img = gr.Image(label="Reference image")
                a_pose = gr.Video(label="Head-pose reference video (optional)")
            a_btn = gr.Button("Generate")
            a_out = gr.Video(label="Result")
            a_ref = gr.Image(label="Cropped reference")
            a_btn.click(audio2video, [a_audio, a_img, a_pose], [a_out, a_ref])
        with gr.Tab("Video2Video"):
            with gr.Row():
                v_img = gr.Image(label="Reference image")
                v_src = gr.Video(label="Source video")
            v_btn = gr.Button("Generate")
            v_out = gr.Video(label="Result")
            v_ref = gr.Image(label="Cropped reference")
            v_btn.click(video2video, [v_img, v_src], [v_out, v_ref])
    return demo


if __name__ == "__main__":
    build_app().launch()
