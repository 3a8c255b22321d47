"""Pose-conditioned video/image generation (port of
``aniportrait_tpu/pipelines/pose2vid.py``).

One generation (reference pipeline_pose2vid_long.py:339-584):

1. ``_encode_reference``: CLIP-embed the reference image (CFG pairs it with
   a zero embedding), VAE-encode it, and run the ReferenceNet once on the
   CFG-doubled latent to capture the attention banks.
2. ``_pose_features``: the PoseGuider pyramid for every frame, once.
3. the sampler of ``_build_sampler``: per DDIM step, the denoising UNet on
   the whole clip (one window) or on overlapping context windows whose
   predictions are scatter-added, counted and divided; CFG rows are
   ``[uncond..., cond...]`` with frames contiguous (``drop_mode=
   'first_half'``); banks and context are tiled once per clip.  Latents stay
   float32 across steps.
4. ``_decode``: VAE-decode in chunks to uint8 frames.

The long-clip options of the JAX pipeline are the same here (see
:class:`Pose2VideoPipeline`): window fusion, the encoder cache, context
rotation and latent interpolation; :meth:`Pose2VideoPipeline.run_cases`
overlaps one request's upload and another's download with a third's
denoise.  On a GPU, host <-> device copies run from pinned memory on side
CUDA streams.  Over a ``parallel.Mesh`` (``mesh=``) the ranks share out
the windows, or the CFG halves and frame blocks, and the VAE decode.

Inputs are uint8 ``(H, W, 3)`` images; the output is ``(L, H, W, 3)``.
Initial noise comes from ``torch.Generator(device).manual_seed(seed)``.

Tracing (``utils/profiling.py``): the pipeline's ``PhaseTimer`` keeps the
phases ``host_inputs`` (host resize, pinning, the uploads' issue),
``encode_reference``, ``pose_features``, ``denoise`` and ``vae_decode``
(``host_outputs`` inside it: the last copies' waits and the host's frames);
while the tracer is on they are spans of the root span ``request``, with
``step`` (per DDIM step; on the windowed path ``window_batch``, ``scatter``)
and ``scheduler_step`` inside ``denoise``, and a span per model call:
``clip``, ``vae_encode``, ``reference_unet``, ``pose_guider``,
``denoising_unet``, ``vae_decode_chunk``.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import List

import numpy as np
import torch

from aniportrait_tpu_torch.factory import PipelineModules
from aniportrait_tpu_torch.models.clip_vision import CLIP_MEAN, CLIP_STD
from aniportrait_tpu_torch.parallel.mesh import (
    FrameShard,
    frame_sizes,
    replicate,
    shard_rows,
)
from aniportrait_tpu_torch.pipelines.context import (
    uniform_context_windows,
    wide_motion_windows,
    windows_for_all_steps,
)
from aniportrait_tpu_torch.pipelines.interpolation import interpolate_latents
from aniportrait_tpu_torch.utils.image import resize
from aniportrait_tpu_torch.utils.profiling import PhaseTimer, span

VAE_SCALE = 0.18215


def mesh_window_batch(window_batch: int, ranks: int) -> int:
    """The window batch of a pipeline over ``ranks``: rounded, as the JAX
    pipeline rounds it, so that ``2 * window_batch`` (its CFG rows) divides
    the ranks."""
    if (2 * window_batch) % ranks:
        return max(ranks // 2, 1) * max(1, (2 * window_batch) // ranks)
    return window_batch


class Pose2VideoPipeline:
    def __init__(self, modules: PipelineModules, dtype=torch.float32,
                 context_frames: int = 16, context_stride: int = 1,
                 context_overlap: int = 4, window_batch: int = 4, mesh=None,
                 encoder_cache_interval: int = 1, window_fusion: bool = False,
                 fusion_motion: str = "auto", context_rotate: bool = False):
        """Options of the JAX pipeline (``aniportrait_tpu/pipelines/
        pose2vid.py:81-128``), each off by default:

        * ``encoder_cache_interval`` k > 1: the UNet's down + mid features
          are computed at every k-th denoise step and reused in between (one
          cache per window batch).
        * ``window_fusion``: one whole-clip UNet pass per step in place of
          one per window; the motion modules window internally and average
          overlapping frames.  ``fusion_motion``: ``'auto'`` attends over
          the whole clip when it fits the motion PE (L <= its max length),
          else over :func:`context.wide_motion_windows`; ``'context'`` uses
          the exact path's context window table.
        * ``context_rotate``: the window table of step s is the context
          scheduler's step-s table (off when fused or with the cache).

        ``mesh``: a ``parallel.Mesh`` (every rank builds the pipeline over
        its own copy of the models and calls it with the same arguments):
        the models are replicated from rank 0, each rank denoises its share
        (see :meth:`_build_sampler`) and VAE-decodes its share of the
        chunks, and every rank returns the same video.  ``window_batch`` is
        rounded as the JAX pipeline rounds it, so that ``2 * window_batch``
        divides the ranks."""
        if fusion_motion not in ("auto", "context"):
            raise ValueError(f"fusion_motion={fusion_motion!r}")
        self.m = modules
        self.dtype = dtype
        self.device = next(modules.vae.parameters()).device
        self.context_frames = context_frames
        self.context_stride = context_stride
        self.context_overlap = context_overlap
        self.window_batch = window_batch
        self.encoder_cache_interval = int(encoder_cache_interval)
        self.window_fusion = bool(window_fusion)
        self.fusion_motion = fusion_motion
        self.context_rotate = bool(context_rotate)
        self.mesh = mesh
        if mesh is not None:
            replicate(modules.models().values(), mesh)
            self.window_batch = mesh_window_batch(window_batch, mesh.size)
        self.timer = PhaseTimer()
        self._streams = {}

    def _sync(self):
        """Wait for the current stream (not the side streams' copies).  Each
        phase of :meth:`__call__` ends in it, so that the ``PhaseTimer``
        totals cover the device work: the benchmark's
        ``pipeline.denoise_s.gen`` reads the ``denoise`` total."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _side_stream(self, name: str):
        if name not in self._streams:
            self._streams[name] = torch.cuda.Stream(self.device)
        return self._streams[name]

    # ------------------------------------------------------------ host IO
    def _upload(self, arrays):
        """Host arrays -> (device tensors, ready event or None).  On a GPU
        the copies run from pinned memory on the upload stream, so they
        overlap whatever the current stream runs; :meth:`_ready` makes the
        current stream wait for them."""
        tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
        if self.device.type != "cuda":
            return tensors, None
        stream = self._side_stream("upload")
        with torch.cuda.stream(stream):
            out = tuple(t.pin_memory().to(self.device, non_blocking=True) for t in tensors)
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def _ready(self, tensors, event):
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in tensors:
                t.record_stream(current)
        return tensors

    def _download(self, video):
        """Device uint8 video -> (host tensor, done event or None); on a GPU
        the copy into pinned memory runs on the download stream after the
        current stream's work."""
        if self.device.type != "cuda":
            return video, None
        stream = self._side_stream("download")
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            host = torch.empty(video.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(video, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        video.record_stream(stream)
        return host, done

    @staticmethod
    def _host_video(host, done):
        """float32 [0, 1] frames of a :meth:`_download` once it is done."""
        if done is not None:
            done.synchronize()
        return host.numpy().astype(np.float32) / 255.0

    # ------------------------------------------------------------ stages
    def stage_inputs(self, ref_image, pose_images, width, height, device=True):
        """Resize on the host: (ref (1, H, W, 3), clip image (1, s, s, 3),
        poses (1, L, H, W, 3)), uint8 numpy arrays, or uint8 tensors on the
        pipeline's device with ``device=True`` (the staged input of
        ``__call__(staged, None, ...)``)."""
        clip_size = self.m.clip.image_size
        ref = resize(ref_image, width, height)[None]
        clip_img = resize(ref_image, clip_size, clip_size)[None]
        poses = np.stack([resize(p, width, height) for p in pose_images])[None]
        if device:
            return self._ready(*self._upload((ref, clip_img, poses)))
        return ref, clip_img, poses

    @torch.no_grad()
    def _encode_reference(self, ref_u8, clip_u8):
        """ref_u8 (1, H, W, 3), clip_u8 (1, s, s, 3) uint8 tensors.  Returns
        (context (2, 1, proj) [uncond zero, cond], reference latents
        (1, h, w, 4), banks {key: (2, L, C)})."""
        m = self.m
        ref = ref_u8.permute(0, 3, 1, 2).to(self.dtype) / 127.5 - 1.0
        mean = torch.tensor(CLIP_MEAN, device=self.device)[:, None, None]
        std = torch.tensor(CLIP_STD, device=self.device)[:, None, None]
        clip = ((clip_u8.permute(0, 3, 1, 2).float() / 255.0 - mean) / std)
        with span("clip"):
            ctx = m.clip(clip.to(self.dtype))[:, None, :]
        ctx_cfg = torch.cat([torch.zeros_like(ctx), ctx], dim=0)
        with span("vae_encode"):
            ref_latents = m.vae.encode(ref)[0] * VAE_SCALE  # (1, 4, h, w)
        ref_in = torch.cat([ref_latents] * 2, dim=0)[:, None]
        t0 = torch.zeros(2, dtype=torch.long, device=self.device)
        with span("reference_unet"):
            _, banks = m.reference_unet(ref_in, t0, ctx_cfg, capture_banks=True)
        return ctx_cfg, ref_latents.permute(0, 2, 3, 1), banks

    @torch.no_grad()
    def _pose_features(self, pose_u8):
        """pose_u8 (1, L, H, W, 3) uint8 -> list of (1, L, c_k, h_k, w_k)."""
        pose = pose_u8.permute(0, 1, 4, 2, 3).to(self.dtype) / 127.5 - 1.0
        with span("pose_guider"):
            return self.m.pose_guider(pose)

    def _build_sampler(self, video_length: int, hlat: int, wlat: int, steps: int,
                       guidance_scale: float, windowed: bool):
        """The denoise loop for one bucket: ``sample(latents, ctx_cfg, banks,
        pose_fea)`` with latents (1, L, h, w, 4) float32, returns the same.

        Under a mesh every rank runs the same loop on its share and returns
        the same latents: the exact windowed path gives each rank a
        contiguous share of each step's (padded) window table, both CFG
        halves of each window, in local batches of ``ceil(window_batch /
        ranks)`` windows; the whole-clip and fused paths give each rank one
        CFG half (``uncond``/``cond``, with an even world and CFG) and a
        block of frames (``parallel.FrameShard``; the motion modules
        exchange frames for positions).  Each step ends with one float32
        ``all_reduce`` of the rank's noise predictions (and window counts)
        into the clip's, so every rank applies the same DDIM update."""
        m, sched, mesh = self.m, self.m.scheduler, self.mesh
        timesteps = [int(t) for t in sched.timesteps(steps)]
        do_cfg = guidance_scale > 1.0
        ctx_args = (self.context_frames, self.context_stride, self.context_overlap)
        if windowed and video_length > self.context_frames:
            windows = uniform_context_windows(0, video_length, *ctx_args)
        else:
            windows = np.arange(video_length, dtype=np.int32)[None]
        n_win, win_len = windows.shape
        fused = self.window_fusion and windowed and n_win > 1
        motion_windows = None
        if fused:
            pe_max = m.denoising_unet.motion_pe_max_len
            if self.fusion_motion == "context":
                motion_windows = windows
            elif video_length > pe_max:
                motion_windows = wide_motion_windows(
                    video_length, pe_max, max(self.context_overlap, 1))
        single = fused or (n_win == 1 and win_len == video_length)
        wb = 1 if single else (self.window_batch if mesh is not None
                               else min(self.window_batch, n_win))
        k_cache = max(1, self.encoder_cache_interval)
        rotate = self.context_rotate and not single and k_cache <= 1
        tables = (windows_for_all_steps(steps, video_length, *ctx_args) if rotate
                  else [windows])
        pad_to = -(-max(len(t) for t in tables) // wb) * wb
        dev = self.device
        ranks = 1 if mesh is None else mesh.size
        local_wb = -(-wb // ranks)

        def window_batches(table):
            """The table padded by repetition to ``pad_to`` rows, this rank's
            share of it in batches of at most ``local_wb``: [(frame indices
            (n, win_len), valid (n,))]."""
            reps = 1 + (pad_to - 1) // len(table)
            padded = np.tile(table, (reps, 1))[:pad_to].astype(np.int64)
            valid = np.arange(pad_to) < len(table)
            rank = 0 if mesh is None else mesh.rank
            share = range(pad_to)[shard_rows(pad_to, ranks, rank)]
            return [(torch.from_numpy(padded[i:min(i + local_wb, share.stop)]).to(dev),
                     valid[i:min(i + local_wb, share.stop)])
                    for i in range(share.start, share.stop, local_wb)]

        step_batches = [window_batches(t) for t in tables]

        # the whole-clip pass under a mesh: this rank's CFG half and frames
        cfg_split = mesh is not None and single and do_cfg and mesh.cfg_ways == 2
        half = mesh.cfg_index if cfg_split else None
        shard, block, contributes = None, slice(None), True
        if mesh is not None and single:
            group = mesh.frames if cfg_split else mesh.world
            if group.size > 1 and video_length >= group.size:
                shard = FrameShard(group, frame_sizes(video_length, group.size))
                block = shard.block
            else:  # every rank of the group runs the whole clip; one counts
                contributes = group.index == 0
        drop_mode = (("uncond", "cond")[half] if cfg_split
                     else "first_half" if do_cfg else "none")

        def cfg2(x):
            if cfg_split:
                return x
            return torch.cat([x, x], dim=0) if do_cfg else x

        def tile_cfg(v, n_rows):
            """Rows [uncond x half, cond x half] (or one half only), once per
            clip."""
            if cfg_split:
                return v[half:half + 1].repeat_interleave(n_rows, dim=0)
            if not do_cfg:
                return v[1:].repeat_interleave(n_rows, dim=0)
            half_rows = n_rows // 2
            return torch.cat([v[:1].repeat_interleave(half_rows, dim=0),
                              v[1:].repeat_interleave(half_rows, dim=0)], dim=0)

        def unet(lat, t, ctx_t, banks_t, pose_w, mode="full", enc=None):
            b = lat.shape[0]
            with span("denoising_unet", rows=b, mode=mode):
                out, _ = m.denoising_unet(
                    lat.to(self.dtype), torch.full((b,), t, dtype=torch.long, device=dev),
                    ctx_t, pose_cond_fea=pose_w, ref_banks=banks_t, drop_mode=drop_mode,
                    mode=mode, motion_windows=motion_windows, enc_features=enc,
                    frame_shard=shard,
                )
            return out

        def predict(lat, t, step_i, ctx_t, banks_t, pose_w, cache, slot):
            """float32 noise prediction; with the encoder cache, the down +
            mid features in ``cache[slot]`` refresh at every k-th step."""
            if k_cache <= 1:
                return unet(lat, t, ctx_t, banks_t, pose_w).float()
            if step_i % k_cache == 0:
                cache[slot] = unet(lat, t, ctx_t, banks_t, pose_w, mode="encode")
            return unet(lat, t, ctx_t, banks_t, pose_w, mode="decode",
                        enc=cache[slot]).float()

        def combine(pred_u, pred_c):
            return pred_u + guidance_scale * (pred_c - pred_u)

        @torch.no_grad()
        def sample(latents, ctx_cfg, banks, pose_fea):
            x = latents.permute(0, 1, 4, 2, 3).contiguous()  # (1, L, 4, h, w)
            tiled = {}

            def cond_rows(n_windows):
                """(context, banks) tiled to ``n_windows`` windows' rows."""
                if n_windows not in tiled:
                    n_rows = (2 if do_cfg and not cfg_split else 1) * n_windows
                    tiled[n_windows] = (tile_cfg(ctx_cfg, n_rows),
                                        {k: tile_cfg(v, n_rows) for k, v in banks.items()})
                return tiled[n_windows]

            def gather_clip(pred):
                """The clip's (CFG rows, L, ...) prediction from every rank's
                rows of its frame block."""
                full = torch.zeros((2 if do_cfg else 1,) + x.shape[1:],
                                   dtype=torch.float32, device=dev)
                if contributes:
                    rows = slice(half, half + 1) if cfg_split else slice(None)
                    full[rows, block] = pred
                return mesh.world.all_reduce_(full)

            cache = {}
            if single:
                ctx_t, banks_t = cond_rows(1)
                pose_w = [cfg2(pf[:, block]) for pf in pose_fea]
                for i, t in enumerate(timesteps):
                    with span("step", index=i):
                        pred = predict(cfg2(x[:, block]), t, i, ctx_t, banks_t, pose_w,
                                       cache, 0)
                        if mesh is not None:
                            pred = gather_clip(pred)
                        if do_cfg:
                            pred = combine(*pred.chunk(2, dim=0))
                        with span("scheduler_step"):
                            x = sched.step(pred, t, x, steps)
                return x.permute(0, 1, 3, 4, 2).contiguous()

            def window_pose(win):
                """The batch's CFG-doubled pose features, gathered at the step
                that uses them and freed after it, as the original streams
                them per window (pipeline_pose2vid_long.py:531-536)."""
                return [cfg2(pf[0][win]) for pf in pose_fea]

            for i, t in enumerate(timesteps):
                with span("step", index=i):
                    noise_pred = torch.zeros((2 if do_cfg else 1,) + x.shape[1:],
                                             dtype=torch.float32, device=dev)
                    counter = torch.zeros(video_length, dtype=torch.float32, device=dev)
                    for slot, (win, ok) in enumerate(step_batches[i if rotate else 0]):
                        with span("window_batch", rows=win.shape[0], valid=int(ok.sum())):
                            ctx_t, banks_t = cond_rows(win.shape[0])
                            pred = predict(cfg2(x[0][win]), t, i, ctx_t, banks_t,
                                           window_pose(win), cache, slot)
                        with span("scatter"):
                            parts = pred.chunk(2, dim=0) if do_cfg else (pred,)
                            for k in range(win.shape[0]):
                                if not ok[k]:
                                    continue
                                for row, part in enumerate(parts):
                                    noise_pred[row].index_add_(0, win[k], part[k])
                                counter.index_add_(0, win[k], torch.ones(win_len, device=dev))
                    if mesh is not None:
                        sums = mesh.world.all_reduce_(
                            torch.cat([noise_pred.reshape(-1), counter]))
                        noise_pred = sums[:noise_pred.numel()].view_as(noise_pred)
                        counter = sums[noise_pred.numel():]
                    noise_pred = noise_pred / counter[None, :, None, None, None]
                    pred = combine(noise_pred[0:1], noise_pred[1:2]) if do_cfg else noise_pred
                    with span("scheduler_step"):
                        x = sched.step(pred, t, x, steps)
            return x.permute(0, 1, 3, 4, 2).contiguous()

        return sample

    @torch.no_grad()
    def _decode(self, latents, decode_chunk: int = 8, to_host: bool = False):
        """latents (1, L, h, w, 4) -> video (L, H, W, 3) uint8: a tensor on
        the device, or with ``to_host`` a numpy array, each chunk's copy
        into pinned host memory running on the download stream while the
        next chunk decodes."""
        z = latents[0].permute(0, 3, 1, 2) / VAE_SCALE
        length = z.shape[0]
        decode_chunk = min(decode_chunk, length)
        pad = (-length) % decode_chunk
        if pad:
            z = torch.cat([z, z[:pad]], dim=0)
        chunks = z.split(decode_chunk)
        mine = range(len(chunks))
        if self.mesh is not None:  # this rank's share of the chunks
            mine = mine[shard_rows(len(chunks), self.mesh.size, self.mesh.rank)]
            to_host_here, to_host = to_host, False
        out = []
        for i in mine:
            with span("vae_decode_chunk", frames=chunks[i].shape[0]):
                img = self.m.vae.decode(chunks[i].to(self.dtype)).float()
                img = (img / 2 + 0.5).clamp(0.0, 1.0)
                img = torch.round(img * 255.0).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
                out.append(self._download(img) if to_host else (img, None))
        if to_host:
            # the decode's own device work ends here, so that host_outputs
            # times the last copies' waits and the host's own work only
            self._sync()
            with self.timer.phase("host_outputs"):
                for _, done in out:
                    if done is not None:
                        done.synchronize()
                return torch.cat([img for img, _ in out], dim=0)[:length].numpy()
        if self.mesh is not None:  # every rank's chunks, in order
            n = len(chunks)
            rows = [decode_chunk * len(range(n)[shard_rows(n, self.mesh.size, r)])
                    for r in range(self.mesh.size)]
            local = (torch.cat([img for img, _ in out]) if out else torch.empty(
                (0, 8 * z.shape[2], 8 * z.shape[3], 3), dtype=torch.uint8, device=z.device))
            video = torch.cat(self.mesh.world.all_gather(local, rows))[:length]
            if not to_host_here:
                return video
            self._sync()
            with self.timer.phase("host_outputs"):
                host, done = self._download(video)
                if done is not None:
                    done.synchronize()
                return host.numpy()
        return torch.cat([img for img, _ in out], dim=0)[:length]

    def _initial_latents(self, seed: int, shape) -> torch.Tensor:
        """The initial noise, float32: the same on every rank of a mesh."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        latents = torch.randn(shape, generator=gen, device=self.device,
                              dtype=torch.float32)
        return latents * self.m.scheduler.init_noise_sigma

    # -------------------------------------------------------------- call
    def run_cases(self, cases, width: int, height: int, **kw):
        """Run clips in sequence with host <-> device IO overlapped against
        compute (``aniportrait_tpu/pipelines/pose2vid.py:713-759``): case
        i+1's host resize and upload, and case i-1's download, run while
        case i denoises.  The resize runs on a worker thread; the copies
        run from pinned memory on the upload and download streams.

        cases: dicts with ``ref_image`` (H, W, 3 uint8), ``pose_images``
        (list of uint8), optional ``ref_pose_image``, ``key`` (yielded back,
        default the index) and ``kw`` (per-case overrides of ``kw``, which
        goes to ``__call__``).  Yields ``(key, video)`` in case order, video
        (L, H, W, 3) float32 in [0, 1]."""
        cases = list(cases)
        if not cases:
            return
        pool = cf.ThreadPoolExecutor(max_workers=1)

        def stage(c):
            return self._upload(self.stage_inputs(c["ref_image"], c["pose_images"],
                                                  width, height, device=False))

        try:
            staged = pool.submit(stage, cases[0])
            pending = None
            for i, c in enumerate(cases):
                inputs = self._ready(*staged.result())
                if i + 1 < len(cases):
                    staged = pool.submit(stage, cases[i + 1])
                video = self(inputs, None, c.get("ref_pose_image"), width, height,
                             return_device=True, **{**kw, **c.get("kw", {})})
                if pending is not None:
                    yield pending[0], self._host_video(*pending[1])
                pending = (c.get("key", i), self._download(video))
            yield pending[0], self._host_video(*pending[1])
        finally:
            pool.shutdown(wait=True)

    def __call__(self, ref_image, pose_images: List[np.ndarray] | None,
                 ref_pose_image, width: int, height: int, video_length: int,
                 num_inference_steps: int = 25, guidance_scale: float = 3.5,
                 seed: int = 42, windowed: bool = True, decode_chunk: int = 8,
                 interpolation_factor: int = 1, interp_method: str = "linear",
                 return_device: bool = False):
        """Images are uint8 RGB (H, W, 3) numpy arrays (``ref_pose_image`` is
        unused, as in the JAX package), or ``ref_image`` is the staged tuple
        of :meth:`stage_inputs` with ``pose_images=None``.  With
        ``interpolation_factor`` k > 1 the denoised latents are interpolated
        (``interp_method`` 'linear' or 'slerp') to (L - 1) * k + 1 frames
        before the decode.  Returns (frames, H, W, 3) float32 in [0, 1], or
        with ``return_device`` the uint8 video on the device."""
        with span("request", frames=video_length, steps=num_inference_steps):
            return self._generate(
                ref_image, pose_images, width, height, video_length, num_inference_steps,
                guidance_scale, seed, windowed, decode_chunk, interpolation_factor,
                interp_method, return_device)

    def _generate(self, ref_image, pose_images, width, height, video_length,
                  num_inference_steps, guidance_scale, seed, windowed, decode_chunk,
                  interpolation_factor, interp_method, return_device):
        """The body of :meth:`__call__`: its phases, each ending in a
        synchronisation of the compute stream."""
        poses_up = None
        if pose_images is None:
            ref, clip_img, poses = ref_image
        else:
            with self.timer.phase("host_inputs"):
                host = self.stage_inputs(ref_image, pose_images, width, height,
                                         device=False)
                ref, clip_img = self._ready(*self._upload(host[:2]))
                poses_up = self._upload(host[2:])  # rides under the reference encode
        with self.timer.phase("encode_reference"):
            ctx_cfg, _, banks = self._encode_reference(ref, clip_img)
            self._sync()
        if poses_up is not None:
            (poses,) = self._ready(*poses_up)
        with self.timer.phase("pose_features"):
            pose_fea = self._pose_features(poses)
            self._sync()

        hlat, wlat = height // 8, width // 8
        sampler = self._build_sampler(video_length, hlat, wlat, num_inference_steps,
                                      guidance_scale, windowed)
        latents = self._initial_latents(seed, (1, video_length, hlat, wlat, 4))
        with self.timer.phase("denoise"):
            latents = sampler(latents, ctx_cfg, banks, pose_fea)
            self._sync()
        latents = interpolate_latents(latents, interpolation_factor, interp_method)
        with self.timer.phase("vae_decode"):
            video = self._decode(latents, decode_chunk, to_host=not return_device)
            self._sync()
            if return_device:
                return video
            with self.timer.phase("host_outputs"):
                return video.astype(np.float32) / 255.0


class Pose2ImagePipeline(Pose2VideoPipeline):
    """Single-frame pipeline (reference pipeline_pose2img.py)."""

    def __call__(self, ref_image, pose_image, width: int, height: int,
                 num_inference_steps: int = 25, guidance_scale: float = 3.5,
                 seed: int = 42):
        video = super().__call__(
            ref_image, [pose_image], None, width, height, video_length=1,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            seed=seed, windowed=False, decode_chunk=1,
        )
        return video[0]
