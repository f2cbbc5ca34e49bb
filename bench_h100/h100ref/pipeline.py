"""One served request, computed by the plain reference in float32.

A frozen copy of what the port's served path computes for a ``POST /``
body (``serving/server.py::InferenceService._produce``,
``serving/cli.py::hash_prompt_embeds``, ``serving/orchestrator.py::
LTXVideoGenerator.generate``, ``pipelines/ltx_pipeline.py`` (conditioning,
the guidance schedule, ``denoise``, ``decode_full``),
``pipelines/multiscale.py``, ``schedulers/rf.py`` and the media helpers of
``utils/media.py``), for the configurations' paths: image-to-video, the
base and the multi-scale pipeline, CFG with the CFG* rescale, STG on
attention values, stochastic sampling, the timestep-conditioned decode.
The random draws (noise, the conditioning image's re-noising, the
stochastic steps, the decode noise) come from a ``torch.Generator`` on the
device seeded as the served path seeds its own (``generate``'s default
seed), in the same order and shapes. The conditioning image's CRF
round trip is OpenCV's JPEG at quality 60, the route the served path takes
where neither libavcodec nor an ffmpeg binary is present.

Nothing here imports the program or JAX.
"""

from __future__ import annotations

import base64
import hashlib
import io
import math

import numpy as np
import torch
from einops import rearrange

from . import vae as vae_ref
from .upsampler import adain

MAX_HEIGHT, MAX_WIDTH, MAX_FRAMES = 720, 1280, 257
SERVED_SEED = 42     # LTXVideoGenerator.generate's default, which POST / keeps
HASH_TOKENS = 128


# -- the request's inputs ---------------------------------------------------

def hash_prompt_embeds(prompt, negative, dim):
    def one(text):
        seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:4],
                              "little")
        return torch.randn((HASH_TOKENS, dim),
                           generator=torch.Generator().manual_seed(seed))

    return torch.stack([one("neg:" + negative), one("pos:" + prompt)])


def _new_dimensions(ch, cw, h, w, block=32):
    scale = max(min(ch / h, cw / w), min(cw / h, ch / w))
    return round(h * scale / block) * block, round(w * scale / block) * block


def pad_dimensions(h, w, f):
    return (((h - 1) // 32 + 1) * 32, ((w - 1) // 32 + 1) * 32,
            ((f - 2) // 8 + 1) * 8 + 1)


def _padding(h, w, hp, wp):
    ph, pw = hp - h, wp - w
    return (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)


def conditioning_image(image, height, width):
    """Aspect crop and bicubic resize, the 3x3 Gaussian blur, the CRF
    round trip (OpenCV JPEG, quality 60), to [-1, 1] ``[1, H, W, 3]``."""
    import cv2
    from PIL import Image

    ih, iw = image.shape[:2]
    target, frame = width / height, iw / ih
    if frame > target:
        nw, nh = int(ih * target), ih
        x0, y0 = (iw - nw) // 2, 0
    else:
        nw, nh = iw, int(iw / target)
        x0, y0 = 0, (ih - nh) // 2
    img = image[y0:y0 + nh, x0:x0 + nw]
    if img.shape[:2] != (height, width):
        img = np.asarray(Image.fromarray(img).resize((width, height),
                                                     Image.BICUBIC))
    img = cv2.GaussianBlur(np.ascontiguousarray(img), (3, 3), 0)
    img = img.astype(np.float32) / 255.0
    arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", arr[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 60])
    if not ok:
        raise RuntimeError("JPEG encode failed")
    img = cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]
    img = img.astype(np.float32) / 255.0
    return (img * 2.0 - 1.0)[None].astype(np.float32)


def resize_bilinear(frames, height, width):
    lead = frames.shape[:-3]
    flat = frames.reshape(-1, *frames.shape[-3:]).permute(0, 3, 1, 2)
    flat = torch.nn.functional.interpolate(
        flat, size=(height, width), mode="bilinear", align_corners=False,
        antialias=True)
    return flat.permute(0, 2, 3, 1).reshape(*lead, height, width, -1)


# -- schedules --------------------------------------------------------------

def _time_shift(mu, sigma, t):
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)


def _sd3_shift(n_tokens, ts, terminal=0.1):
    m = (2.05 - 0.95) / (4096 - 1024)
    mu = m * n_tokens + (0.95 - m * 1024)
    shifted = _time_shift(mu, 1.0, ts)
    one_minus = 1 - shifted
    scale = one_minus[-1] / (1 - terminal)
    return 1 - one_minus / scale


def build_timesteps(pass_cfg, n_tokens):
    if "timesteps" in pass_cfg:
        ts = np.asarray(pass_cfg["timesteps"], np.float32)
    else:
        steps = pass_cfg.get("num_inference_steps", 30)
        ts = torch.linspace(1.0, 1.0 / steps, steps, dtype=torch.float32)
        ts = _sd3_shift(n_tokens, ts).float().numpy()
    skip_i = pass_cfg.get("skip_initial_inference_steps", 0)
    skip_f = pass_cfg.get("skip_final_inference_steps", 0)
    if skip_i or skip_f:
        ts = ts[skip_i: len(ts) - skip_f]
    return torch.as_tensor(ts, dtype=torch.float32)


def _per_step(values, n):
    if not isinstance(values, (list, tuple)):
        return np.full(n, float(values), np.float32)
    vals = list(values) + [values[-1]] * max(0, n - len(values))
    return np.asarray(vals[:n], np.float32)


def guidance(pass_cfg, steps, num_layers):
    """(guidance, stg, rescale per step, skip mask [steps, L, conds],
    conds, do_cfg, do_stg, do_rescale) for schedules without
    ``guidance_timesteps`` (the configurations have none)."""
    if pass_cfg.get("guidance_timesteps") is not None:
        raise ValueError("guidance_timesteps are not in the reference")
    g = _per_step(pass_cfg.get("guidance_scale", 1.0), steps)
    s = _per_step(pass_cfg.get("stg_scale", 0.0), steps)
    r = _per_step(pass_cfg.get("rescaling_scale", 1.0), steps)
    g = np.where(g > 1.0, g, 0.0).astype(np.float32)
    do_cfg = bool(np.any((g != 0.0) & (g != 1.0)))
    do_stg = bool(np.any(s > 0))
    conds = 1 + do_cfg + do_stg
    mask = np.ones((steps, num_layers, conds), np.float32)
    skip = pass_cfg.get("skip_block_list")
    if do_stg and skip is not None:
        if len(skip) and isinstance(skip[0], (list, tuple)):
            per = [skip[min(i, len(skip) - 1)] for i in range(steps)]
        else:
            per = [skip] * steps
        for i, blocks in enumerate(per):
            for blk in blocks:
                if blk < num_layers:
                    mask[i, blk, conds - 1] = 0.0
    return g, s, r, mask, conds, do_cfg, do_stg, bool(np.any(r != 1.0))


# -- one pass ---------------------------------------------------------------

def _lower(ts, t):
    padded = torch.cat([ts.to(t.device), ts.new_zeros(1).to(t.device)])
    padded = padded.reshape((-1,) + (1,) * t.dim())
    return torch.where(padded < (t - 1e-6), padded, 0.0).amax(dim=0)


def denoise(dit, latents, cond_mask, coords, ts, pass_cfg, embeds, gen,
            groups, stochastic, image_cond_noise_scale):
    dev = latents.device
    cfg = dit.cfg
    steps = len(ts)
    g, s, r, mask, conds, do_cfg, do_stg, do_rescale = guidance(
        pass_cfg, steps, cfg["num_layers"])
    rows = [1] if conds == 1 else ([0, 1] if do_cfg else [1])
    if conds > 1 and do_stg:
        rows.append(rows[-1])
    ctx = embeds[rows].to(dev)
    freqs = dit.freqs(coords)
    n = latents.shape[1]
    init = latents
    skip_masks = torch.as_tensor(mask)
    for i in range(steps):
        t = float(ts[i])
        if image_cond_noise_scale > 0.0:
            noise = torch.randn(latents.shape, generator=gen, device=dev,
                                dtype=latents.dtype)
            need = (cond_mask > 1.0 - 1e-6)[..., None]
            latents = torch.where(
                need, init + image_cond_noise_scale * noise * (t ** 2), latents)
        t_tok = torch.minimum(torch.tensor(t, device=dev), 1.0 - cond_mask)
        t_grp = t_tok.reshape(1, groups, n // groups)[:, :, 0]
        pred = dit(latents.expand(conds, -1, -1), t_grp.expand(conds, -1),
                   ctx, freqs, skip_masks[i] if do_stg else None)
        streams = pred.split(1, dim=0)
        text = streams[-2] if do_stg else streams[-1]
        if do_cfg:
            uncond, text = streams[0], streams[1]
            if g[i] != 0.0 and g[i] != 1.0:
                dot = torch.sum(text * uncond)
                sq = torch.sum(uncond ** 2) + 1e-8
                uncond = (dot / sq) * uncond
                v = uncond + float(g[i]) * (text - uncond)
            else:
                v = text
        else:
            v = text
        if do_stg:
            v = v + float(s[i]) * (text - streams[-1])
            if do_rescale and s[i] > 0.0:
                factor = text.std(correction=0) / (v.std(correction=0) + 1e-8)
                v = v * (float(r[i]) * factor + (1 - float(r[i])))
        t_full = t_tok.unsqueeze(-1)
        dt = t_full - _lower(ts, t_tok).unsqueeze(-1)
        if stochastic:
            x0 = latents - t_full * v
            nxt = t_full - dt
            eps = torch.randn(latents.shape, generator=gen, device=dev,
                              dtype=latents.dtype)
            denoised = (1 - nxt) * x0 + nxt * eps
        else:
            denoised = latents - dt * v
        keep = (t - 1e-6 < (1.0 - cond_mask))[..., None]
        latents = torch.where(keep, denoised, latents)
    return latents


def run_pass(dit, vae, embeds, height, width, frames, frame_rate, ts,
             pass_cfg, gen, cond_image, stochastic, media_latents=None,
             initial_timestep=None):
    """``LTXPipeline.generate`` to latents ``[1, F', H', W', C]``."""
    dev = embeds.device
    sf, tf = vae_ref.spatial_factor(vae.cfg), vae_ref.temporal_factor(vae.cfg)
    f_lat, h_lat, w_lat = (frames - 1) // tf + 1, height // sf, width // sf
    c = dit.cfg["in_channels"]
    noise = torch.randn((1, f_lat * h_lat * w_lat, c), generator=gen,
                        device=dev, dtype=torch.float32)
    grid = rearrange(noise, "b (f h w) c -> b f h w c", h=h_lat, w=w_lat)
    if media_latents is not None:
        t0 = float(ts[0]) if initial_timestep is None else initial_timestep
        init = t0 * grid + (1 - t0) * media_latents.float()
    else:
        init = grid
    media = torch.as_tensor(cond_image, dtype=torch.float32, device=dev)[None]
    if media.shape[2] != height or media.shape[3] != width:
        media = resize_bilinear(media, height, width)
    z = vae_ref.encode(vae, media)
    cond = torch.zeros_like(init)
    cond[:, :z.shape[1]] = z
    mask = torch.zeros(init.shape[:4], dtype=torch.float32, device=dev)
    mask[:, :z.shape[1]] = 1.0
    init = init + mask[..., None] * (cond - init)
    tokens = rearrange(init, "b f h w c -> b (f h w) c")
    gf, gh, gw = torch.meshgrid(torch.arange(f_lat, device=dev),
                                torch.arange(h_lat, device=dev),
                                torch.arange(w_lat, device=dev),
                                indexing="ij")
    coords = torch.stack([gf, gh, gw]).reshape(1, 3, -1)
    pix = coords * torch.tensor([tf, sf, sf], device=dev)[None, :, None]
    pix[:, 0] = torch.clamp(pix[:, 0] + 1 - tf, min=0)
    pix = pix.float()
    pix[:, 0] = pix[:, 0] * (1.0 / frame_rate)
    out = denoise(dit, tokens, mask.reshape(1, -1), pix, ts, pass_cfg, embeds,
                  gen, f_lat, stochastic, 0.15)
    return rearrange(out, "b (f h w) c -> b f h w c", h=h_lat, w=w_lat)


# -- the request ------------------------------------------------------------

def request_inputs(body):
    from PIL import Image

    raw = base64.b64decode(body["image"])
    image = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    return image


@torch.no_grad()
def serve(body, pipeline_cfg, dit, vae, upsampler, device):
    """The stages of one ``POST /`` body: ``{"pass1", "upsampled"}`` (the
    multi-scale pipeline), ``"latents"`` (the last pass's latent grid) and
    ``"frames"`` (uint8 ``[F, H, W, 3]`` numpy, as ``generate`` returns
    them where the frames are fetched as RGB)."""
    image = request_inputs(body)
    cfg = dict(pipeline_cfg)
    height, width = int(body["height"]), int(body["width"])
    frame_num = int(body["num_frames"])
    frame_rate = int(body["frame_rate"])
    steps = int(body["num_inference_steps"])
    height, width = _new_dimensions(height, width, *image.shape[:2])
    height, width = min(height, MAX_HEIGHT), min(width, MAX_WIDTH)
    frame_num = min(frame_num, MAX_FRAMES)
    hp, wp, fp = pad_dimensions(height, width, frame_num)
    pad = _padding(height, width, hp, wp)
    img = conditioning_image(image, height, width)
    left, right, top, bottom = pad
    img = np.pad(img, [(0, 0), (top, bottom), (left, right), (0, 0)])
    embeds = hash_prompt_embeds(body["prompt"], body["negative_prompt"],
                                dit.cfg["caption_channels"]).to(device)
    gen = torch.Generator(device=device).manual_seed(SERVED_SEED)
    stochastic = cfg.get("stochastic_sampling", False)
    sf, tf = vae_ref.spatial_factor(vae.cfg), vae_ref.temporal_factor(vae.cfg)
    out = {}
    if cfg.get("pipeline_type") == "multi-scale":
        first, second = dict(cfg["first_pass"]), dict(cfg["second_pass"])
        first["num_inference_steps"] = second["num_inference_steps"] = steps
        df = cfg["downscale_factor"]
        xh, xw = int(hp * df), int(wp * df)
        dh, dw = max(sf, xh - xh % sf), max(sf, xw - xw % sf)
        f_lat = (fp - 1) // tf + 1
        ts1 = build_timesteps(first, f_lat * (dh // sf) * (dw // sf))
        ts2 = build_timesteps(second, f_lat * (hp // sf) * (wp // sf))
        lat = run_pass(dit, vae, embeds, dh, dw, fp, frame_rate, ts1, first,
                       gen, img, stochastic)
        out["pass1"] = lat
        z = upsampler(vae_ref.un_normalize(lat, vae))
        up = adain(vae_ref.normalize(z, vae), lat)
        out["upsampled"] = up
        lat = run_pass(dit, vae, embeds, dh * 2, dw * 2, fp, frame_rate, ts2,
                       second, gen, img, stochastic, media_latents=up,
                       initial_timestep=float(ts2[0]))
    else:
        keys = ("guidance_scale", "stg_scale", "rescaling_scale",
                "skip_block_list", "guidance_timesteps",
                "num_inference_steps", "timesteps")
        pass_cfg = {k: cfg[k] for k in keys if k in cfg}
        pass_cfg["num_inference_steps"] = steps
        f_lat = (fp - 1) // tf + 1
        ts = build_timesteps(pass_cfg, f_lat * (hp // sf) * (wp // sf))
        lat = run_pass(dit, vae, embeds, hp, wp, fp, frame_rate, ts, pass_cfg,
                       gen, img, stochastic)
    out["latents"] = lat
    z = vae_ref.un_normalize(lat, vae)
    noise = torch.randn(z.shape, generator=gen, device=z.device, dtype=z.dtype)
    s = torch.tensor(cfg.get("decode_noise_scale",
                             cfg.get("decode_timestep", 0.0)),
                     dtype=torch.float32)
    z = z * (1 - s) + noise * s
    t = torch.tensor(cfg.get("decode_timestep", 0.0), dtype=torch.float32,
                     device=z.device)
    px = vae_ref.decode_tiled(vae, z, vae_ref.decode_tiles(vae.cfg, z), t)
    frames = px[0]
    if frames.shape[1] != hp or frames.shape[2] != wp:
        frames = resize_bilinear(frames, hp, wp)
    bottom = frames.shape[1] if bottom == 0 else -bottom
    right = frames.shape[2] if right == 0 else -right
    frames = frames[:frame_num, top:bottom, left:right]
    frames = torch.clamp((frames + 1.0) * 127.5, 0, 255)
    out["frames"] = frames.to(torch.uint8).cpu().numpy()
    return out
