"""The serving entry points of the port against the JAX package's: the HTTP
service, the stdlib server, the CLI, the warm-up, the model catalogue, and
the helpers under them (resolution bucketing, YUV420, mp4 I/O, interrupt,
stage marks).

``InferenceService`` against ``InferenceService``: tiny widths (the 13B
block's shape at 2 layers, 2 heads of 128; the slice test's configs and
weights, carried across by ``core/from_jax.py``), ``warmup_spec="off"``,
the same request body. Both services draw their own noise from the seed and
hash their own prompt embeddings, so the test patches what the two
frameworks cannot share, as the slice tests do: ``encode_or_hash`` returns
the same numpy embeddings on both sides, the two passes' initial noise is
injected, the conditioning-noise refresh is off and the CRF round trip is
the identity. Compared: status, the JSON's shape, and the frames each
service hands to its mp4 writer, at >= 40 dB PSNR (PARITY.md's bar; the
mp4s themselves go through whatever codec a machine has). The pure string
and integer logic (flags, buckets, file names, bins) is held equal to
JAX's, value for value.
"""

import base64
import inspect
import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ltx_video_gpupoor_tpu.core import interrupt as jinterrupt
from ltx_video_gpupoor_tpu.models.ltx import transformer3d as jtf
from ltx_video_gpupoor_tpu.pipelines import ltx_pipeline as jpipe
from ltx_video_gpupoor_tpu.serving import cli as jcli
from ltx_video_gpupoor_tpu.serving import model_zoo as jzoo
from ltx_video_gpupoor_tpu.serving import orchestrator as jorch
from ltx_video_gpupoor_tpu.serving import server as jserver
from ltx_video_gpupoor_tpu.serving import warmup as jwarmup
from ltx_video_gpupoor_tpu.utils import media as jmedia
from ltx_video_gpupoor_tpu.utils import native_codec as jnative
from ltx_video_gpupoor_tpu.utils import resolution as jres
from ltx_video_gpupoor_tpu_torch.core import interrupt as tinterrupt
from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
from ltx_video_gpupoor_tpu_torch.serving import cli as tcli
from ltx_video_gpupoor_tpu_torch.serving import model_zoo as tzoo
from ltx_video_gpupoor_tpu_torch.serving import orchestrator as torch_orch
from ltx_video_gpupoor_tpu_torch.serving import server as tserver
from ltx_video_gpupoor_tpu_torch.serving import warmup as twarmup
from ltx_video_gpupoor_tpu_torch.utils import media as tmedia
from ltx_video_gpupoor_tpu_torch.utils import observability as tobs
from ltx_video_gpupoor_tpu_torch.utils import resolution as tres

import test_torch_ltx13b as slice13b   # its tiny configs, weights, helpers

torch.set_num_threads(2)

H, W, FRAMES = slice13b.H, slice13b.W, slice13b.FRAMES
weights = slice13b.weights             # the module-scoped fixture
identity_crf = slice13b.identity_crf


def _png_b64(image):
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _body(image, **over):
    body = {"image": _png_b64(image), "prompt": "a fox", "negative_prompt":
            "blurry", "height": H, "width": W, "num_frames": FRAMES,
            "frame_rate": 8, "num_inference_steps": 2, "creation_id": "t"}
    body.update(over)
    return body


def _captured(monkeypatch, media_mod, convert):
    """Keep the frames a service hands to ``save_video`` (RGB uint8)."""
    got = []
    real = media_mod.save_video

    def save(frames, path, fps=30.0, **kw):
        got.append(convert(*frames) if isinstance(frames, tuple)
                   else np.asarray(frames))
        return real(frames, path, fps=fps, **kw)

    monkeypatch.setattr(media_mod, "save_video", save)
    return got


class _QuietJaxGenerator(jorch.LTXVideoGenerator):
    def generate(self, *args, **kwargs):
        kwargs["image_cond_noise_scale"] = 0.0
        return super().generate(*args, **kwargs)


def _port_service(weights, tmp_path, emb, **kw):
    *_, mask, image, n1, n2 = weights
    gen, _ = slice13b._port_generator(weights, {}, FP32_POLICY)

    class Quiet(torch_orch.LTXVideoGenerator):
        def generate(self, *args, **kwargs):
            kwargs.update(image_cond_noise_scale=0.0, attn_mode="auto",
                          noise_pass1=torch.from_numpy(n1),
                          noise_pass2=torch.from_numpy(n2))
            return super().generate(*args, **kwargs)

    gen = Quiet(gen.pipeline, multiscale=gen.multiscale,
                pipeline_config=slice13b.CONFIG)
    return tserver.InferenceService(
        model=tzoo.LoadedModel(generator=gen),
        outputs_dir=str(tmp_path / "port_outputs"), **kw)


def test_inference_service_matches_jax(monkeypatch, tmp_path, weights,
                                       identity_crf):
    tf_p, vcfg, vae_p, ucfg, up_p, t5_p, ids, mask, image, n1, n2 = weights
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((2, 12, 32)).astype(np.float32)
    monkeypatch.setattr(jcli, "encode_or_hash", lambda pipe, p, n: (
        jnp.asarray(emb), jnp.asarray(mask)))
    monkeypatch.setattr(tcli, "encode_or_hash", lambda pipe, p, n: (
        torch.from_numpy(emb), torch.from_numpy(mask)))
    # JAX's tier here: the exact XLA attention (its CPU default); the
    # port's ``auto`` at head dim 128 is the int8 QK+PV tier, so pin both
    # to exact attention
    from ltx_video_gpupoor_tpu_torch.ops import attention as tattn

    monkeypatch.setattr(tattn, "_FORCED_MODE", "pallas")
    # where the native codec is built both servers fetch YUV420 planes
    # (chroma at half resolution); compare RGB with RGB
    from ltx_video_gpupoor_tpu_torch.utils import native_codec as tnative

    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    jframes = _captured(monkeypatch, jmedia, jmedia.yuv420_to_rgb)
    tframes = _captured(monkeypatch, tmedia, tmedia.yuv420_to_rgb)

    pipe = jpipe.LTXPipeline(
        transformer_params=tf_p,
        transformer_cfg=jtf.LTXTransformerConfig(**slice13b.TF_KW),
        vae_params=vae_p, vae_cfg=vcfg, vae_tile_size=slice13b.TILE)
    slice13b._NoiseMultiScale.noise = (n1, n2)
    jgen = _QuietJaxGenerator(
        pipe, multiscale=slice13b._NoiseMultiScale(pipe, up_p, ucfg),
        pipeline_config=slice13b.CONFIG)
    jsvc = jserver.InferenceService(
        model=jzoo.LoadedModel(generator=jgen),
        outputs_dir=str(tmp_path / "jax_outputs"), warmup_spec="off")
    tsvc = _port_service(weights, tmp_path, emb, warmup_spec="off")
    assert jsvc._warmup_thread is None and tsvc._warmup_thread is None

    body = _body(image)
    jstatus, jpayload = jsvc.run(dict(body), "http://host:1/")
    tstatus, tpayload = tsvc.run(dict(body), "http://host:1/")
    assert jstatus == tstatus == 200, (jpayload, tpayload)
    for payload, svc in ((jpayload, jsvc), (tpayload, tsvc)):
        assert isinstance(payload, list) and list(payload[0]) == ["video"]
        url = payload[0]["video"]
        assert url.startswith("http://host:1/download/video_") and \
            url.endswith(".mp4")
        path = svc.download_path(url.rsplit("/", 1)[1])
        assert path is not None and os.path.getsize(path) > 0
    a, b = jframes[0], tframes[0]
    assert a.shape == b.shape == (FRAMES, H, W, 3) and b.dtype == np.uint8
    db = slice13b._psnr(a.astype(np.float32) / 127.5 - 1,
                        b.astype(np.float32) / 127.5 - 1)
    print(f"served frames {db:.2f} dB")
    assert b.std() > 1.0 and db >= 40.0, db
    # the written mp4 reads back to the request's frames
    video = tmedia.load_video(tsvc.download_path(
        tpayload[0]["video"].rsplit("/", 1)[1]))
    assert video.shape == (FRAMES, H, W, 3)

    # the error answers, equal on both sides
    for bad in ({k: v for k, v in body.items() if k not in ("prompt",
                                                            "width")},
                ["not", "a", "dict"]):
        assert jsvc.run(bad, "http://host:1/") == tsvc.run(bad,
                                                           "http://host:1/")
    assert tsvc.run({k: v for k, v in body.items() if k != "image"},
                    "/") == (400, {"error": "Missing fields: image"})
    jbad = jsvc.run({**body, "image": "AAAA"}, "/")
    tbad = tsvc.run({**body, "image": "AAAA"}, "/")
    assert jbad[0] == tbad[0] == 500
    assert list(tbad[1][0]) == list(jbad[1][0]) == ["error"]
    for svc in (jsvc, tsvc):
        assert svc.download_path("../test_torch_serving.py") is None
        assert svc.download_path("missing.mp4") is None


@pytest.fixture(scope="module")
def demo_service(tmp_path_factory):
    """The port's service around its demo model on the CPU, with one
    warm-up bucket, behind the stdlib server on a real socket."""
    out = tmp_path_factory.mktemp("outputs")
    tobs.Metrics.reset()
    model = tzoo.build_demo_model(0, device="cpu")
    svc = tserver.InferenceService(model=model, outputs_dir=str(out),
                                   warmup_spec="64x64x9")
    svc._warmup_thread.join(timeout=120)
    httpd = tserver.create_stdlib_server(svc, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield svc, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join()


def _http(url, data=None):
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_stdlib_server_over_a_socket(demo_service):
    svc, root = demo_service
    image = np.random.default_rng(0).integers(0, 255, (64, 64, 3)).astype(
        np.uint8)
    status, payload, _ = _http(root + "/", json.dumps(_body(image)).encode())
    assert status == 200, payload
    url = json.loads(payload)[0]["video"]
    assert url.startswith(root + "/download/video_")
    status, mp4, headers = _http(url + "?utm=1")
    assert status == 200 and len(mp4) > 0
    assert headers["Content-Type"] == "video/mp4"
    assert int(headers["Content-Length"]) == len(mp4)
    path = svc.download_path(url.rsplit("/", 1)[1])
    assert tmedia.load_video(path).shape == (9, 64, 64, 3)
    status, payload, _ = _http(root + "/metrics")
    metrics = json.loads(payload)
    assert status == 200 and metrics["counters"]["requests_ok"] == 1
    gauges = metrics["gauges"]
    assert gauges["last_request_s"] > 0
    # the request's own record, after the warm-up's
    warm, record = metrics["requests"][-2:]
    assert warm["kind"] == "warmup" and record["kind"] == "request"
    assert record["creation_id"] == "t"
    seconds = tobs.stage_seconds(record)
    for name in ("read_image", "encode_prompt", "lock_wait", "generate",
                 "generate/pass1/denoise", "generate/upsample_adain",
                 "generate/pass2/denoise", "generate/vae_decode",
                 "generate/resize_quant_fetch", "save_video"):
        assert seconds[name] >= 0, name
    assert seconds["generate"] <= gauges["last_request_s"]


@pytest.mark.parametrize("method,path,data,status", [
    ("POST", "/", b'{"prompt": "x"}', 400),          # fields missing
    ("POST", "/", b"{not json", 400),
    ("POST", "/elsewhere", b"{}", 404),
    ("GET", "/download/..%2F..%2Fetc%2Fpasswd", None, 404),
    ("GET", "/download/missing.mp4", None, 404),
    ("GET", "/nothing", None, 404),
])
def test_stdlib_server_error_answers(demo_service, method, path, data, status):
    _, root = demo_service
    got, payload, _ = _http(root + path, data)
    assert got == status, payload
    assert "error" in json.loads(payload)


def test_parse_args_equal_jax_flag_for_flag():
    for argv in (["--prompt", "x"],
                 ["--prompt", "x", "--demo", "--attention", "pallas_hp",
                  "--height", "64", "--video-length", "9", "--teacache",
                  "1.75", "--bucket-resolution", "--int8-mode", "wo",
                  "--VAE-tile-size", "0", "--profile-type-id", "4"]):
        assert vars(tcli.parse_args(argv)) == vars(jcli.parse_args(argv))
    with pytest.raises(SystemExit):
        tcli.parse_args(["--prompt", "x", "--attention", "nope"])
    with pytest.raises(SystemExit):
        tcli.parse_args([])                       # --prompt is required


def test_cli_raises_for_what_is_not_ported(tmp_path, monkeypatch):
    """Every flag is ported (``--enhance-prompt`` since the prompt
    enhancers, tests/test_torch_prompt_enhance.py): an enhancer directory
    that holds no model raises, with no fallback; ``--teacache``,
    ``--save-quantized``, a run without ``--demo`` and the weight-only
    ``--int8-mode`` tiers (tests/test_torch_teacache.py,
    tests/test_torch_checkpoint.py, tests/test_torch_quant_tiers.py): on an
    empty checkpoint directory the loader names the missing file, and
    ``--int8-mode wo`` parses to the mode JAX's CLI hands
    ``quantize_params``."""
    base = ["--prompt", "x", "--device", "cpu"]
    monkeypatch.setenv("LTXV_TPU_ENHANCER_LLM_DIR", str(tmp_path / "no_lm"))
    with pytest.raises(FileNotFoundError, match="config.json"):
        tcli.main(base + ["--demo", "--enhance-prompt"])
    argv = base + ["--demo", "--quantize-transformer", "--int8-mode", "wo"]
    assert tcli.parse_args(argv).int8_mode == \
        jcli.parse_args(argv).int8_mode == "wo"
    with pytest.raises(FileNotFoundError, match="13B_dev_quanto"):
        tcli.main(base + ["--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("tier", ["pallas", "xla"])
def test_cli_demo_end_to_end(tmp_path, monkeypatch, tier):
    """The demo request end to end under ``--attention``; ``xla`` runs
    every attention through ``reference_attention`` and no kernel."""
    from ltx_video_gpupoor_tpu_torch.ops import attention as tattn

    calls = []
    plain = tattn.reference_attention
    monkeypatch.setattr(tattn, "reference_attention",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = str(tmp_path / "vid.mp4")
    try:
        path = tcli.main([
            "--prompt", "a cat", "--demo", "--device", "cpu", "--height",
            "64", "--width", "64", "--video-length", "9",
            "--num-inference-steps", "2", "--output-path", out,
            "--attention", tier])
        assert tattn.get_attention_mode() == tier
    finally:
        tattn.set_attention_mode("auto")
    assert path == out and os.path.getsize(out) > 0
    assert tmedia.load_video(out).shape == (9, 64, 64, 3)
    assert bool(calls) == (tier == "xla")


def test_hash_prompt_embeds_shape_and_determinism():
    emb, mask = tcli.hash_prompt_embeds("a fox", "blurry", 128, 32)
    jemb, jmask = jcli.hash_prompt_embeds("a fox", "blurry", 128, 32)
    assert tuple(emb.shape) == jemb.shape == (2, 128, 32)
    assert tuple(mask.shape) == jmask.shape and mask.dtype == torch.int32
    assert bool((mask == 1).all())
    again, _ = tcli.hash_prompt_embeds("a fox", "blurry", 128, 32)
    other, _ = tcli.hash_prompt_embeds("a dog", "blurry", 128, 32)
    assert torch.equal(emb, again)
    assert torch.equal(emb[0], other[0]) and not torch.equal(emb[1], other[1])
    assert abs(float(emb.std()) - 1.0) < 0.05


def test_parse_buckets_and_warmup_equal_jax():
    for spec in ("", "off", "0", "none", "default", "704x480x121",
                 " 512x512x57 , default,64x64x9", None):
        assert twarmup.parse_buckets(spec) == jwarmup.parse_buckets(spec)
    assert twarmup.DEFAULT_BUCKET == jwarmup.DEFAULT_BUCKET
    with pytest.raises(ValueError):
        twarmup.parse_buckets("64x64")
    assert twarmup.start_background_warmup(None, spec="off") is None


def test_warmup_runs_each_bucket_under_the_lock():
    model = tzoo.build_demo_model(1, device="cpu")
    gen = model.generator
    seen = []
    real = gen.generate
    lock = threading.Lock()

    def generate(*a, **k):
        seen.append((k["width"], k["height"], k["frame_num"],
                     k["sampling_steps"], k["image_start"].shape,
                     lock.locked()))
        if k["width"] == 32:
            raise RuntimeError("a bad bucket must not stop the warm-up")
        return real(*a, **k)

    gen.generate = generate
    tobs.Metrics.reset()
    sec = twarmup.warmup_shapes(gen, [(64, 64, 9), (32, 32, 9), (96, 64, 9)],
                                lock=lock)
    assert sec > 0 and not lock.locked()
    counters = tobs.Metrics.snapshot()["counters"]
    assert counters["warmup_ok"] == 2 and counters["warmup_failed"] == 1
    assert seen == [(64, 64, 9, 1, (64, 64, 3), True),
                    (32, 32, 9, 1, (32, 32, 3), True),
                    (96, 64, 9, 1, (64, 96, 3), True)]


def test_select_model_files_equal_jax():
    for mode in ("ltxv_13B", "ltxv_13B_distilled"):
        for quant in ("int8", "bf16", "", "fp8"):
            assert tzoo.select_model_files(mode, quant) == \
                jzoo.select_model_files(mode, quant), (mode, quant)
    assert tzoo.TRANSFORMER_CHOICES == jzoo.TRANSFORMER_CHOICES
    assert tzoo.TEXT_ENCODER_CHOICES == jzoo.TEXT_ENCODER_CHOICES
    assert tzoo.MODEL_SIGNATURES == jzoo.MODEL_SIGNATURES
    with pytest.raises(KeyError):
        tzoo.select_model_files("no_such_mode")
    with pytest.raises(FileNotFoundError, match="x.safetensors"):
        tzoo.load_ltxv_model("x.safetensors", ckpt_dir="no_such_dir",
                             device="cpu")


def test_resolution_and_interrupt_are_pinned_copies():
    for base in (512, 768, 1024):
        assert tres.aspect_ratio_bins(base) == jres.aspect_ratio_bins(base)
    for h, w, f in ((480, 704, 121), (704, 480, 97), (70, 50, 9),
                    (1080, 1920, 2), (333, 333, 1), (720, 1280, 257)):
        assert tres.bucketed_dimensions(h, w, f) == \
            jres.bucketed_dimensions(h, w, f)
        assert tres.snap_to_bin(h, w) == jres.snap_to_bin(h, w)

    def code(mod):
        src = inspect.getsource(mod)
        return src[src.index("from __future__"):]

    assert code(tinterrupt) == code(jinterrupt)


def test_generate_buckets_the_resolution():
    """``bucket_resolution=True`` snaps the request as JAX's orchestrator
    does: 70x50x9 becomes the 512-base bin of its aspect ratio."""
    gen = tzoo.build_demo_model(2, device="cpu").generator
    gen.pipeline_config = {
        "pipeline_type": "base", "guidance_scale": 1, "stg_scale": 0,
        "rescaling_scale": 1, "timesteps": [1.0, 0.5],
        "decode_timestep": 0.0, "stochastic_sampling": False}
    emb, mask = tcli.hash_prompt_embeds("p", "n", 16, 32)
    h, w, f = jres.bucketed_dimensions(70, 50, 9)
    lat = gen.generate(emb, mask, height=70, width=50, frame_num=9,
                       bucket_resolution=True, output_type="latent")
    assert tuple(lat.shape) == (1, (f - 1) // 8 + 1, h // 32, w // 32, 8)
    plain = gen.generate(emb, mask, height=70, width=50, frame_num=9,
                         output_type="latent")
    assert tuple(plain.shape) == (1, 2, 3, 2, 8)        # padded to 96x64
    with pytest.raises(ValueError, match="output_type"):
        gen.generate(emb, mask, height=64, width=64, frame_num=9,
                     output_type="gif")


def test_yuv420_planes_equal_jax():
    rng = np.random.default_rng(3)
    frames = np.clip(rng.normal(0, 0.5, (3, 16, 24, 3)), -1, 1).astype(
        np.float32)
    want = [np.asarray(p) for p in jorch._rgb_to_yuv420(jnp.asarray(frames))]
    got = [p.numpy() for p in torch_orch._rgb_to_yuv420(
        torch.from_numpy(frames))]
    for a, b in zip(want, got):
        assert a.shape == b.shape and b.dtype == np.uint8
        # a code may round the other way where the fp32 sums differ
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
    assert np.array_equal(tmedia.yuv420_to_rgb(*want),
                          jmedia.yuv420_to_rgb(*want))
    # the orchestrator's yuv420 output is its pixels output in planes
    gen = tzoo.build_demo_model(3, device="cpu").generator
    emb, mask = tcli.hash_prompt_embeds("p", "n", 16, 32)
    kw = dict(height=64, width=64, frame_num=9, sampling_steps=1, seed=1,
              image_cond_noise_scale=0.0)
    planes = gen.generate(emb, mask, output_type="yuv420", **kw)
    pixels = gen.generate(emb, mask, output_type="pixels", **kw)
    assert [p.shape for p in planes] == [(9, 64, 64), (9, 32, 32),
                                         (9, 32, 32)]
    # (random weights paint noise, which chroma subsampling does not
    # keep: hold the luma plane, which is sampled at every pixel)
    rgb = pixels.astype(np.float32)
    luma = 16.0 + (65.481 * rgb[..., 0] + 128.553 * rgb[..., 1]
                   + 24.966 * rgb[..., 2]) / 255.0
    # where no channel saturates (the planes come from the unclipped
    # floats, as in JAX; the uint8 pixels are clipped)
    inside = ((pixels > 0) & (pixels < 255)).all(axis=-1)
    assert inside.mean() > 0.5
    assert np.abs(luma - planes[0].astype(np.float32))[inside].max() < 2.0
    assert tmedia.yuv420_to_rgb(*planes).shape == pixels.shape
    # odd target dims fall back to RGB frames
    odd = gen.generate(emb, mask, output_type="yuv420",
                       **{**kw, "height": 63, "width": 63})
    assert isinstance(odd, np.ndarray) and odd.shape == (9, 63, 63, 3)


def test_save_video_load_video_round_trip(tmp_path):
    yy, xx = np.mgrid[0:64, 0:96]
    frames = np.stack([np.stack([128 + 100 * np.sin(xx / 9.0 + t / 3.0),
                                 128 + 100 * np.cos(yy / 7.0),
                                 (xx + yy + 4 * t) * 255.0 / 200], axis=-1)
                       for t in range(9)]).clip(0, 255).astype(np.uint8)
    path = tmedia.save_video(frames, str(tmp_path / "a.mp4"), fps=8)
    back = tmedia.load_video(path)
    assert back.shape == (9, 64, 96, 3) and back.dtype == np.float32
    assert -1.0 <= back.min() and back.max() <= 1.0
    err = np.abs((back + 1) * 127.5 - frames).mean()
    assert err < 8.0, err                      # a lossy codec, not noise
    # float frames in [-1, 1] and YUV planes go through the same writer
    tmedia.save_video(frames.astype(np.float32) / 127.5 - 1,
                      str(tmp_path / "b.mp4"), fps=8)
    y, u, v = (p.numpy() for p in torch_orch._rgb_to_yuv420(
        torch.from_numpy(frames.astype(np.float32) / 127.5 - 1)))
    tmedia.save_video((y, u, v), str(tmp_path / "c.mp4"), fps=8)
    for name in ("b.mp4", "c.mp4"):
        again = tmedia.load_video(str(tmp_path / name))
        assert again.shape == back.shape
        assert np.abs(again - back).mean() < 0.06
    with pytest.raises(RuntimeError, match="no frames"):
        tmedia.load_video(str(tmp_path / "absent.mp4"))


def test_interrupt_stops_a_run_between_steps():
    pipe = tzoo.build_demo_model(4, device="cpu").generator.pipeline
    emb, mask = tcli.hash_prompt_embeds("p", "n", 16, 32)
    flag = tinterrupt.InterruptFlag()
    steps = []

    def progress(i, n):
        steps.append((i, n))
        if i == 1:
            flag.interrupt()

    kw = dict(height=64, width=64, num_frames=9, guidance_scale=1.0,
              timesteps=[1.0, 0.8, 0.6, 0.4, 0.2])
    with pytest.raises(tinterrupt.Interrupted):
        pipe.generate(emb, mask, interrupt_flag=flag,
                      progress_callback=progress, **kw)
    assert steps == [(0, 5), (1, 5)]           # stopped before step 2
    flag.clear()
    steps.clear()
    lat = pipe.generate(emb, mask, interrupt_flag=flag,
                        progress_callback=lambda i, n: steps.append(i), **kw)
    assert steps == [0, 1, 2, 3, 4] and torch.isfinite(lat).all()


def test_stage_marks_and_metrics():
    tobs.clear()
    with tobs.request("request"):
        with tobs.stage("outer"):
            with tobs.stage("inner"):
                pass
        # another thread starts outside any request: its marks are no-ops
        other = threading.Thread(target=lambda: tobs.stage("x").__enter__())
        other.start()
        other.join()
    [record] = tobs.records()
    assert [(s["name"], s["parent"]) for s in record["spans"]] == [
        ("request", None), ("outer", 0), ("inner", 1)]
    assert list(tobs.stage_seconds(record)) == ["outer", "outer/inner"]
    with tobs.stage("ignored"):                # no request: a no-op
        pass
    assert len(tobs.records()) == 1
    tobs.Metrics.reset()
    tobs.Metrics.inc("n")
    tobs.Metrics.inc("n", 2)
    tobs.Metrics.set("g", 0.5)
    assert json.loads(tobs.Metrics.to_json()) == {
        "counters": {"n": 3.0}, "gauges": {"g": 0.5}}
    assert tobs.snapshot() == {"counters": {"n": 3.0}, "gauges": {"g": 0.5},
                               "requests": tobs.records()}
    tobs.Metrics.reset()
