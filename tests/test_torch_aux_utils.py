"""The port's copies of the JAX package's framework-free helpers return
what the originals return, bit for bit where they are numpy:
``utils/qwen_vl.py`` (``smart_resize``, ``smart_nframes``, ``fetch_image``
in its forms, ``fetch_video`` from frames, ``process_vision_info``,
``preprocess_image``), ``utils/matting.py`` (``build_trimap``,
``refine_alpha``), ``utils/video_ops.py`` (``resample``, also as
``utils/vace.py``'s, ``save_webp``, the legacy sincos tables),
``utils/tokenizers.py``, ``utils/prompt_templates.py``, ``utils/tasks.py``,
``serving/upload.py`` and ``serving/deploy.py`` (the card in place of
the TPU slice; ``entrypoint`` serving the port's ``InferenceService``).
"""

import base64
import io
import os
import time

import numpy as np
import pytest
from PIL import Image

from ltx_video_gpupoor_tpu.serving import upload as jup
from ltx_video_gpupoor_tpu.utils import matting as jm
from ltx_video_gpupoor_tpu.utils import prompt_templates as jpt
from ltx_video_gpupoor_tpu.utils import qwen_vl as jq
from ltx_video_gpupoor_tpu.utils import tokenizers as jtok
from ltx_video_gpupoor_tpu.utils import video_ops as jvo
from ltx_video_gpupoor_tpu_torch.serving import deploy as tdeploy
from ltx_video_gpupoor_tpu_torch.serving import upload as tup
from ltx_video_gpupoor_tpu_torch.utils import matting as tm
from ltx_video_gpupoor_tpu_torch.utils import prompt_templates as tpt
from ltx_video_gpupoor_tpu_torch.utils import qwen_vl as tq
from ltx_video_gpupoor_tpu_torch.utils import tasks as ttasks
from ltx_video_gpupoor_tpu_torch.utils import tokenizers as ttok
from ltx_video_gpupoor_tpu_torch.utils import vace as tvace
from ltx_video_gpupoor_tpu_torch.utils import video_ops as tvo


@pytest.mark.parametrize("h,w", [(480, 832), (37, 53), (1080, 1920),
                                 (28, 28 * 250)])
def test_smart_resize_equal_jax(h, w):
    if w / h > jq.MAX_RATIO:
        with pytest.raises(ValueError):
            jq.smart_resize(h, w)
        with pytest.raises(ValueError):
            tq.smart_resize(h, w)
        return
    for kw in ({}, dict(min_pixels=256 * 28 * 28, max_pixels=1280 * 28 * 28)):
        assert tq.smart_resize(h, w, **kw) == jq.smart_resize(h, w, **kw)


def test_smart_nframes_equal_jax():
    for ele, total, fps in (({"fps": 2.0}, 120, 30.0),
                            ({"nframes": 9}, 40, 24.0),
                            ({}, 300, 30.0)):
        assert tq.smart_nframes(ele, total, fps) == \
            jq.smart_nframes(ele, total, fps)


def test_fetch_image_and_preprocess_equal_jax(tmp_path):
    arr = np.random.default_rng(0).integers(0, 255, (61, 95, 3)).astype(
        np.uint8)
    path = tmp_path / "im.png"
    Image.fromarray(arr).save(path)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    uri = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    for image in (Image.fromarray(arr), str(path), "file://" + str(path),
                  uri):
        ele = {"image": image, "min_pixels": 56 * 56, "max_pixels": 112 * 168}
        a, b = tq.fetch_image(ele), jq.fetch_image(ele)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    pa, ga = tq.preprocess_image(arr, min_pixels=56 * 56,
                                 max_pixels=112 * 168)
    pb, gb = jq.preprocess_image(arr, min_pixels=56 * 56,
                                 max_pixels=112 * 168)
    assert ga == gb
    np.testing.assert_array_equal(pa, pb)


def test_fetch_video_and_process_vision_info_equal_jax():
    frames = [Image.fromarray(np.full((37, 53, 3), i * 20, np.uint8))
              for i in range(3)]
    a = tq.fetch_video({"video": frames})
    b = jq.fetch_video({"video": frames})
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    msgs = [{"role": "user", "content": [
        {"type": "image", "image": frames[0]},
        {"type": "video", "video": frames},
        {"type": "text", "text": "a cat"}]}]
    (ia, va), (ib, vb) = tq.process_vision_info(msgs), \
        jq.process_vision_info(msgs)
    assert len(ia) == len(ib) == 1 and len(va) == len(vb) == 1
    np.testing.assert_array_equal(np.asarray(ia[0]), np.asarray(ib[0]))


def _disc(h=48, w=56, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot(yy - h / 2, xx - w / 2)
    alpha = np.clip((16 - r) / 4 + 0.5, 0, 1).astype(np.float32)
    img = (alpha[..., None] * np.array([220, 60, 40])
           + (1 - alpha[..., None]) * np.array([30, 120, 200])
           + rng.normal(0, 5, (h, w, 3)))
    return np.clip(img, 0, 255).astype(np.uint8), alpha


@pytest.mark.parametrize("erode", [0, 1, 3])
def test_matting_equal_jax_bit_for_bit(erode):
    img, alpha = _disc()
    np.testing.assert_array_equal(tm.build_trimap(alpha, erode_size=erode),
                                  jm.build_trimap(alpha, erode_size=erode))
    np.testing.assert_array_equal(
        tm.refine_alpha(img, alpha, erode_size=erode),
        jm.refine_alpha(img, alpha, erode_size=erode))


@pytest.mark.parametrize("args", [(30.0, 120, 16, 16.0), (10.0, 40, 0, 16.0),
                                  (24.0, 97, 33, 16.0, 5),
                                  (16.0, 81, 81, 16.0)])
def test_resample_equal_jax_and_one_copy(args):
    assert tvo.resample(*args) == jvo.resample(*args)
    assert tvace.resample is tvo.resample


def test_sincos_tables_equal_jax():
    t = np.array([0.0, 1.5, 999.0])
    for kw in ({}, dict(flip_sin_to_cos=True, downscale_freq_shift=0.0),
               dict(scale=2.0)):
        for dim in (32, 33):
            np.testing.assert_array_equal(
                tvo.get_timestep_embedding(t, dim, **kw),
                jvo.get_timestep_embedding(t, dim, **kw))
    grid = np.stack(np.meshgrid(np.arange(2), np.arange(3), np.arange(4),
                                indexing="ij")).reshape(3, -1)
    for dim in (48, 49, 64):
        np.testing.assert_array_equal(
            tvo.get_3d_sincos_pos_embed(dim, grid, 4, 3, 2),
            jvo.get_3d_sincos_pos_embed(dim, grid, 4, 3, 2))


def test_save_webp_equal_jax(tmp_path):
    frames = np.random.default_rng(1).uniform(-1, 1, (3, 16, 24, 3)).astype(
        np.float32)
    a = tvo.save_webp(frames, str(tmp_path / "a.webp"))
    b = jvo.save_webp(frames, str(tmp_path / "b.webp"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("text", ["  Hello,   World!  ", "snake_case &amp; x",
                                  "a.b, c! d"])
def test_tokenizer_cleaning_equal_jax(text):
    assert ttok.basic_clean(text) == jtok.basic_clean(text)
    assert ttok.whitespace_clean(text) == jtok.whitespace_clean(text)
    for keep in (None, "."):
        assert ttok.canonicalize(text, keep) == jtok.canonicalize(text, keep)


def test_hf_tokenizer_wrapper_equal_jax(tmp_path):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"[PAD]": 0, "[UNK]": 1, "</s>": 2}
    for w in "hello world a cat snake case".split():
        vocab[w] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]",
                            unk_token="[UNK]", eos_token="</s>"
                            ).save_pretrained(str(tmp_path))
    for clean in (None, "whitespace", "lower", "canonicalize"):
        t = ttok.HuggingfaceTokenizer(str(tmp_path), seq_len=6, clean=clean)
        j = jtok.HuggingfaceTokenizer(str(tmp_path), seq_len=6, clean=clean)
        for seq in ("Hello   world", ["a cat", "snake_case x y z w v"]):
            for a, b in zip(t(seq, return_mask=True),
                            j(seq, return_mask=True)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("text", [
    "plain prompt",
    '!{animal}="cat","dog"\n!{color}="red","blue","green"\na {color} {animal}',
    '!{x}="a"\n!{bad',
])
def test_process_template_equal_jax(text):
    assert tpt.process_template(text) == jpt.process_template(text)


def test_tasks_copy_behaves():
    results = []
    ttasks.async_run(results.append, 42)
    deadline = time.time() + 2
    while not results and time.time() < deadline:
        time.sleep(0.01)
    assert results == [42]
    q = ttasks.FIFOQueue()
    q.push("a", 1)
    q.push("b", 2)
    assert q.top() == ("a", 1) and q.pop() == ("a", 1)
    assert q.pop() == ("b", 2) and q.pop() == (None, None)
    s = ttasks.AsyncStream()
    s.output_queue.push("progress", 3)
    assert s.output_queue.pop() == ("progress", 3)


@pytest.mark.parametrize("mode", ["ltxv_13B_distilled", "ltxv_13B"])
def test_upload_file_list_equal_jax(mode, tmp_path):
    assert tup.required_files(mode) == jup.required_files(mode)
    status = tup.provision(mode, ckpt_dir=str(tmp_path), download=False)
    assert status == jup.provision(mode, ckpt_dir=str(tmp_path),
                                   download=False)
    assert set(status.values()) == {"missing"}


def test_deploy_spec_names_the_card(monkeypatch):
    spec = tdeploy.DeploySpec()
    assert "H100" in spec.accelerator and spec.workers == 1
    started = {}

    class Server:
        def serve_forever(self):
            started["served"] = True

    def create(service, port):
        started.update(service=service, port=port)
        return Server()

    from ltx_video_gpupoor_tpu_torch.serving import server as tserver

    monkeypatch.setattr(tserver, "InferenceService", lambda: "service")
    monkeypatch.setattr(tserver, "create_stdlib_server", create)
    for k, _ in spec.env:
        monkeypatch.delenv(k, raising=False)
    tdeploy.entrypoint(spec)
    assert started == {"service": "service", "port": 7860, "served": True}
    assert os.environ["MODEL_MODE"] == "ltxv_13B_distilled"
