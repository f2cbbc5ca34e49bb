"""The prompt enhancers in the port against the JAX package on the CPU:
tiny HF-layout model directories (the port's safetensors writer,
``tools/synthetic_ckpt.py``) with a ``tokenizers`` WordLevel tokenizer
loaded by ``transformers.AutoTokenizer``, as users point
``LTXV_TPU_ENHANCER_LLM_DIR`` / ``LTXV_TPU_CAPTIONER_DIR`` /
``LTXV_TPU_EXTENDER_*_DIR`` at published checkpoints. In fp32 both
packages give the same text: ``ChatLM`` greedy and sampled (JAX's Gumbel
noise handed over), ``FlorenceCaptioner`` (greedy), ``VLChat`` (greedy).
Then the enhancer's gate and i2v layout, the CLI's ``--demo
--enhance-prompt`` with the directories set and without them, the
server's ``enhance_prompt`` through ``InferenceService``, and the rule
that nothing falls back: a configured model that raises makes the call
raise. Texts and tokens are held equal exactly.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.utils import prompt_enhance as jpe
from ltx_video_gpupoor_tpu_torch.models import llm as tl
from ltx_video_gpupoor_tpu_torch.tools import synthetic_ckpt as sc
from ltx_video_gpupoor_tpu_torch.utils import prompt_enhance as tpe

LLM_CFG = tl.LLMConfig(vocab_size=96, dim=32, num_layers=2, num_heads=4,
                       num_kv_heads=2, ffn_dim=64, rope_theta=10000.0,
                       rms_eps=1e-6, qkv_bias=True, tie_embeddings=True)
FLORENCE_HF = {
    "vision_config": {"depths": [1, 1], "patch_size": [7, 3],
                      "patch_stride": [4, 8], "patch_padding": [3, 1],
                      "patch_prenorm": [False, True], "embed_dim": [16, 32],
                      "num_heads": [2, 4], "num_groups": [2, 4],
                      "window_size": 4, "mlp_ratio": 2.0,
                      "projection_dim": 24, "max_position_embeddings": 32},
    "text_config": {"vocab_size": 120, "d_model": 24, "encoder_layers": 1,
                    "decoder_layers": 1, "encoder_attention_heads": 4,
                    "encoder_ffn_dim": 40, "max_position_embeddings": 1024,
                    "forced_eos_token_id": 2},
    "image_token_id": 120,
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokenizer(d, words, special, chat_template=None, **cfg):
    """A WordLevel tokenizer: ``special`` ids first, then ``words``."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {t: i for i, t in enumerate(special + words)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(os.path.join(d, "tokenizer.json"))
    conf = {"tokenizer_class": "PreTrainedTokenizerFast",
            "unk_token": "<unk>", **cfg}
    if chat_template:
        conf["chat_template"] = chat_template
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump(conf, f)


@pytest.fixture(scope="module")
def llm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("llm"))
    sc.write_hf_llm_dir(d, LLM_CFG, seed=1)
    _tokenizer(d, [f"w{i}" for i in range(90)], ["<eos>", "<unk>"],
               chat_template=("{% for m in messages %}{{ m['content'] }} "
                              "{% endfor %}{% if add_generation_prompt %}"
                              "w7{% endif %}"), eos_token="<eos>")
    return d


@pytest.fixture(scope="module")
def florence_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("florence"))
    sc.write_hf_florence_dir(d, FLORENCE_HF, seed=2)
    words = [w for w in "Describe in detail what is shown the image .".split()]
    _tokenizer(d, words + [f"c{i}" for i in range(100)],
               ["<s>", "<pad>", "</s>", "<unk>"], bos_token="<s>",
               eos_token="</s>", pad_token="<pad>")
    return d


def _image(h=48, w=64, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3)).astype(
        np.uint8)


def test_prompts_and_gate_equal_jax():
    assert tpe.T2V_CINEMATIC_PROMPT == jpe.T2V_CINEMATIC_PROMPT
    assert tpe.I2V_CINEMATIC_PROMPT == jpe.I2V_CINEMATIC_PROMPT
    assert tpe.QwenPromptExpander.SYSTEM_EN == \
        jpe.QwenPromptExpander.SYSTEM_EN
    assert tpe.QwenVLPromptExpander.SYSTEM_EN == \
        jpe.QwenVLPromptExpander.SYSTEM_EN
    for p in ("a cat", " ".join(["w"] * 119), " ".join(["w"] * 120)):
        assert tpe.should_enhance(p) == jpe.should_enhance(p)


def test_chat_lm_greedy_text_equals_jax(llm_dir):
    lm = tpe.ChatLM.from_dir(llm_dir, dtype=torch.float32, device="cpu",
                             max_new_tokens=12)
    ref = jpe.JaxChatLM.from_dir(llm_dir, dtype=None, max_new_tokens=12)
    out = lm.chat("w1 w2", "w3 w4", temperature=0.0)
    assert out == ref.chat("w1 w2", "w3 w4", temperature=0.0)
    assert lm.eos_ids == ref.eos_ids == (0,)
    assert 0 < lm.last_new_tokens <= 12


def test_chat_lm_sampled_text_equals_jax(llm_dir):
    """JaxChatLM draws its Gumbel noise from ``split(key(seed), n)``;
    handed over, the port's sampled text is JAX's."""
    n, seed = 10, 3
    lm = tpe.ChatLM.from_dir(llm_dir, dtype=torch.float32, device="cpu",
                             max_new_tokens=n)
    ref = jpe.JaxChatLM.from_dir(llm_dir, dtype=None, max_new_tokens=n)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (1, 96), jnp.float32))
                       for k in jax.random.split(jax.random.key(seed), n)])
    out = lm.chat("w5", "w6 w9", temperature=0.7,
                  gumbel=torch.from_numpy(gumbel))
    assert out == ref.chat("w5", "w6 w9", temperature=0.7, seed=seed)


def test_florence_caption_equals_jax(florence_dir):
    cap = tpe.FlorenceCaptioner.from_dir(florence_dir, dtype=torch.float32,
                                         device="cpu", max_new_tokens=10,
                                         image_size=64)
    ref = jpe.JaxFlorenceCaptioner.from_dir(florence_dir, dtype=None,
                                            max_new_tokens=10, image_size=64)
    img = _image()
    np.testing.assert_array_equal(cap.preprocess(img), ref.preprocess(img))
    out = cap.caption(img)
    assert out == ref.caption(img)
    assert cap.last_new_tokens > 0


def _vl_dir(root):
    from ltx_video_gpupoor_tpu_torch.core.checkpoint import save_safetensors
    from ltx_video_gpupoor_tpu_torch.models import qwen25_vl as tq

    hf = {"vision_config": {"depth": 2, "hidden_size": 16,
                            "intermediate_size": 24, "num_heads": 2,
                            "out_hidden_size": 24,
                            "fullatt_block_indexes": [1]},
          "text_config": {"vocab_size": 160, "hidden_size": 24,
                          "num_hidden_layers": 2, "num_attention_heads": 4,
                          "num_key_value_heads": 2, "intermediate_size": 40,
                          "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
                          "tie_word_embeddings": True,
                          "rope_scaling": {"mrope_section": [1, 1, 1]}},
          "image_token_id": 151, "video_token_id": 152,
          "vision_start_token_id": 150}
    cfg = tq.config_from_hf(hf)
    model = tq.init_params(tq.QwenVL(cfg, device="cpu", dtype=torch.float32),
                           torch.Generator().manual_seed(4))
    sd = model.state_dict()
    out = {"model.visual." + theirs: sd[ours]
           for ours, theirs in tq.hf_vision_names(cfg.vision).items()}
    out["model.visual.patch_embed.proj.weight"] = \
        sd["vision.patch_embed.weight"].reshape(16, 3, 2, 14, 14)
    for ours, theirs in tl.hf_names(cfg.text).items():
        out[theirs.replace("model.", "model.language_model.", 1)] = \
            sd["text." + ours]
    save_safetensors(os.path.join(root, "model.safetensors"),
                     {k: v.contiguous() for k, v in out.items()})
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(hf, f)
    special = {"<|vision_start|>": 150, "<|image_pad|>": 151,
               "<|video_pad|>": 152, "<|vision_end|>": 153,
               "<|im_start|>": 154, "<|im_end|>": 155, "<eos>": 156,
               "<unk>": 157}
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {f"w{i}": i for i in range(150)}
    vocab.update(special)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(os.path.join(root, "tokenizer.json"))
    with open(os.path.join(root, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "eos_token": "<eos>", "unk_token": "<unk>"}, f)
    return root


def test_vl_chat_text_equals_jax(tmp_path):
    d = _vl_dir(str(tmp_path))
    kw = dict(max_new_tokens=8, min_pixels=56 * 56, max_pixels=56 * 84)
    vl = tpe.VLChat.from_dir(d, dtype=torch.float32, device="cpu", **kw)
    ref = jpe.JaxVLChat.from_dir(d, dtype=None, **kw)
    from PIL import Image

    img = Image.fromarray(_image(60, 90, 1))
    out = vl.chat_with_image("w1 w2", "w3", img)
    assert out == ref.chat_with_image("w1 w2", "w3", img)
    exp = tpe.QwenVLPromptExpander(vl=vl)
    assert exp.extend_with_img("w3", img, seed=0, system_prompt="w1 w2") == \
        (out or "w3")


def test_enhancer_i2v_and_t2v(llm_dir, florence_dir, monkeypatch):
    """The caption of the first frame and the i2v rewrite, from the
    environment's directories; the gate; the t2v layout."""
    monkeypatch.setenv("LTXV_TPU_ENHANCER_LLM_DIR", llm_dir)
    monkeypatch.setenv("LTXV_TPU_CAPTIONER_DIR", florence_dir)
    enh = tpe.PromptEnhancer(max_new_tokens=6, device="cpu")
    img = _image()
    calls = []
    real_chat = tpe.ChatLM.chat
    monkeypatch.setattr(tpe.ChatLM, "chat", lambda self, s, u, **k: (
        calls.append((s, u)) or real_chat(self, s, u, **k)))
    out = enh.enhance("w3 w4", first_frames=[img])
    caption = enh.captioner.caption(img)
    assert calls[0] == (tpe.I2V_CINEMATIC_PROMPT,
                        f"user_prompt: w3 w4\nimage_caption: {caption}")
    assert out == (real_chat(enh.lm, *calls[0], temperature=0.7) or "w3 w4")
    assert enh.lm.model.device.type == "cpu"
    long = " ".join(["w1"] * 130)
    assert enh.enhance(long) is long
    enh.enhance("w5")
    assert calls[-1] == (tpe.T2V_CINEMATIC_PROMPT, "user_prompt: w5")


def test_enhancers_without_models_warn_once(monkeypatch, caplog):
    for var in ("LTXV_TPU_ENHANCER_LLM_DIR", "LTXV_TPU_CAPTIONER_DIR",
                "LTXV_TPU_EXTENDER_LLM_DIR", "LTXV_TPU_EXTENDER_VL_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tpe, "_warned", set())
    with caplog.at_level(logging.WARNING):
        enh = tpe.PromptEnhancer()
        for _ in range(2):
            assert enh.enhance("a cat") == "a cat"
            assert enh.enhance("a cat", first_frames=[_image()]) == "a cat"
        assert tpe.QwenPromptExpander().extend("a dog") == "a dog"
        assert tpe.QwenVLPromptExpander().extend_with_img(
            "a dog", _image()) == "a dog"
    text = [r.getMessage() for r in caplog.records]
    for var in ("LTXV_TPU_ENHANCER_LLM_DIR", "LTXV_TPU_CAPTIONER_DIR",
                "LTXV_TPU_EXTENDER_LLM_DIR", "LTXV_TPU_EXTENDER_VL_DIR"):
        assert sum(var in t for t in text) == 1, (var, text)


class _Broken:
    def __getattr__(self, name):
        def fail(*a, **k):
            raise RuntimeError(f"a device fault in {name}")
        return fail


def test_no_fallback_hides_a_fault(llm_dir, florence_dir, tmp_path):
    """A configured model that raises makes the call raise (JAX falls
    through to a Hub model); a configured directory without a model
    too."""
    enh = tpe.PromptEnhancer(lm=_Broken(), captioner=_Broken())
    with pytest.raises(RuntimeError, match="fault in caption"):
        enh.enhance("a cat", first_frames=[_image()])
    with pytest.raises(RuntimeError, match="fault in chat"):
        enh.enhance("a cat")
    with pytest.raises(RuntimeError, match="fault in chat"):
        tpe.QwenPromptExpander(lm=_Broken()).extend("a cat")
    with pytest.raises(RuntimeError, match="fault in chat_with_image"):
        tpe.QwenVLPromptExpander(vl=_Broken()).extend_with_img("a", _image())
    with pytest.raises(FileNotFoundError):
        tpe.PromptEnhancer(llm_dir=str(tmp_path), device="cpu").enhance("x")
    with pytest.raises(FileNotFoundError):
        tpe.PromptEnhancer(captioner_dir=str(tmp_path), device="cpu").enhance(
            "x", first_frames=[_image()])


@pytest.mark.parametrize("configured", [True, False])
def test_cli_demo_enhance_prompt(llm_dir, florence_dir, tmp_path,
                                 monkeypatch, capsys, caplog, configured):
    from PIL import Image

    from ltx_video_gpupoor_tpu_torch.serving import cli as tcli

    for var, d in (("LTXV_TPU_ENHANCER_LLM_DIR", llm_dir),
                   ("LTXV_TPU_CAPTIONER_DIR", florence_dir)):
        if configured:
            monkeypatch.setenv(var, d)
        else:
            monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tpe, "_warned", set())
    seen = []
    real = tcli.encode_or_hash
    monkeypatch.setattr(tcli, "encode_or_hash",
                        lambda pipe, p, n: seen.append(p) or real(pipe, p, n))
    png = tmp_path / "start.png"
    Image.fromarray(_image(64, 64)).save(png)
    out = str(tmp_path / "v.mp4")
    with caplog.at_level(logging.WARNING):
        tcli.main(["--prompt", "w3 w4", "--demo", "--device", "cpu",
                   "--height", "64", "--width", "64", "--video-length", "9",
                   "--num-inference-steps", "2", "--image-start", str(png),
                   "--enhance-prompt", "--output-path", out])
    warned = [r.getMessage() for r in caplog.records
              if "LTXV_TPU_CAPTIONER_DIR" in r.getMessage()]
    assert os.path.getsize(out) > 0
    printed = capsys.readouterr().out
    if configured:
        assert seen[0] != "w3 w4" and f"enhanced prompt: {seen[0]}" in printed
        assert not warned
    else:
        assert seen == ["w3 w4"] and "enhanced prompt" not in printed
        assert len(warned) == 1


def test_server_enhance_prompt(llm_dir, florence_dir, tmp_path, monkeypatch):
    """``enhance_prompt`` through ``InferenceService.run``: the enhancer
    set on the service (models prebuilt), the rewrite handed to the text
    encoding, the stage in the metrics; a request without the field keeps
    its prompt."""
    import base64
    import io

    from PIL import Image

    from ltx_video_gpupoor_tpu_torch.serving import cli as tcli
    from ltx_video_gpupoor_tpu_torch.serving import model_zoo as tzoo
    from ltx_video_gpupoor_tpu_torch.serving import server as tserver
    from ltx_video_gpupoor_tpu_torch.utils import observability as tobs

    svc = tserver.InferenceService(
        model=tzoo.build_demo_model(0, device="cpu"),
        outputs_dir=str(tmp_path), warmup_spec="off")
    svc.enhancer = tpe.PromptEnhancer(
        lm=tpe.ChatLM.from_dir(llm_dir, dtype=torch.float32, device="cpu",
                               max_new_tokens=6),
        captioner=tpe.FlorenceCaptioner.from_dir(
            florence_dir, dtype=torch.float32, device="cpu",
            max_new_tokens=6))
    seen = []
    real = tcli.encode_or_hash
    monkeypatch.setattr(tcli, "encode_or_hash",
                        lambda pipe, p, n: seen.append(p) or real(pipe, p, n))
    buf = io.BytesIO()
    img = _image(64, 64)
    Image.fromarray(img).save(buf, format="PNG")
    body = {"image": base64.b64encode(buf.getvalue()).decode(),
            "prompt": "w3 w4", "negative_prompt": "", "height": 64,
            "width": 64, "num_frames": 9, "frame_rate": 24,
            "num_inference_steps": 2}
    tobs.Metrics.reset()
    status, _ = svc.run(dict(body, enhance_prompt=True), "http://x")
    assert status == 200
    want = svc.enhancer.enhance("w3 w4", first_frames=[img])
    assert seen == [want]
    gauges = tobs.Metrics.snapshot()["gauges"]
    assert gauges["last_stage_s/enhance_prompt"] > 0
    status, _ = svc.run(body, "http://x")
    assert status == 200 and seen[-1] == "w3 w4"
