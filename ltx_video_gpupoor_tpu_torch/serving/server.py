"""HTTP serving.

Port of ``ltx_video_gpupoor_tpu/serving/server.py``, with the same routes,
fields, status codes and JSON:

- ``POST /``: JSON body with ``image`` (base64), ``prompt``,
  ``negative_prompt``, ``height``, ``width``, ``num_frames``,
  ``frame_rate``, ``num_inference_steps`` (+ optional ``creation_id`` and
  ``enhance_prompt``, the caption + rewrite of the prompt by the port's
  Florence-2 and LLM); an image-to-video request; responds
  ``[{"video": <download url>}]``;
- ``GET /download/<file>`` serving from ``outputs/``;
- ``GET /metrics``: the process-wide counters and gauges. Beside JAX's
  ``requests_ok`` and ``last_request_s`` the port publishes the last
  request's seconds by stage as gauges ``last_stage_s/<stage>``
  (``enhance_prompt`` when asked, ``encode_prompt``, ``generate/...`` as
  the pipelines mark them, ``save_video``);
- the model preloaded at startup from the environment: ``DEMO_MODEL``
  builds the demo model; ``MODEL_MODE``, ``QUANTIZATION`` and
  ``TRANSFORMER_DTYPE_POLICY`` name checkpoint files in the published
  layout under ``CKPT_DIR`` (``model_zoo.load_ltxv_model``); ``HTTPS``
  rewrites the URL;
- the frames fetched as planar YUV420 when the native h264 writer is
  available (``utils/native_codec.py``), as RGB otherwise.

flask is optional: the stdlib ``http.server`` fallback implements the same
routes. ``python3 -m ltx_video_gpupoor_tpu_torch.serving.server`` serves on
port 7860, on the card.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import threading
import time
import uuid

import numpy as np

logger = logging.getLogger("app")
logging.basicConfig(level=logging.INFO)

REQUIRED_FIELDS = [
    "image", "prompt", "negative_prompt", "height", "width",
    "num_frames", "frame_rate", "num_inference_steps",
]


class InferenceService:
    """Model preload + request handling, shared by both HTTP backends."""

    def __init__(self, model=None, outputs_dir: str = "outputs",
                 warmup_spec: str | None = None):
        self.outputs_dir = os.path.abspath(outputs_dir)
        os.makedirs(self.outputs_dir, exist_ok=True)
        if model is None:
            model = self._load_from_env()
        self.model = model
        # the prompt enhancer, built at the first ``enhance_prompt`` request
        # (or set beforehand with its models)
        self.enhancer = None
        # one generation at a time: the card cannot hold two full-size
        # generations' memory at once, and the background warm-up must not
        # race the first live request
        self.gen_lock = threading.Lock()
        # warm the serving shapes (LTXV_TPU_WARMUP); ``warmup_spec``
        # overrides the environment (tests pass "off")
        from .warmup import start_background_warmup

        self._warmup_thread = start_background_warmup(
            model.generator, spec=warmup_spec, lock=self.gen_lock
        )

    @staticmethod
    def _load_from_env():
        from . import model_zoo

        model_mode = os.environ.get("MODEL_MODE", "ltxv_13B_distilled")
        quantization = os.environ.get("QUANTIZATION", "int8")
        dtype_policy = os.environ.get("TRANSFORMER_DTYPE_POLICY", "")
        if os.environ.get("DEMO_MODEL", "").lower() in ("1", "true"):
            return model_zoo.build_demo_model()      # on the card
        tf_file, te_file = model_zoo.select_model_files(
            model_mode, quantization, dtype_policy
        )
        return model_zoo.load_ltxv_model(
            tf_file, model_mode,
            os.environ.get("CKPT_DIR", "ckpts"), te_file,
        )

    def run(self, data: dict, url_root: str) -> tuple[int, object]:
        start = time.time()
        if not isinstance(data, dict):
            return 400, [{"error": "request body must be a JSON object"}]
        logger.info(
            "[POST /] Start time: %.3f, ID %s",
            start, data.get("creation_id") or "N/A",
        )
        missing = [f for f in REQUIRED_FIELDS if f not in data]
        if missing:
            return 400, {"error": f"Missing fields: {', '.join(missing)}"}
        try:
            from PIL import Image

            from .cli import encode_or_hash

            image_bytes = base64.b64decode(data["image"])
            pil = Image.open(io.BytesIO(image_bytes)).convert("RGB")
            image_start = np.asarray(pil)

            gen = self.model.generator
            pipe = gen.pipeline
            prompt = data["prompt"]
            from ..utils import media as media_utils
            from ..utils.observability import (
                Metrics, StageTimer, collect_stages, stage)

            # the ambient marks are collected under the generation lock
            # only: encoding the prompt and writing the mp4 hold no lock, so
            # they overlap another request's generation
            timer = StageTimer()
            # ``enhance_prompt`` (a superset field, JAX :112-126): the
            # caption + rewrite of ``utils/prompt_enhance.py``, its models
            # from LTXV_TPU_CAPTIONER_DIR / LTXV_TPU_ENHANCER_LLM_DIR
            # (unset: the prompt as it is), timed as the stage
            # ``enhance_prompt``. The enhancer is cached on the
            # service (its models load once) and runs under gen_lock: its
            # models share the card with the diffusion weights, so it must
            # not race a generation or the warm-up
            if data.get("enhance_prompt"):
                if self.enhancer is None:
                    from ..utils.prompt_enhance import PromptEnhancer

                    self.enhancer = PromptEnhancer()
                with self.gen_lock, timer.stage("enhance_prompt"):
                    prompt = self.enhancer.enhance(
                        prompt, first_frames=[image_start])
            with timer.stage("encode_prompt"):
                embeds, mask = encode_or_hash(
                    pipe, prompt, data["negative_prompt"])
            from ..utils import native_codec

            # planar-YUV420 fetch when the native writer can take it: half
            # the host-fetch bytes of uint8 RGB (JAX :132-136)
            out_type = "yuv420" if native_codec.available() else "pixels"
            # serialize vs the warm-up and other requests
            with self.gen_lock, collect_stages(timer), stage("generate"):
                frames = gen.generate(
                    embeds, mask,
                    height=int(data["height"]), width=int(data["width"]),
                    frame_num=int(data["num_frames"]),
                    frame_rate=int(data["frame_rate"]),
                    sampling_steps=int(data["num_inference_steps"]),
                    image_start=image_start,
                    output_type=out_type,
                )
            name = f"video_{uuid.uuid4().hex[:12]}.mp4"
            out_path = os.path.join(self.outputs_dir, name)
            with timer.stage("save_video"):
                media_utils.save_video(frames, out_path,
                                       fps=int(data["frame_rate"]))
            url = url_root.rstrip("/") + "/download/" + name
            if os.environ.get("HTTPS", "false").lower() == "true":
                url = url.replace("http://", "https://")
            end = time.time()
            logger.info(
                "[POST /] End time: %.3f, ID %s, Download URL: %s, "
                "Duration: %.3fs",
                end, data.get("creation_id") or "N/A", url, end - start,
            )
            Metrics.inc("requests_ok")
            Metrics.set("last_request_s", end - start)
            for stage_name, seconds in timer.stages.items():
                Metrics.set(f"last_stage_s/{stage_name}", seconds)
            return 200, [{"video": url}]
        except Exception as e:  # any failure is a 500 with its message
            import traceback

            traceback.print_exc()
            logger.error("[POST /] Exception: %s", e)
            return 500, [{"error": str(e)}]

    def download_path(self, filename: str):
        path = os.path.abspath(os.path.join(self.outputs_dir, filename))
        # trailing separator: a bare prefix check would admit sibling
        # directories like outputs_archive/
        if not path.startswith(self.outputs_dir + os.sep):
            return None
        if not os.path.isfile(path):
            return None
        return path


def create_flask_app(service: InferenceService | None = None):
    """Flask app factory (requires flask)."""
    from flask import Flask, jsonify, request, send_from_directory

    service = service or InferenceService()
    app = Flask(__name__)

    @app.route("/download/<path:filename>", methods=["GET"])
    def download_file(filename):
        return send_from_directory(
            service.outputs_dir, filename, as_attachment=True
        )

    @app.route("/", methods=["POST"])
    def run_inference():
        status, payload = service.run(
            request.get_json(silent=True), request.url_root
        )
        return jsonify(payload), status

    @app.route("/metrics", methods=["GET"])
    def metrics():
        from ..utils.observability import Metrics

        return jsonify(Metrics.snapshot())

    return app


def create_stdlib_server(service: InferenceService, host="0.0.0.0", port=7860):
    """Dependency-free fallback with the same routes."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.info("%s - %s", self.address_string(), fmt % args)

        def _send_json(self, status, payload):
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path.rstrip("/") not in ("", "/"):
                self._send_json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._send_json(400, {"error": "bad Content-Length"})
                return
            try:
                data = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._send_json(400, {"error": "invalid JSON"})
                return
            url_root = f"http://{self.headers.get('Host', 'localhost')}/"
            status, payload = service.run(data, url_root)
            self._send_json(status, payload)

        def do_GET(self):
            import shutil
            import urllib.parse

            # clients append ?tracking params; decode %XX names (the
            # Flask route gets both behaviors from werkzeug)
            url = urllib.parse.urlsplit(self.path)
            path_part = urllib.parse.unquote(url.path)
            if path_part == "/metrics":
                from ..utils.observability import Metrics

                self._send_json(200, Metrics.snapshot())
                return
            if not path_part.startswith("/download/"):
                self._send_json(404, {"error": "not found"})
                return
            path = service.download_path(path_part[len("/download/"):])
            if path is None:
                self._send_json(404, {"error": "file not found"})
                return
            # stream: full-size videos are large and this server handles
            # concurrent requests in threads
            self.send_response(200)
            self.send_header("Content-Type", "video/mp4")
            self.send_header(
                "Content-Disposition",
                f'attachment; filename="{os.path.basename(path)}"',
            )
            self.send_header("Content-Length", str(os.path.getsize(path)))
            self.end_headers()
            with open(path, "rb") as f:
                shutil.copyfileobj(f, self.wfile)

    return ThreadingHTTPServer((host, port), Handler)


def main():
    service = InferenceService()
    try:
        app = create_flask_app(service)
        app.run(host="0.0.0.0", port=7860)
    except ImportError:
        logger.info("flask unavailable; using stdlib HTTP server")
        create_stdlib_server(service).serve_forever()


if __name__ == "__main__":
    main()
