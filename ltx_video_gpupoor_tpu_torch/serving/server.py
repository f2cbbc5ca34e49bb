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
- ``GET /metrics``: the process-wide counters and gauges (JAX's
  ``requests_ok`` and ``last_request_s``; the warm-up's ``warmup_ok`` and
  ``warmup_failed``) and, under ``"requests"``, the records of the last
  requests and warm-up generations (``utils/observability.py``): each with
  its id (and ``creation_id``), its kind and its spans: ``read_image``,
  ``enhance_prompt`` when asked, ``encode_prompt``, ``lock_wait`` (the
  generation lock's acquisition), ``generate`` with the pipelines' spans
  inside it (down to each denoise ``step``, with device intervals on the
  card), ``save_video``. ``LTXV_TPU_TRACE=0`` records none;
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

Several ranks (``torchrun --nproc-per-node N -m
ltx_video_gpupoor_tpu_torch.serving.server`` with ``LTXV_TPU_MESH``, e.g.
``dp1,sp2,tp1``): every rank loads the model and takes its share of the
mesh (``model_zoo.apply_serving_mesh``); rank 0 listens and answers. For
each request it hands the body to the other ranks
(``broadcast_object_list``, :class:`RankChannel`), every rank runs the same
encode and ``generate`` and leaves its outcome in the group's store: a
follower's error reaches rank 0's answer as a 500 naming the rank (and
breaks the group: the ranks must be restarted). While idle, rank 0 sends
a heartbeat well inside the group's timeout, so that no rank waits past
it. On a mesh rank 0's background warm-up hands each bucket over the same
way, so that every rank runs it; a rank that fails it breaks the group as
a failed request does, and the next request answers 500 naming the rank.
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


def _creation(data) -> dict:
    """A request body's ``creation_id``, for its record, where it has
    one."""
    if isinstance(data, dict) and data.get("creation_id"):
        return {"creation_id": data["creation_id"]}
    return {}


class RankChannel:
    """Rank 0's line to the other ranks of a serving mesh. :meth:`call`
    runs a function with one request's body on every rank (rank 0
    broadcasts it); each rank then leaves its outcome in the group's
    key-value store, outside the collectives, so that a rank that failed
    half way (and left the others waiting in a collective until the
    group's timeout) still reaches rank 0's answer. Any failed rank
    breaks the group: the failed follower leaves, and rank 0 answers
    every later request with the error (the ranks must be restarted).
    The other ranks sit in :meth:`follow`. While idle, rank 0 sends a
    heartbeat every quarter of the group's timeout, so that no follower
    waits past it."""

    def __init__(self):
        import torch.distributed as dist

        from ..core.mesh import group_timeout

        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.timeout_s = group_timeout()
        self.store = dist.distributed_c10d._get_default_store()
        self.lock = threading.Lock()
        self.broken = None
        self.requests = 0
        self._stopped = threading.Event()
        if self.rank == 0:
            threading.Thread(target=self._heartbeat, daemon=True).start()

    def _send(self, msg):
        from ..parallel import comm

        return comm.broadcast_object(msg, src=0)

    def _heartbeat(self):
        while not self._stopped.wait(self.timeout_s / 4):
            if self.lock.acquire(blocking=False):
                try:
                    if not self._stopped.is_set() and self.broken is None:
                        self._send(("noop", None))
                finally:
                    self.lock.release()

    def _run(self, fn, n, data):
        """``fn(data)``; this rank's outcome goes to the store."""
        result, err = None, ""
        try:
            result = fn(data)
        except Exception as e:
            import traceback

            traceback.print_exc()
            err = f"{type(e).__name__}: {e}"
        self.store.set(f"serving/{n}/{self.rank}", err)
        return result, err

    def _outcome(self, n, r):
        import datetime

        key = f"serving/{n}/{r}"
        try:
            self.store.wait([key], datetime.timedelta(seconds=self.timeout_s))
        except Exception:
            return f"no answer within {self.timeout_s:.0f} s"
        return self.store.get(key).decode()

    def call(self, fn, data):
        """``fn(data)`` on every rank; rank 0's result, or a RuntimeError
        naming each rank that failed."""
        with self.lock:
            if self.broken is not None:
                raise RuntimeError(f"the serving ranks are broken since "
                                   f"{self.broken}; restart them")
            self.requests += 1
            n = self.requests
            self._send(("run", (n, data)))
            result, err = self._run(fn, n, data)
            errs = [err] + [self._outcome(n, r)
                            for r in range(1, self.world)]
            failed = [f"rank {r}: {e}" for r, e in enumerate(errs) if e]
            if failed:
                self.broken = "; ".join(failed)
                raise RuntimeError(self.broken)
        return result

    def follow(self, fn):
        """A follower's loop: run ``fn`` on each request rank 0 sends,
        until it stops the channel or a request fails."""
        while True:
            try:
                kind, payload = self._send(None)
            except Exception as e:
                logger.error("rank %d leaves: %s", self.rank, e)
                return
            if kind == "stop":
                return
            if kind == "run":
                if self._run(fn, *payload)[1]:
                    return

    def stop(self):
        """Rank 0: release the followers (nothing to release once broken)."""
        with self.lock:
            self._stopped.set()
            if self.broken is None:
                self._send(("stop", None))


class InferenceService:
    """Model preload + request handling, shared by both HTTP backends."""

    def __init__(self, model=None, outputs_dir: str = "outputs",
                 warmup_spec: str | None = None):
        self.outputs_dir = os.path.abspath(outputs_dir)
        os.makedirs(self.outputs_dir, exist_ok=True)
        if model is None:
            model = self._load_from_env()
        self.model = model
        # several ranks: rank 0 answers, the others follow (RankChannel)
        mesh = getattr(model.generator.pipeline, "mesh", None)
        self.channel = (RankChannel() if mesh is not None and mesh.size() > 1
                        else None)
        # the prompt enhancer, built at the first ``enhance_prompt`` request
        # (or set beforehand with its models)
        self.enhancer = None
        # one generation at a time: the card cannot hold two full-size
        # generations' memory at once, and the background warm-up must not
        # race the first live request
        self.gen_lock = threading.Lock()
        # warm the serving shapes (LTXV_TPU_WARMUP); ``warmup_spec``
        # overrides the environment (tests pass "off"). On a mesh rank 0
        # hands each bucket to every rank through the channel, which takes
        # the channel's lock and then the generation lock, in a request's
        # order; the followers warm up in ``follow``
        from .warmup import start_background_warmup

        self._warmup_thread = None
        if self.channel is None:
            self._warmup_thread = start_background_warmup(
                model.generator, spec=warmup_spec, lock=self.gen_lock)
        elif self.channel.rank == 0:
            self._warmup_thread = start_background_warmup(
                model.generator, spec=warmup_spec,
                run=lambda bucket: self.channel.call(
                    self._serve, ("warmup", bucket)))

    @staticmethod
    def _load_from_env():
        from . import model_zoo

        model_mode = os.environ.get("MODEL_MODE", "ltxv_13B_distilled")
        quantization = os.environ.get("QUANTIZATION", "int8")
        dtype_policy = os.environ.get("TRANSFORMER_DTYPE_POLICY", "")
        from ..core.mesh import dist_env, rank_device

        if dist_env()[1] > 1:
            # under torchrun "cuda" is this rank's card
            import torch

            torch.cuda.set_device(rank_device())
        if os.environ.get("DEMO_MODEL", "").lower() in ("1", "true"):
            model = model_zoo.build_demo_model()      # on the card
        else:
            tf_file, te_file = model_zoo.select_model_files(
                model_mode, quantization, dtype_policy
            )
            model = model_zoo.load_ltxv_model(
                tf_file, model_mode,
                os.environ.get("CKPT_DIR", "ckpts"), te_file,
            )
        model_zoo.apply_serving_mesh(model.generator.pipeline)
        return model

    def _produce(self, data: dict):
        """Everything of a request that the ranks of a mesh run together:
        the image, the prompt (enhanced where asked), its embeddings and
        ``generate``; returns the frames."""
        from PIL import Image

        from .cli import encode_or_hash
        from ..utils import native_codec
        from ..utils.observability import locked, stage

        with stage("read_image"):
            image_bytes = base64.b64decode(data["image"])
            pil = Image.open(io.BytesIO(image_bytes)).convert("RGB")
            image_start = np.asarray(pil)
        gen = self.model.generator
        prompt = data["prompt"]
        # encoding the prompt holds no lock, so it overlaps another
        # request's generation.
        # ``enhance_prompt`` (a superset field, JAX :112-126): the caption
        # + rewrite of ``utils/prompt_enhance.py``, its models from
        # LTXV_TPU_CAPTIONER_DIR / LTXV_TPU_ENHANCER_LLM_DIR (unset: the
        # prompt as it is), the span ``enhance_prompt``. The
        # enhancer is cached on the service (its models load once) and
        # runs under gen_lock: its models share the card with the
        # diffusion weights, so it must not race a generation or the
        # warm-up
        if data.get("enhance_prompt"):
            if self.enhancer is None:
                from ..utils.prompt_enhance import PromptEnhancer

                self.enhancer = PromptEnhancer()
            with locked(self.gen_lock), stage("enhance_prompt"):
                prompt = self.enhancer.enhance(
                    prompt, first_frames=[image_start])
        with stage("encode_prompt"):
            embeds, mask = encode_or_hash(
                gen.pipeline, prompt, data["negative_prompt"])
        # planar-YUV420 fetch when the native writer can take it: half the
        # host-fetch bytes of uint8 RGB (JAX :132-136)
        out_type = "yuv420" if native_codec.available() else "pixels"
        # serialize vs the warm-up and other requests; ``generate``
        # anchors the request's device clock (one synchronize of an idle
        # stream)
        dev = gen.pipeline.transformer.proj_out.bias.device
        with locked(self.gen_lock), stage("generate", anchor=dev):
            frames = gen.generate(
                embeds, mask,
                height=int(data["height"]), width=int(data["width"]),
                frame_num=int(data["num_frames"]),
                frame_rate=int(data["frame_rate"]),
                sampling_steps=int(data["num_inference_steps"]),
                image_start=image_start,
                output_type=out_type,
            )
        return frames

    def _serve(self, message):
        """What rank 0 hands every rank of a mesh: ``("request", body)``
        (:meth:`_produce`) or ``("warmup", (W, H, F))`` (one bucket of the
        warm-up, under the generation lock)."""
        from .warmup import warm_bucket
        from ..utils.observability import request

        kind, payload = message
        if kind == "warmup":
            return warm_bucket(self.model.generator, payload, self.gen_lock)
        # a follower's own record of the request (rank 0 is inside one)
        with request("request", **_creation(payload)):
            return self._produce(payload)

    def follow(self):
        """A follower rank of a mesh: run every warm-up bucket and request
        rank 0 hands over, until it stops."""
        self.channel.follow(self._serve)

    def stop(self):
        """Rank 0 of a mesh: release the followers."""
        if self.channel is not None:
            self.channel.stop()

    def run(self, data: dict, url_root: str) -> tuple[int, object]:
        from ..utils.observability import request

        with request("request", **_creation(data)):
            return self._run(data, url_root)

    def _run(self, data, url_root: str) -> tuple[int, object]:
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
            from ..utils import media as media_utils
            from ..utils.observability import Metrics, stage

            if self.channel is None:
                frames = self._produce(data)
            else:
                frames = self.channel.call(self._serve, ("request", data))
            name = f"video_{uuid.uuid4().hex[:12]}.mp4"
            out_path = os.path.join(self.outputs_dir, name)
            with stage("save_video"):
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
        from ..utils import observability

        return jsonify(observability.snapshot())

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
                from ..utils import observability

                self._send_json(200, observability.snapshot())
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
    if service.channel is not None and service.channel.rank != 0:
        service.follow()           # rank 0 listens and answers
        return
    try:
        app = create_flask_app(service)
        app.run(host="0.0.0.0", port=7860)
    except ImportError:
        logger.info("flask unavailable; using stdlib HTTP server")
        create_stdlib_server(service).serve_forever()


if __name__ == "__main__":
    main()
