"""Cloud deployment entrypoint (Beam-Pod equivalent).

Port of ``ltx_video_gpupoor_tpu/serving/deploy.py``. Parity target:
``beamapp.py`` of the reference — a Pod built from the requirements image,
one accelerator, gunicorn ``-w 2 --timeout 600``, model volume mounted at
``./ckpts``, 5-minute keep-warm. Here one H100 per server process: each
worker owns its card (two workers sharing one card would hold two
models' weights), so workers scale with ``--workers``, one card each.
``entrypoint`` starts the port's ``InferenceService`` behind the stdlib
HTTP server.

The ``beam`` SDK is optional; without it this module just describes the
deployment and can launch the local server for testing.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class DeploySpec:
    name: str = "ltxv-h100"
    accelerator: str = "H100"  # one NVIDIA H100 80GB a worker
    memory: str = "96Gi"
    cpu: int = 8
    workers: int = 1            # one worker per card
    timeout_s: int = 600
    keep_warm_seconds: int = 300
    volume_path: str = "./ckpts"
    port: int = 7860
    env: tuple = (
        ("MODEL_MODE", "ltxv_13B_distilled"),
        ("QUANTIZATION", "int8"),
        ("PROFILE_TYPE_ID", "1"),
    )


def entrypoint(spec: DeploySpec | None = None):
    """Container entrypoint: env config + HTTP server (``beamapp.py:41``)."""
    spec = spec or DeploySpec()
    for k, v in spec.env:
        os.environ.setdefault(k, v)
    from .server import InferenceService, create_stdlib_server

    service = InferenceService()
    server = create_stdlib_server(service, port=spec.port)
    server.serve_forever()


if __name__ == "__main__":
    entrypoint()
