"""The work a request asks of the DiT, counted from the configuration and
the request's shape, and the least time that work takes on the card.

The bound arithmetic is a frozen copy of ``chip_smoke.py``'s
(``bound_ms``, ``attention_bound``, ``linear_bound``, the ``ex2`` floor of
``phase_device``): the least time of a call is the larger of its
operations over the published peak of their precision, its bytes (each
input read once, each output written once) over the memory rate, and, for
attention, one ``exp2`` a score on the special-function units. Peaks are
the NVIDIA H100 SXM data sheet's dense rates at its 700 W limit.
"""

from __future__ import annotations

import subprocess

from h100ref import vae as ref_vae

PEAK_OPS = {"bf16": 989e12, "fp16": 989e12, "int8": 1979e12,
            "fp8": 1979e12, "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
EX2_PER_SM_CLOCK = 16          # special-function-unit exp2 a clock an SM
SM_CLOCK_MAX_MHZ = 1980.0      # the SXM part's published highest SM clock


def nvidia_smi(query: str) -> list[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def ex2_per_s(sms: int) -> tuple[float, str]:
    """exp2 a second on the card: SMs x 16 a clock x its highest SM clock
    (``nvidia-smi clocks.max.sm``, else the published maximum)."""
    try:
        mhz, origin = float(nvidia_smi("clocks.max.sm")[0]), \
            "nvidia-smi clocks.max.sm"
    except (IndexError, ValueError):
        mhz, origin = SM_CLOCK_MAX_MHZ, "the published maximum"
    return sms * EX2_PER_SM_CLOCK * mhz * 1e6, origin


def attention_precision(tcfg: dict, tier: str) -> str:
    """The precision the served tier takes QK^T and PV in: ``auto`` runs
    the exact bf16 kernel at head dims up to 64 and int8 QK+PV above
    (``ops/attention.py::resolve_mode``)."""
    if tier != "auto":
        raise ValueError(f"attention tier {tier!r} is not counted")
    return "bf16" if tcfg["attention_head_dim"] <= 64 else "int8"


def latent_dims(config: dict, height: int, width: int, frames: int):
    """(padded H, W, F) and the latent factors of the configuration's VAE."""
    hp = ((height - 1) // 32 + 1) * 32
    wp = ((width - 1) // 32 + 1) * 32
    fp = ((frames - 2) // 8 + 1) * 8 + 1
    return (hp, wp, fp, ref_vae.spatial_factor(config["vae"]),
            ref_vae.temporal_factor(config["vae"]))


def passes(config: dict, traffic: dict) -> list[dict]:
    """The denoise passes of one request: steps, streams (guidance rows),
    tokens, frame groups."""
    pcfg = config["pipeline"]
    hp, wp, fp, sf, tf = latent_dims(config, traffic["height"],
                                     traffic["width"], traffic["num_frames"])
    f_lat = (fp - 1) // tf + 1

    def streams(pass_cfg):
        g = pass_cfg.get("guidance_scale", 1.0)
        s = pass_cfg.get("stg_scale", 0.0)
        gl = g if isinstance(g, list) else [g]
        sl = s if isinstance(s, list) else [s]
        cfg = any(x > 1.0 for x in gl)
        return 1 + cfg + any(x > 0 for x in sl)

    if pcfg.get("pipeline_type") == "multi-scale":
        df = pcfg["downscale_factor"]
        xh, xw = int(hp * df), int(wp * df)
        dh, dw = max(sf, xh - xh % sf), max(sf, xw - xw % sf)
        out = []
        for key, h, w in (("first_pass", dh, dw),
                          ("second_pass", 2 * dh, 2 * dw)):
            pc = pcfg[key]
            out.append(dict(steps=len(pc["timesteps"]), streams=streams(pc),
                            tokens=f_lat * (h // sf) * (w // sf),
                            groups=f_lat))
        return out
    return [dict(steps=int(traffic["num_inference_steps"]),
                 streams=streams(pcfg),
                 tokens=f_lat * (hp // sf) * (wp // sf), groups=f_lat)]


def linear_calls(tcfg: dict, b: int, s: int, g: int, sc: int):
    """(M, K, N) of every linear of one DiT forward over ``b`` streams of
    ``s`` tokens, ``g`` frame groups and ``sc`` caption tokens."""
    d = tcfg["num_attention_heads"] * tcfg["attention_head_dim"]
    ffn = d * tcfg.get("ffn_mult", 4)
    calls = [(b * s, tcfg["in_channels"], d),
             (b * g, tcfg.get("frequency_embedding_size", 256), d),
             (b * g, d, d), (b * g, d, 6 * d),
             (b * sc, tcfg["caption_channels"], d), (b * sc, d, d),
             (b * s, d, tcfg["out_channels"])]
    block = [(b * s, d, d)] * 4 + [(b * s, d, d), (b * sc, d, d),
                                   (b * sc, d, d), (b * s, d, d)] + \
        [(b * s, d, ffn), (b * s, ffn, d)]
    return calls + block * tcfg["num_layers"]


def attention_calls(tcfg: dict, b: int, s: int, sc: int):
    """(B, H, Sq, Skv, D) of every attention of one DiT forward."""
    h, d = tcfg["num_attention_heads"], tcfg["attention_head_dim"]
    return [(b, h, s, s, d), (b, h, s, sc, d)] * tcfg["num_layers"]


def linear_least(m: int, k: int, n: int) -> tuple[float, float]:
    """(least seconds, operations) of a dynamic-int8 linear: bf16 x in,
    int8 weights, fp32 scale and bias, bf16 out."""
    ops = 2 * m * k * n
    nbytes = m * k * 2 + n * k + 8 * n + m * n * 2
    return max(ops / PEAK_OPS["int8"], nbytes / PEAK_BYTES), ops


def attention_least(b, h, sq, skv, d, prec: str, ex2: float):
    """(least seconds, operations) of unmasked attention on bf16 q, k, v
    and a bf16 output: QK^T and PV of 2*B*H*Sq*Skv*D operations each."""
    ops = 4 * b * h * sq * skv * d
    nbytes = b * h * d * (sq * 4 + skv * 4)
    exps = b * h * sq * skv
    return max(ops / PEAK_OPS[prec], nbytes / PEAK_BYTES, exps / ex2), ops


def request_work(config: dict, traffic: dict, ex2: float) -> dict:
    """Per request: least seconds of the int8 linears and of attention,
    and the model work at the peaks (``mfu_s``: linear operations at the
    int8 peak plus attention operations at their tier's peak)."""
    tcfg = config["transformer"]
    prec = attention_precision(tcfg, config["attention"])
    sc = config["prompt_tokens"]
    lin = att = mfu = 0.0
    for p in passes(config, traffic):
        b, s, g = p["streams"], p["tokens"], p["groups"]
        fl = fa = 0.0
        ops_l = ops_a = 0
        for m, k, n in linear_calls(tcfg, b, s, g, sc):
            t, o = linear_least(m, k, n)
            fl += t
            ops_l += o
        for call in attention_calls(tcfg, b, s, sc):
            t, o = attention_least(*call, prec, ex2)
            fa += t
            ops_a += o
        lin += fl * p["steps"]
        att += fa * p["steps"]
        mfu += (ops_l / PEAK_OPS["int8"] + ops_a / PEAK_OPS[prec]) * p["steps"]
    return {"linear_s": lin, "attention_s": att, "mfu_s": mfu,
            "attention_precision": prec}
