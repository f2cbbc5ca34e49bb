"""The attention kernels' share of their roofline over the traced
generations: the least time of the attention the requests need (per call
the larger of operations over the tier's peak, bytes over 3.35 TB/s and
one exp2 a score at the SFU rate; ``h100bench/work.py``) over the device
seconds the trace gives to the ``kernels/attention`` family, in %."""


def read(run):
    t = run.trace
    if not t or not t["families"].get("attention") or not t["generations"]:
        return None
    return 100.0 * run.work["attention_s"] * t["generations"] \
        / t["families"]["attention"]
