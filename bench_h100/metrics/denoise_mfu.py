"""The DiT's share of the card's peak over the denoise passes: the least
time of a video's model work (every linear's operations at the int8 peak,
attention's QK^T and PV at the peak of the precision the tier computes
them in; ``h100bench/work.py``) over the seconds a video spends in its
denoise passes (``denoise_s``), in %."""


def read(run):
    seconds = run.cell.reader({"name": "denoise_s"})(run)
    if not seconds:
        return None
    return 100.0 * run.work["mfu_s"] / seconds
