"""The int8 linears' share of their roofline over the traced generations:
the least time of every dynamic-int8 linear the requests need (the larger
of 2*M*K*N over the int8 peak and its bytes over 3.35 TB/s;
``h100bench/work.py``) over the device seconds the trace gives to the
``kernels/linear`` family (the GEMM and its row quantize), in %."""


def read(run):
    t = run.trace
    if not t or not t["families"].get("linear") or not t["generations"]:
        return None
    return 100.0 * run.work["linear_s"] * t["generations"] \
        / t["families"]["linear"]
