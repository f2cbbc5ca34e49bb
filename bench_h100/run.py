"""The benchmark of ``ltx_video_gpupoor_tpu_torch`` on NVIDIA cards.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout. It builds the cell's configuration with
random weights from the seed, wraps it in the HTTP service, runs the
service's warm-up, drives ``POST /`` from closed-loop clients for
``--seconds`` seconds of whole requests, then compares a request of the
window with the plain float32 reference. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, then ``readings`` and
``checks`` (each number compared, beside its limit). It exits with a code
other than 0 and prints no result where there is no CUDA device, fewer
than the cell asks for, or a module of JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = os.path.join(HERE, ".cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    from h100bench import catalog

    cell = catalog.Cell(catalog.load_spec(ROOT), args.workload, ROOT, HERE)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    _cache_dirs()
    from h100bench import cell as cell_run

    try:
        result = cell_run.run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), t_process=T_PROCESS)
    except cell_run.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
