"""Run one cell of the benchmark once, on the card(s) of this machine.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the comparison's numbers, each beside
its limit, as the last lines of standard error, and one JSON object as
the last line of standard output (`harness.run_cell`). Exits 2, with no
result, where CUDA is missing or the cell asks for more cards than there
are; exits 3, with no result, where the process has loaded JAX or the JAX
package once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dynamic3dgaussians_tpu")


def forbidden_modules():
    """The loaded modules whose top-level name, compared whole, is JAX's,
    jaxlib's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")

    import torch
    from portbench import harness, manifest
    chips = manifest.cell(manifest.load_benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), t0=T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
