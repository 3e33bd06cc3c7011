"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1> [--control 1] [--rate R]

From the root of a checkout, on a machine with the cell's CUDA cards.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window.  The last line of standard
output is one JSON object; the numbers that decide ``correct`` are its
last key (``checks``) and the last lines of standard error.  ``--control
1`` also reports the control (the reference at each precision below the
configuration's, by name) against the reference; ``--rate`` overrides an open
mix's arrival rate, for the sweep that fixed it.  Exits non-zero, printing
no result, without the cards or when JAX has been loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the JAX side of the repository, by whole top-level module names
FORBIDDEN = ("jax", "jaxlib", "flax", "smart_nar_fast_tts_tpu")


def environment() -> None:
    """Caches inside the checkout at fixed paths; no library loads JAX."""
    cache = ROOT / "build" / "portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", type=int, choices=(0, 1), default=0)
    parser.add_argument("--rate", type=float, default=None)
    args = parser.parse_args()
    environment()
    sys.path.insert(0, str(ROOT))
    from portbench.harness import cell

    bench = cell.benchmark()
    chips = cell.find(bench["workloads"], args.workload, "workload")["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()} usable "
              "(no result: the benchmark never runs on the CPU)",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, control=bool(args.control),
                      rate=args.rate, bench=bench)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; the port must "
              "not load JAX or the JAX package (no result)", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
