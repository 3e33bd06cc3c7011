#!/usr/bin/env python3
"""One traced run of a benchmark cell, split by the port's own spans.

Runs ``portbench`` cell ``--workload`` as ``portbench/run.py --trace 1``
does, prints its result line, and writes to ``--out`` (default
``build/spans_<workload>.json``) the window read by
``portbench/harness/program_spans.py``: per ``tts.*`` span a call's host
ms, idle ms, launches and their device ms (each kernel counted to the
innermost span open at its launch), the idle seconds by the innermost span
of either kind (program or harness), and the share of kernels whose launch
was found.  It imports the package and ``portbench`` of the working
directory, so it reads any checkout with ``portbench/harness/
program_spans.py``, a parent commit with this benchmark laid over it too:

    python3 profile_spans.py --workload fs2_hifigan_v1.online --seed 7
    (cd ../parent && python3 ../repo/profile_spans.py --workload ... )

Run on a machine with a CUDA card and nvcc; without one it exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    root = os.getcwd()
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("profile_spans: no CUDA card", file=sys.stderr)
        return 1
    from portbench import run as pb_run
    from portbench.harness import cell, program_spans
    pb_run.environment()
    torch.cuda.set_device(0)

    views = []
    metric_reader = cell.metric_reader

    def reader(name):
        def read(run):
            if not views:
                tracer = program_spans._tracer_of(run.trace)
                views.append(program_spans.reduce(
                    tracer.prof.profiler.kineto_results.events(),
                    run.trace.spans))
            return metric_reader(name)(run)
        return read

    cell.metric_reader = reader
    result = cell.run(args.workload, args.seed, args.seconds, True, T_START,
                      bench=cell.benchmark())
    print(json.dumps(result))
    view = views[0]
    gaps = view.idle_gaps()
    doc = {"workload": args.workload, "seed": args.seed,
           "device": result["device"], "window_s": view.window_s,
           "kernels": len(view.kernels),
           "launch_found": sum(k[3] is not None for k in view.kernels),
           "idle_s": sum(t for _, t in gaps), "idle_gaps": gaps,
           "by_span": view.by_span(), "metrics": result["metrics"],
           "record": result["record"]}
    out = args.out or os.path.join(root, "build",
                                   f"spans_{args.workload}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
