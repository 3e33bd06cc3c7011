#!/usr/bin/env python3
"""The upsampling kernel on the serving paths' own inputs.

Runs stage A of ``Synthesizer.from_committed()`` on bench.py's serving
inputs at the 1000- and 4096-frame caps, records the arguments of the
model's ``gaussian_upsample_banded`` call, and times that call alone on
them (``chip_smoke.device_ms``, three times each), the wrapper's own small
launches included.  It imports the package and ``chip_smoke.py`` of the
working directory, so it times any checkout of the port with those two,
for example a parent commit unpacked beside this one:

    python3 profile_upsampling.py                  # this checkout
    (cd ../parent && python3 ../repo/profile_upsampling.py)

Run on a machine with a CUDA card and nvcc.  It prints one JSON line: the
card's name and power limit, and for each cap the milliseconds, the
shape (B, L, D, T) and each item's Σd.
"""

import json
import os
import sys
from unittest import mock


def main() -> int:
    root = os.getcwd()
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_upsampling: no CUDA card", file=sys.stderr)
        return 1

    import chip_smoke
    from smart_nar_fast_tts_tpu_torch import kernels
    from smart_nar_fast_tts_tpu_torch.models import variance
    from smart_nar_fast_tts_tpu_torch.serving import Synthesizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    texts, src_lens, _ = chip_smoke.bench_inputs(np)
    synth = Synthesizer.from_committed()
    out = {"tree": root, "nvidia_smi": chip_smoke.nvidia_smi()}
    for cap in (1000, 4096):
        capped = Synthesizer(synth.model, synth.vocoder, t_cap=cap)
        calls, wrapper = [], variance.gaussian_upsample_banded

        def spy(*args, **kwargs):
            calls.append((args, kwargs))
            return wrapper(*args, **kwargs)

        with mock.patch.object(variance, "gaussian_upsample_banded", spy):
            capped.stage_a(torch.from_numpy(texts), torch.from_numpy(src_lens))
        (x, d, T, valid), kw = calls[0]
        with torch.inference_mode():
            ms = [chip_smoke.device_ms(
                lambda: kernels.gaussian_upsample_banded(x, d, T, valid,
                                                         **kw), torch)
                  for _ in range(3)]
        out[f"cap {cap}"] = dict(ms=ms, shape=[*x.shape, T],
                                 total=(d * valid).sum(1).tolist())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
