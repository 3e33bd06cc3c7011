#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; each prints one JSON line with its elapsed seconds, and
any failure raises (exit code 1):

  env       card, torch and CUDA versions; TF32 off for matmuls and cuDNN
  build     nvcc of every ``smart_nar_fast_tts_tpu_torch/csrc/*.cu``
  kernel    each CUDA kernel against its plain PyTorch version on the card at
            the serving shapes, then timed beside it (and beside one PyTorch
            library call where one computes the same function)
  e2e       ``Synthesizer.from_committed().synthesize`` on bench.py's serving
            inputs (B 8, L 128, T_CAP 1000), with every kernel's launch count
            set to 0 just before and read just after; then stage timings
  reference the card's output against the port's CPU run (plain versions)
            on a small input

The last three lines are the kernel table as one JSON object, the card's
name and power limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the rest
of the repository, it exits non-zero before printing any result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# bench.py's serving shape (bench.py:58-62, :123-135)
B, L, T_CAP, L_LONG = 8, 128, 1000, 256

BF16_TOL = 2e-2     # the flash kernel rounds q·scale, k, v and p to bf16
F32_TOL = 1e-5      # the upsampling kernel is f32 throughout: sums of at
                    # most L terms, and what the band leaves out weighs
                    # below exp(-36) ≈ 2e-16 of the total
PRED_TOL = 1e-2     # log-durations on the card vs the f32 CPU run
WAV_TOL = 1e-3      # the vocoder (f32 convolutions, no TF32) on one input


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    """Prints {"phase": name, "seconds": s, **fields} when the block ends
    without an exception."""

    def __init__(self, name):
        self.name, self.fields = name, {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self.fields

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            emit({"phase": self.name,
                  "seconds": round(time.perf_counter() - self.t0, 3),
                  **self.fields})
        return False


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, torch, reps=25, warmup=3):
    """Median device milliseconds of ``fn()`` over ``reps`` runs, by CUDA
    events.  A sleep kernel queued first keeps the card busy while the host
    queues the runs, so the events time the work, not the host's launch
    overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def wall_ms(fn, torch, reps=5):
    """Median milliseconds of ``fn()`` as the caller sees it: CUDA events
    around the call, synchronised after each run (host time included)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_close(name, got, expect, tol, torch, rtol=0.0):
    err = (got.float() - expect.float()).abs().max().item()
    if not torch.allclose(got.float(), expect.float(), atol=tol, rtol=rtol):
        raise AssertionError(f"{name}: max abs err {err} over tolerance "
                             f"atol {tol} rtol {rtol}")
    return err


def kernel_flash_attention(torch, np, kernels):
    import torch.nn.functional as F
    rng = np.random.default_rng(1)
    entry, err_max = None, 0.0
    # encoder (8, 2, 128, 128) and decoder (8, 2, 1000, 128) self-attention
    for name, Lx in (("encoder", L), ("decoder", T_CAP)):
        lens = rng.integers(Lx // 2, Lx + 1, size=B)
        lens[0] = 0                                   # a fully masked item
        valid = torch.from_numpy(np.arange(Lx)[None, :] < lens[:, None]
                                 ).cuda()
        base = [torch.from_numpy(rng.standard_normal(
            (B, 2, Lx, 128)).astype(np.float32)).cuda() for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            with Phase("kernel flash_attention") as f:
                q, k, v = (t.to(dtype) for t in base)
                out = kernels.flash_attention(q, k, v, valid)
                torch.cuda.synchronize()
                ref = kernels.attention_reference(q, k, v, valid)
                err = check_close(f"flash_attention {name} {dtype}", out,
                                  ref, BF16_TOL, torch, rtol=BF16_TOL)
                if not (out[0] == 0).all() or out.dtype != dtype:
                    raise AssertionError("flash_attention: masked item not "
                                         "zero or wrong dtype")
                err_max = max(err_max, err)
                f.update(shape=list(q.shape), dtype=str(dtype),
                         max_abs_err=err)
                if dtype != torch.float32:
                    continue
                # the main path's dtype: time kernel, plain and library
                mask = valid[:, None, None, :]
                ms = device_ms(lambda: kernels.flash_attention(
                    q, k, v, valid), torch)
                plain_ms = device_ms(lambda: kernels.attention_reference(
                    q, k, v, valid), torch)
                library_ms = device_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask), torch)
                nbytes = 4 * (q.numel() * 2 + k.numel() + v.numel()) \
                    + valid.numel()
                # the products over the valid keys: QKᵀ and PV
                flops = 4 * 2 * Lx * 128 * int(lens.sum())
                bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
                f.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
                if name == "decoder":
                    entry = dict(ms=ms, plain_ms=plain_ms,
                                 library_ms=library_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, shape=list(q.shape))
    entry["max_abs_err"] = err_max
    return entry


def kernel_gaussian_upsample(torch, np, kernels):
    from smart_nar_fast_tts_tpu_torch.kernels.upsample import BAND_SIGMAS
    from smart_nar_fast_tts_tpu_torch.ops import gaussian_upsample
    rng = np.random.default_rng(2)
    entry, err_max = None, 0.0
    x = torch.from_numpy(rng.standard_normal((B, L, 256)).astype(np.float32)
                         ).cuda()
    lens = torch.from_numpy(rng.integers(L - 32, L + 1, size=B)).cuda()
    valid = (torch.arange(L, device="cuda")[None] < lens[:, None]).float()
    # Σd below T (durations 0..7) and above T (4..15)
    for name, (lo, hi) in (("short", (0, 8)), ("long", (4, 16))):
        with Phase("kernel gaussian_upsample") as f:
            d = torch.from_numpy(rng.integers(lo, hi, size=(B, L))
                                 ).float().cuda()
            out, mel_len = kernels.gaussian_upsample_banded(x, d, T_CAP,
                                                            valid)
            torch.cuda.synchronize()
            ref, ref_len, _ = gaussian_upsample(x, d, T_CAP, valid)
            err = check_close(f"gaussian_upsample {name}", out, ref,
                              F32_TOL, torch)
            if not torch.equal(mel_len, ref_len):
                raise AssertionError("gaussian_upsample: mel_len differs")
            err_max = max(err_max, err)
            ms = device_ms(lambda: kernels.gaussian_upsample_banded(
                x, d, T_CAP, valid), torch)
            plain_ms = device_ms(lambda: gaussian_upsample(
                x, d, T_CAP, valid), torch)
            # (frame, phoneme) pairs within the band (σ = 10, the default
            # used above), over valid phonemes and frames below min(Σd, T)
            dv = d * valid
            e = torch.cumsum(dv, 1)
            c = e - 0.5 * dv
            t = torch.arange(T_CAP, device="cuda", dtype=torch.float32)
            near = ((t[None, :, None] - c[:, None, :]).abs()
                    <= BAND_SIGMAS * 10.0) \
                & (valid[:, None, :] > 0) \
                & (t[None, :, None] < e[:, -1, None, None])
            flops = 2 * 256 * int(near.sum())
            nbytes = 4 * (x.numel() + d.numel() + valid.numel()
                          + out.numel() + mel_len.numel())
            bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
            f.update(case=name, total_frames=e[:, -1].tolist(),
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
            if name == "long":
                entry = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                             bound_ms=bound_ms, bound_by=bound_by,
                             shape=[B, L, 256, T_CAP])
    entry["max_abs_err"] = err_max
    return entry


def bench_inputs(np):
    """bench.py's serving inputs: the same generator, draws and order."""
    with open(os.path.join(REPO, "benchmarks", "results",
                           "flagship_meta.json")) as f:
        meta = json.load(f)
    rng = np.random.default_rng(0)
    inv = np.asarray(meta["phone_ids"], np.int32)
    texts = rng.choice(inv, size=(B, L))
    rng.choice(inv, size=(1, L_LONG))          # bench's long-form text
    src_lens = np.clip(rng.integers(L - 32, L + 1, size=(B,)), 1, L)
    return texts, src_lens, inv


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs the port on one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from smart_nar_fast_tts_tpu_torch import kernels
    from smart_nar_fast_tts_tpu_torch.kernels import _build
    from smart_nar_fast_tts_tpu_torch.serving import Synthesizer, bucket

    with Phase("env") as f:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = nvidia_smi()
        f.update(nvidia_smi=smi, torch=torch.__version__,
                 cuda=torch.version.cuda, python=sys.version.split()[0],
                 device=torch.cuda.get_device_name(0),
                 count=torch.cuda.device_count(), tf32=False)

    with Phase("build") as f:
        f.update(nvcc=_build.find_nvcc(), out=str(_build.build_dir()),
                 compiled=_build.build_all())

    entries = {
        "flash_attention": dict(
            route="cuda",
            source="smart_nar_fast_tts_tpu_torch/csrc/flash_attention.cu",
            replaces="smart_nar_fast_tts_tpu/ops/pallas/attention.py:52",
            **kernel_flash_attention(torch, np, kernels)),
        "gaussian_upsample_banded": dict(
            route="cuda",
            source="smart_nar_fast_tts_tpu_torch/csrc/gaussian_upsample.cu",
            replaces="smart_nar_fast_tts_tpu/ops/pallas/upsample.py:25",
            **kernel_gaussian_upsample(torch, np, kernels)),
    }

    texts, src_lens, inv = bench_inputs(np)
    with Phase("e2e") as f:
        t0 = time.perf_counter()
        synth = Synthesizer.from_committed()
        f["load_seconds"] = time.perf_counter() - t0
        # the main path, once, through the user's entry point
        kernels.reset_launches()
        wav, mel_lens = synth.synthesize(texts, src_lens)
        torch.cuda.synchronize()
        counts = kernels.launches()
        for name, n in counts.items():
            if n == 0:
                raise AssertionError(f"the main path never launched {name}")
            entries[name]["launches"] = n
        out = synth.stage_a(torch.from_numpy(texts), torch.from_numpy(
            src_lens))
        cap = bucket(int(out.mel_lens.max()))
        if out.postnet_mel.shape != (B, synth.t_cap, 80):
            raise AssertionError(f"mel shape {tuple(out.postnet_mel.shape)}")
        if wav.shape != (B, cap * synth.hop_length):
            raise AssertionError(f"wav shape {tuple(wav.shape)}")
        if not (torch.isfinite(out.postnet_mel).all()
                and torch.isfinite(wav).all()):
            raise AssertionError("non-finite mel or waveform")
        if int(mel_lens.min()) <= 0 or float(wav.abs().max()) > 1.0:
            raise AssertionError("empty utterance or |wav| > 1")
        if not torch.equal(mel_lens, out.mel_lens):
            raise AssertionError("two runs of stage A disagree on mel_lens")
        mel = out.postnet_mel[:, :cap].contiguous()
        stage_a_ms = wall_ms(lambda: synth.stage_a(
            torch.from_numpy(texts), torch.from_numpy(src_lens)), torch)
        stage_b_ms = wall_ms(lambda: synth.stage_b(mel), torch)
        seconds = synth.audio_seconds(mel_lens)
        f.update(launches=counts, mel_frames=int(mel_lens.sum()),
                 mel_lens=mel_lens.tolist(), bucket=cap,
                 audio_seconds=seconds, stage_a_ms=stage_a_ms,
                 stage_b_ms=stage_b_ms,
                 rtf=(stage_a_ms + stage_b_ms) / 1e3 / seconds,
                 max_abs_wav=float(wav.abs().max()),
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    with Phase("reference") as f:
        # the port's plain versions on the CPU, same weights, small input
        cpu = Synthesizer.from_committed(device="cpu")
        rng = np.random.default_rng(0)
        small = torch.from_numpy(rng.choice(inv, size=(2, 16)))
        small_lens = torch.tensor([16, 11])
        got = synth.stage_a(small, small_lens)
        expect = cpu.stage_a(small, small_lens)
        if not (torch.equal(got.duration_rounded.cpu(),
                            expect.duration_rounded)
                and torch.equal(got.mel_lens.cpu(), expect.mel_lens)):
            raise AssertionError("durations differ from the CPU run")
        logd_err = check_close(
            "log-duration", got.log_duration_prediction.cpu(),
            expect.log_duration_prediction, PRED_TOL, torch)
        mel_in = got.postnet_mel[:, :32]
        wav_err = check_close("vocoder", synth.stage_b(mel_in).cpu(),
                              cpu.stage_b(mel_in.cpu()), WAV_TOL, torch)
        # reported, not held to a tolerance: the decoder's attention logits
        # reach ~2e3 in the committed flagship, so the kernel's bf16
        # operands (as on the TPU) move log-mel by O(1) against f32
        mel_err = (got.postnet_mel.cpu() - expect.postnet_mel).abs()
        f.update(mel_lens=got.mel_lens.tolist(), log_duration_err=logd_err,
                 vocoder_err=wav_err, postnet_mel_max_err=mel_err.max().item(),
                 postnet_mel_mean_err=mel_err.mean().item())

    emit({"kernels": [{"name": name, **entry}
                      for name, entry in entries.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
