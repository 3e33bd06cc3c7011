#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; each prints one JSON line with its elapsed seconds, and
any failure raises (exit code 1):

  env       card, torch and CUDA versions; TF32 off for matmuls and cuDNN
  build     nvcc of every ``smart_nar_fast_tts_tpu_torch/csrc/*.cu``
  kernel    each CUDA kernel against its plain PyTorch version on the card at
            the shapes of its path (serving at T 1000-8192 for flash
            attention, serving for upsampling, training for alignment
            attention), then timed beside it (and beside one PyTorch library
            call where one computes the same function); then each kernel's
            backward (its ``autograd.Function``) against autograd through its
            plain version.  The flash kernel is also held to the plain
            version that rounds where it does (``attention_bf16_reference``)
            on prefix masks, a mask with holes and one whose valid keys sit
            in the last key tile, f32 and bf16 operands; it is timed with
            f32 and bf16 operands beside SDPA on both, and with one valid
            key tile per item (its cost beside the products); ptxas
            registers, shared memory and spills of each of its kernels.
            The alignment kernel (3xTF32 products) is also held to
            ``alignment_tf32x3_reference`` at the training shape, a ragged
            one and L 1000, and on q = 0 and v = identity (each product
            apart); it is timed beside its plain version and f32 SDPA on
            ``out`` alone, against its 3xTF32 tensor-core bound and the f32
            CUDA-core one, with its ptxas figures.  The upsampling kernel is
            also checked on a channel tail (D 70), 300 phonemes of 0 or 1
            frames, all durations 0, T 4096 (frames past Σd exactly 0,
            mel_len exact) and phonemes longer than 12σ (one of 132 frames;
            [7, 9, 4, 11, 6, d_last] for d_last 120-190), with its ptxas
            figures
  kernel ... general  the widths the first kernels do not take: flash
            attention at head dims 32, 80, 96 (zero-padded to 64 or 128)
            and 192, 256 (the general kernel), alignment attention at D 30,
            96 (padded) and 192 (general), the log-mel DFT kernel at n_fft
            16, 800, 1000, 1200 and 8192; each general kernel timed
  e2e       ``Synthesizer.from_committed().synthesize`` on bench.py's serving
            inputs (B 8, L 128, T_CAP 1000), with every kernel's launch count
            set to 0 just before and read just after; then stage timings,
            and the upsampling kernel alone on the path's own recorded
            inputs.  Self-attention runs the flash kernel only past 2048
            frames, as the JAX model, so this path launches upsampling alone
  e2e cap 4096  stage A of the same inputs at the 4096-frame cap of the JAX
            package's ``serving_mel_caps``: the decoder's self-attention runs
            the flash kernel (4 launches at (8, 2, 4096, 128)), the encoder's
            does not; then the kernel alone on each launch's own inputs, and
            the upsampling kernel on its launch's (T 4096)
  kernel fused_log_mel  the log-mel kernel against its plain version on
            noise, the synthesised speech segments of the GAN phase and
            silence, at the GAN step's shape (B 16 × 8192 samples) and a tiny
            configuration, and against the plain version run in float64 on
            those and on tones with a pause; its f64 FFT also within 5e-6 of
            the float64 run and 2e-6 of ``log_mel_fft_reference`` on all of
            those, (3, 5000) and n_fft 4096, bit-equal across launches; then
            timed, with its ptxas figures
  reference the card's output against the port's CPU run (plain versions)
            on a small input: durations exact, postnet mel within 1e-3
  cli       this slice's main path: ``smart_nar_fast_tts_tpu_torch.cli.
            synthesize.main(argv)`` on ``configs/scaled/`` copies (under the
            git-ignored ``build/cli_smoke/``), a port checkpoint of the
            committed 8-speaker flagship and HiFi-GAN V1 as an upstream
            torch checkpoint: (a) ``--text``, speaker 3; (b) a passage that
            escalates to cap 4096 (4 flash and 2 upsampling launches); (c)
            ``--source`` on 12 sentences, batch 8; (d) duration and pitch
            controls; (e) Griffin-Lim; each with the launch counts set to 0
            just before and read just after; every .wav and .png checked;
            durations exact and postnet mel within 1e-3 against the CPU
            (in (b) with the card's flash outputs replayed, each held to
            ``attention_bf16_reference`` of its own inputs); then the CLI
            imported where yaml, matplotlib and JAX cannot be
  train     the training slice's main path: ``make_train_step`` on the
            committed flagship with ``intended``/``first`` duration
            extraction (the alignment kernel's path) at the flagship training
            shape (B 48, L 128, T 896), 5 steps with seeded dropout, with the
            launch counts set to 0 just before and read just after; then one
            step of the default ``soft``/``mean`` configuration
  train_reference  one step on the card against the same step through the
            port's plain versions on the CPU, seeded weights and batch
  vocoder train  the vocoder slice's main path: ``make_vocoder_train_step``
            on the committed HiFi-GAN V1 and a seeded full-width
            discriminator, B 16 × 8192-sample segments of the e2e phase's
            waveforms, 5 GAN steps with the launch counts set to 0 just
            before and read just after (``fused_log_mel`` 2 per step)
  vocoder train reference  one GAN step of a narrow configuration on the
            card against the same step on the CPU, from the same state

The last three lines are the kernel table as one JSON object, the card's
name and power limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the rest
of the repository, it exits non-zero before printing any result.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12

# bench.py's serving shape (bench.py:58-62, :123-135)
B, L, T_CAP, L_LONG = 8, 128, 1000, 256
# a frame cap of the JAX package's serving_mel_caps
# (smart_nar_fast_tts_tpu/config.py:260) past the flash threshold (2048)
T_CAP_LONG = 4096
# (8, 2, T, 128) lengths of the flash crossover timings
FLASH_TS = (1000, 2048, 4096, 8192)
# the flagship training shape (benchmarks/train_throughput.py:27)
TRAIN_B, TRAIN_L, TRAIN_T, TRAIN_STEPS = 48, 128, 896, 5
# launches of each kernel per training step: one per MelEncoder layer, one
# upsampling; the self-attentions (T 896, L 128) take the einsum branch
PER_TRAIN_STEP = {"flash_attention": 0, "alignment_attention": 4,
                  "gaussian_upsample_banded": 1, "fused_log_mel": 0}
# per serving batch: at cap 1000 no self-attention passes 2048 frames; at
# cap 4096 the 4 decoder layers do
PER_SERVING_BATCH = {"flash_attention": 0, "alignment_attention": 0,
                     "gaussian_upsample_banded": 1, "fused_log_mel": 0}
PER_SERVING_BATCH_LONG = dict(PER_SERVING_BATCH, flash_attention=4)
# the vocoder GAN step (smart_nar_fast_tts_tpu/cli/train_vocoder.py:30-31
# defaults): B 16 segments of 8192 samples; 2 log-mel launches per step
VOC_B, VOC_SEG, VOC_STEPS = 16, 8192, 5
PER_GAN_STEP = {"flash_attention": 0, "alignment_attention": 0,
                "gaussian_upsample_banded": 0, "fused_log_mel": 2}

BF16_TOL = 2e-2     # the flash kernel rounds q·scale, k, v and p to bf16;
                    # against attention_bf16_reference, which rounds at the
                    # same points, it is held per element to
                    # kernels.attention_bf16_tolerance (1e-3 + 2^-8·Σp|v|/l,
                    # + 2^-7·|ref| for a bf16 output) and, where each item's
                    # valid keys sit in one 128-key tile (the online softmax
                    # is then the two-pass one), on average to ONE_TILE_MEAN:
                    # a moved rounding point costs ≥ 1.6e-4 there
ONE_TILE_MEAN = 1e-5
FLASH_TILE = 128    # the kernel's key tile (csrc/flash_attention.cu BN)
F32_TOL = 1e-5      # the upsampling kernel is f32 throughout: sums of at
                    # most L terms; what the band leaves out weighs below
                    # exp(-104), which f32 exp rounds to 0
PRED_TOL = 1e-2     # log-durations on the card vs the f32 CPU run
MEL_TOL = 1e-3      # postnet mel on the card vs the f32 CPU run (ROADMAP's
                    # "done" tolerance for mels)
LOGMEL_ATOL, LOGMEL_RTOL = 2e-4, 1e-4    # the log-mel kernel against its
ENERGY_ATOL = 2e-3  # plain version (cuFFT): the JAX package's kernel test
FFT_MEL_ATOL, FFT_ENERGY_RTOL = 5e-6, 1e-6  # its f64 FFT against the
                    # float64 plain version: f32 rounding of the mel value and
                    # logf's last ulp (~1e-6), and of the energy (6e-8)
FFT_REF_ATOL = 2e-6  # against log_mel_fft_reference (the same schedule in
                    # float64 torch): the two logs' last ulps
VOC_RTOL = 1e-3     # a narrow GAN step on the card vs the CPU, f32 both
WAV_TOL = 1e-3      # the vocoder (f32 convolutions, no TF32) on one input
GNUM_ATOL, GNUM_RTOL = 1e-4, 1e-5   # the alignment kernel's guided
                    # numerator: sums of up to T·L f32 terms (the JAX
                    # package's kernel test)
TF32X3_ATOL, TF32X3_MEAN = 8e-6, 1e-6   # the alignment kernel's out against
                    # alignment_tf32x3_reference (operands rounded where the
                    # kernel rounds them), at most and on average: the gap is
                    # the order of the f32 sums in the scores
                    # (tests/test_torch_kernels_cuda.py)
GRAD_TOL = 1e-4     # a backward recomputes the plain version: f32 rounding
TRAIN_RTOL = 1e-4   # a train step on the card vs the CPU, f32 both (its
                    # self-attention takes the einsum branch): 1.2e-5 on
                    # the gradient norm measured on an H100


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


def flash_valid(torch, np, rng, b, Lx, kind):
    """key_valid (b, Lx) on the card, item 0 fully masked: ``prefix`` keys
    below lengths in [Lx/2, Lx]; ``holes`` each key valid with probability
    0.3 (no prefix); ``last tile`` valid keys only in the kernel's last
    128-key tile, a ragged one when Lx is not a multiple of 128."""
    if kind == "prefix":
        lens = rng.integers(Lx // 2, Lx + 1, size=b)
        lens[0] = 0
        valid = np.arange(Lx)[None, :] < lens[:, None]
    elif kind == "holes":
        valid = rng.random((b, Lx)) < 0.3
        valid[0] = False
    else:
        valid = np.zeros((b, Lx), bool)
        last = (Lx - 1) // 128 * 128
        valid[1:, last:] = rng.random((b - 1, Lx - last)) < 0.5
        valid[1:, Lx - 1] = True
    return torch.from_numpy(valid).cuda()


def flash_errors(torch, kernels, name, out, q, k, v, valid):
    """The kernel's output against the f32 plain version (BF16_TOL) and the
    bf16-rounding plain version (``attention_bf16_tolerance`` per element;
    ONE_TILE_MEAN on average where every item's valid keys sit in one key
    tile); a fully masked item must be exactly 0.  Returns the two max abs
    errors, the largest share of the per-element tolerance used and the
    mean abs error against the bf16 plain version."""
    ref = kernels.attention_reference(q, k, v, valid)
    err = check_close(f"flash_attention {name} {q.dtype}", out, ref,
                      BF16_TOL, torch, rtol=BF16_TOL)
    ref = kernels.attention_bf16_reference(q, k, v, valid)
    tol = kernels.attention_bf16_tolerance(q, k, v, valid, ref)
    gap = (out.float() - ref.float()).abs()
    share = (gap / tol).max().item()
    if not share <= 1.0:
        raise AssertionError(f"flash_attention {name} {q.dtype}: beyond "
                             "attention_bf16_tolerance of the bf16 plain "
                             f"version ({share} of it; max abs err "
                             f"{gap.max().item()})")
    mean = gap.mean().item()
    keys = torch.arange(valid.shape[1], device=valid.device)
    first = torch.where(valid, keys, valid.shape[1]).amin(1) // FLASH_TILE
    last = torch.where(valid, keys, -1).amax(1) // FLASH_TILE
    if bool((first == last)[valid.any(1)].all()) and not mean <= ONE_TILE_MEAN:
        raise AssertionError(f"flash_attention {name} {q.dtype}: mean abs "
                             f"err {mean} against the bf16 plain version "
                             f"over {ONE_TILE_MEAN} with every item in one "
                             "key tile: a rounding point moved")
    masked = ~valid.any(1)
    if not (out[masked] == 0).all() or out.dtype != q.dtype:
        raise AssertionError("flash_attention: masked item not zero or "
                             "wrong dtype")
    return err, gap.max().item(), share, mean


def flash_ptxas(compiled, lib):
    """ptxas registers, static shared memory and spills of each kernel of
    csrc/flash_attention.cu (when this run compiled it), and the attention
    kernel's dynamic shared memory."""
    import re
    out = {"dynamic_smem_bytes": {
        f"D {d}, Lk {T_CAP_LONG}": lib.flash_attention_smem_bytes(
            d, T_CAP_LONG) for d in (64, 128)}}
    if "flash_attention" not in compiled:
        out["kernels"] = "not compiled in this run: the build directory had it"
        return out
    for name, info in compiled["flash_attention"]["kernels"].items():
        label = re.search(r"(flash_attention|kv_to_bf16)_kernel",
                          name).group(0)
        d = re.search(r"ILi(\d+)E", name)
        if d:
            label += f"<D {d.group(1)}"
            if label.startswith("flash_attention_kernel"):
                label += ", bf16" if "nv_bfloat16" in name else ", f32"
            label += ">"
        out[label] = info
    return out


def kernel_flash_attention(torch, np, kernels, compiled):
    import torch.nn.functional as F

    from smart_nar_fast_tts_tpu_torch.kernels import _build
    from smart_nar_fast_tts_tpu_torch.kernels.attention import _SIGNATURES
    rng = np.random.default_rng(1)
    entry, err_max, emu_max, share_max, crossover = {}, 0.0, 0.0, 0.0, []
    # the serving encoder (8, 2, 128, 128); the serving decoder at each
    # length of FLASH_TS, timed beside its plain version and SDPA on f32
    # and on bf16 operands (the crossover; T_CAP_LONG is the main path's
    # shape); the training encoder and decoder; a mask with holes and one
    # whose only valid keys sit in the last (ragged) tile.  bf16 operands
    # too at the encoder, at T_CAP and on the two masks.
    cases = [("encoder", B, L, "prefix")] \
        + [(f"decoder {t}", B, t, "prefix") for t in FLASH_TS] \
        + [("train encoder", TRAIN_B, TRAIN_L, "prefix"),
           ("train decoder", TRAIN_B, TRAIN_T, "prefix"),
           (f"decoder {T_CAP_LONG} holes", B, T_CAP_LONG, "holes"),
           ("decoder 4000 last tile", B, 4000, "last tile")]
    for name, b, Lx, kind in cases:
        valid = flash_valid(torch, np, rng, b, Lx, kind)
        base = [torch.from_numpy(rng.standard_normal(
            (b, 2, Lx, 128)).astype(np.float32)).cuda() for _ in range(3)]
        dtypes = (torch.float32,) if kind == "prefix" and name not in (
            "encoder", f"decoder {T_CAP}") else (torch.float32,
                                                 torch.bfloat16)
        for dtype in dtypes:
            with Phase("kernel flash_attention") as f:
                q, k, v = (t.to(dtype) for t in base)
                out = kernels.flash_attention(q, k, v, valid)
                torch.cuda.synchronize()
                err, err_emu, share, mean = flash_errors(
                    torch, kernels, name, out, q, k, v, valid)
                err_max, emu_max = max(err_max, err), max(emu_max, err_emu)
                share_max = max(share_max, share)
                f.update(case=name, shape=list(q.shape), dtype=str(dtype),
                         mask=kind, valid_keys=int(valid.sum()),
                         max_abs_err=err, max_abs_err_vs_bf16_plain=err_emu,
                         bf16_tolerance_share=share,
                         mean_abs_err_vs_bf16_plain=mean)
                if dtype != torch.float32 or not name.startswith("decoder") \
                        or kind != "prefix":
                    continue
                mask = valid[:, None, None, :]
                qb, kb, vb = (t.to(torch.bfloat16) for t in base)
                ms = device_ms(lambda: kernels.flash_attention(
                    q, k, v, valid), torch)
                bf16_ms = device_ms(lambda: kernels.flash_attention(
                    qb, kb, vb, valid), torch)
                plain_ms = device_ms(lambda: kernels.attention_reference(
                    q, k, v, valid), torch)
                library_ms = device_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask), torch)
                library_bf16_ms = device_ms(
                    lambda: F.scaled_dot_product_attention(
                        qb, kb, vb, attn_mask=mask), torch)
                nbytes = 4 * (q.numel() * 2 + k.numel() + v.numel()) \
                    + valid.numel()
                # the products over the valid keys: QKᵀ and PV
                flops = 4 * 2 * Lx * 128 * int(valid.sum())
                bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
                timing = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              bound_share=bound_ms / ms,
                              tflops=flops / ms / 1e9, bf16_ms=bf16_ms,
                              library_bf16_ms=library_bf16_ms,
                              vs_library_bf16=ms / library_bf16_ms)
                f.update(timing)
                crossover.append(dict(T=Lx, **timing))
                if Lx == T_CAP_LONG:
                    # what a launch costs beside its products: one valid
                    # key tile per item (q load, output store, set-up)
                    one = torch.zeros_like(valid)
                    one[:, :FLASH_TILE] = True
                    timing["one_tile_ms"] = device_ms(
                        lambda: kernels.flash_attention(q, k, v, one), torch)
                    f.update(one_tile_ms=timing["one_tile_ms"])
                    entry.update(timing, shape=list(q.shape))
    lib = _build.load("flash_attention", _SIGNATURES)
    entry.update(max_abs_err=err_max, max_abs_err_vs_bf16_plain=emu_max,
                 bf16_tolerance_share=share_max, crossover=crossover,
                 ptxas=flash_ptxas(compiled, lib))
    return entry


def kernel_ptxas(compiled, stem, lib, smem):
    """ptxas registers, static shared memory and spills of each kernel of
    csrc/<stem>.cu (when this run compiled it), and the dynamic shared
    memory a block takes at each size in ``smem`` ({label: bytes} from the
    library's own query)."""
    import re
    out = {"dynamic_smem_bytes": smem}
    if stem not in compiled:
        out["kernels"] = "not compiled in this run: the build directory had it"
        return out
    for name, info in compiled[stem]["kernels"].items():
        out[re.search(r"[a-z_]+_kernel", name).group(0)] = info
    return out


def upsample_bound(torch, x, d, valid, T, sigma=10.0):
    """(bound ms, bound_by) of banded upsampling on these inputs: x, the
    durations, valid and mel_len read or written once, out written once;
    2·D operations per (frame, phoneme) pair within the band, over valid
    phonemes and frames below min(Σd, T)."""
    from smart_nar_fast_tts_tpu_torch.kernels.upsample import BAND_SIGMAS
    b, _, D = x.shape
    dv = d.float() * valid
    e = torch.cumsum(dv, 1)
    c = e - 0.5 * dv
    t = torch.arange(T, device=x.device, dtype=torch.float32)
    near = ((t[None, :, None] - c[:, None, :]).abs()
            <= BAND_SIGMAS * sigma) & (valid[:, None, :] > 0) \
        & (t[None, :, None] < e[:, -1, None, None])
    flops = 2 * D * int(near.sum())
    nbytes = 4 * (x.numel() + d.numel() + valid.numel() + b * T * D + b)
    return bound(nbytes, flops, F32_FLOPS)


def upsample_check(torch, kernels, name, x, d, T, valid, sigma=10.0):
    """The upsampling kernel against the dense plain version: out within
    F32_TOL, exactly 0 past Σd, mel_len exact; then timed beside it."""
    from smart_nar_fast_tts_tpu_torch.ops import gaussian_upsample
    with torch.inference_mode():
        out, mel_len = kernels.gaussian_upsample_banded(x, d, T, valid,
                                                        sigma=sigma)
        torch.cuda.synchronize()
        ref, ref_len, _ = gaussian_upsample(x, d, T, valid, sigma=sigma)
        err = check_close(f"gaussian_upsample {name}", out, ref, F32_TOL,
                          torch)
        if not torch.equal(mel_len, ref_len):
            raise AssertionError(f"gaussian_upsample {name}: mel_len "
                                 f"{mel_len.tolist()} != {ref_len.tolist()}")
        total = (d.float() * valid).sum(1)
        past = torch.arange(T, device=x.device)[None] >= total[:, None]
        if out[past].any():
            raise AssertionError(f"gaussian_upsample {name}: frames past "
                                 "the total are not 0")
        ms = device_ms(lambda: kernels.gaussian_upsample_banded(
            x, d, T, valid, sigma=sigma), torch)
        plain_ms = device_ms(lambda: gaussian_upsample(
            x, d, T, valid, sigma=sigma), torch)
    bound_ms, bound_by = upsample_bound(torch, x, d, valid, T, sigma)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by,
                shape=[*x.shape, T], total_frames=total.tolist()[:8])


def kernel_gaussian_upsample(torch, np, kernels, compiled):
    from smart_nar_fast_tts_tpu_torch.kernels import _build
    from smart_nar_fast_tts_tpu_torch.kernels.upsample import _SIGNATURES
    rng = np.random.default_rng(2)
    entry, err_max = {}, 0.0
    # serving: Σd below T (durations 0..7) and above T (4..15); training:
    # (48, 128, 256) to 896 frames, Σd around T (durations 5..9); then a
    # channel tail (D 70), 300 phonemes of 0 or 1 frames (~180 in one
    # tile's band: many 32-phoneme chunks), all durations 0, and T 4096
    # with Σd about 1200
    for name, b, Lx, D, T, (lo, hi) in (
            ("short", B, L, 256, T_CAP, (0, 8)),
            ("long", B, L, 256, T_CAP, (4, 16)),
            ("train", TRAIN_B, TRAIN_L, 256, TRAIN_T, (5, 10)),
            ("D 70", 4, L, 70, T_CAP, (0, 15)),
            ("L 300", 2, 300, 256, 400, (0, 2)),
            ("all zero", 3, L, 256, 500, (0, 1)),
            ("T 4096", B, L, 256, T_CAP_LONG, (8, 12))):
        if name != "long":
            x = torch.from_numpy(rng.standard_normal((b, Lx, D)).astype(
                np.float32)).cuda()
            lens = torch.from_numpy(rng.integers(Lx - 32, Lx + 1, size=b)
                                    ).cuda()
            valid = (torch.arange(Lx, device="cuda")[None]
                     < lens[:, None]).float()
        with Phase("kernel gaussian_upsample") as f:
            d = torch.from_numpy(rng.integers(lo, hi, size=(b, Lx))
                                 ).float().cuda()
            res = upsample_check(torch, kernels, name, x, d, T, valid)
            err_max = max(err_max, res["max_abs_err"])
            f.update(case=name, **res)
            if name == "long":
                entry.update({k: res[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "shape")})
            elif name == "train":
                entry.update({f"train_{k}": res[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "shape")})
            elif name == "short":
                entry.update(short_ms=res["ms"], short_bound_ms=res[
                    "bound_ms"])
            elif name == "T 4096":
                entry.update(t4096_ms=res["ms"], t4096_bound_ms=res[
                    "bound_ms"])
    # phonemes longer than 12σ, which the band must reach (ROADMAP §C.1):
    # one of 132 frames at T 140, and [7, 9, 4, 11, 6, d_last] for d_last
    # 120..190 as one batch
    for name, rows, T in (
            ("d 132", [[132]], 140),
            ("d_last 120-190", [[7, 9, 4, 11, 6, n] for n in range(120, 191)],
             37 + 190 + 8)):
        with Phase("kernel gaussian_upsample") as f:
            d = torch.tensor(rows, dtype=torch.float32, device="cuda")
            x = torch.from_numpy(rng.standard_normal(
                (*d.shape, 256)).astype(np.float32)).cuda()
            res = upsample_check(torch, kernels, name, x, d, T,
                                 torch.ones_like(d))
            err_max = max(err_max, res["max_abs_err"])
            f.update(case=name, **res)
    lib = _build.load("gaussian_upsample", _SIGNATURES)
    entry.update(max_abs_err=err_max, ptxas=kernel_ptxas(
        compiled, "gaussian_upsample", lib,
        {f"L {n}": lib.gaussian_upsample_smem_bytes(n) for n in (128, 300)}))
    return entry


def alignment_inputs(torch, np, rng, b, h, t, l, d):
    """Seeded alignment-attention inputs on the card: the last item's text
    is shorter than L (a masked key tail), mel lengths in [3T/4, T]."""
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(
        np.float32)).cuda() for n in (t, l, l))
    src = rng.integers(max(3 * l // 4, 1), l + 1, size=b)
    src[-1] = max(l - 5, 1)
    mel = rng.integers(3 * t // 4, t + 1, size=b)
    valid = torch.from_numpy(np.arange(l)[None, :] < src[:, None]).cuda()
    return (q, k, v, valid, torch.from_numpy(src).cuda(),
            torch.from_numpy(mel).cuda())


def alignment_ptxas(compiled, lib):
    """ptxas registers, static shared memory and spills of each kernel of
    csrc/alignment_attention.cu (when this run compiled it), and the
    dynamic shared memory of each instantiation."""
    import re
    out = {"dynamic_smem_bytes": {f"D {d}": lib.alignment_attention_smem_bytes(
        d) for d in (32, 64, 128)}}
    if "alignment_attention" not in compiled:
        out["kernels"] = "not compiled in this run: the build directory had it"
        return out
    for name, info in compiled["alignment_attention"]["kernels"].items():
        label = re.search(r"(alignment|gnum_reduce)_kernel", name).group(0)
        d = re.search(r"ILi(\d+)E", name)
        out[label + (f"<D {d.group(1)}>" if d else "")] = info
    return out


def alignment_check(torch, kernels, name, args):
    """The kernel against the f32 plain version (out F32_TOL, idx exact,
    gnum GNUM_ATOL/GNUM_RTOL), twice (idx and gnum bit-equal) and against
    alignment_tf32x3_reference (out TF32X3_ATOL at most and TF32X3_MEAN on
    average, gnum as above); returns the figures."""
    out, idx, gnum = kernels.alignment_attention(*args)
    _, idx2, gnum2 = kernels.alignment_attention(*args)
    torch.cuda.synchronize()
    r_out, r_idx, r_gnum = kernels.alignment_reference(*args)
    err = check_close(f"alignment_attention {name} out", out, r_out,
                      F32_TOL, torch)
    n_idx = int((idx != r_idx).sum())
    if n_idx:
        raise AssertionError(f"alignment_attention {name}: {n_idx} argmax "
                             "indices differ")
    gnum_err = check_close(f"alignment_attention {name} gnum", gnum, r_gnum,
                           GNUM_ATOL, torch, rtol=GNUM_RTOL)
    if not (torch.equal(gnum, gnum2) and torch.equal(idx, idx2)):
        raise AssertionError("alignment_attention: two launches differ")
    t_out, t_idx, t_gnum = kernels.alignment_tf32x3_reference(*args)
    gap = (out - t_out).abs()
    if not (gap.max() <= TF32X3_ATOL and gap.mean() <= TF32X3_MEAN):
        raise AssertionError(f"alignment_attention {name}: out beyond the "
                             f"3xTF32 plain version's tolerance (max "
                             f"{gap.max().item()}, mean {gap.mean().item()})")
    # reported, not held: the 3xTF32 plain version sums its three products
    # apart and may settle a near-tie otherwise (idx is held to f32 above)
    n_t_idx = int((idx != t_idx).sum())
    t_gnum_err = check_close(f"alignment_attention {name} gnum (3xTF32)",
                             gnum, t_gnum, GNUM_ATOL, torch, rtol=GNUM_RTOL)
    return dict(max_abs_err=err, mean_abs_err=(out - r_out).abs().mean().item(),
                max_abs_err_vs_tf32x3_plain=gap.max().item(),
                mean_abs_err_vs_tf32x3_plain=gap.mean().item(),
                gnum_max_abs_err=gnum_err,
                gnum_max_abs_err_vs_tf32x3_plain=t_gnum_err,
                idx_differ=n_idx, idx_differ_vs_tf32x3_plain=n_t_idx,
                gnum_bit_equal_across_launches=True)


def kernel_alignment_attention(torch, np, kernels, compiled):
    import torch.nn.functional as F

    from smart_nar_fast_tts_tpu_torch.kernels import _build
    from smart_nar_fast_tts_tpu_torch.kernels.alignment import _SIGNATURES
    rng = np.random.default_rng(3)
    entry, err_max = None, 0.0
    # the flagship training shape, a ragged one (T not a multiple of 16,
    # L 13) and L 1000 (max_seq_len; 16 key chunks); then each product
    # apart: q = 0 (uniform p: PV alone) and v = identity (out = P: QKᵀ
    # through the softmax alone)
    for name, shape in (("train", (TRAIN_B, 2, TRAIN_T, TRAIN_L, 128)),
                        ("ragged", (3, 2, 45, 13, 128)),
                        ("L 1000", (2, 2, 1500, 1000, 128)),
                        ("q zero", (4, 2, 300, 128, 128)),
                        ("v identity", (4, 2, 300, 128, 128))):
        with Phase("kernel alignment_attention") as f:
            args = alignment_inputs(torch, np, rng, *shape)
            if name == "q zero":
                args = (torch.zeros_like(args[0]), *args[1:])
            elif name == "v identity":
                eye = torch.eye(128, device="cuda").expand(4, 2, 128, 128)
                args = (*args[:2], eye.contiguous(), *args[3:])
            checks = alignment_check(torch, kernels, name, args)
            err_max = max(err_max, checks["max_abs_err"])
            f.update(case=name, shape=list(shape), **checks,
                     src_lens=args[4].tolist()[:4])
            if name != "train":
                continue
            q, k, v, valid = args[:4]
            ms = device_ms(lambda: kernels.alignment_attention(*args), torch)
            plain_ms = device_ms(lambda: kernels.alignment_reference(*args),
                                 torch)
            sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=valid[:, None, None, :]), torch)
            nbytes = 4 * (2 * q.numel() + k.numel() + v.numel()
                          + TRAIN_B * TRAIN_T + TRAIN_B
                          + 2 * args[4].numel()) + valid.numel()
            # QKᵀ and PV over the valid keys, every frame: three TF32
            # passes each on the tensor cores, or once at the f32 rate
            b_, h_, t_, _, d_ = shape
            flops = 4 * h_ * t_ * d_ * int(valid.sum())
            bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOPS)
            f32_bound_ms, f32_bound_by = bound(nbytes, flops, F32_FLOPS)
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                          sdpa_f32_out_only_ms=sdpa_ms, bound_ms=bound_ms,
                          bound_by=bound_by, bound_share=bound_ms / ms,
                          f32_bound_ms=f32_bound_ms,
                          f32_bound_by=f32_bound_by,
                          f32_bound_share=f32_bound_ms / ms,
                          tflops_3xtf32=3 * flops / ms / 1e9)
            f.update(timing, flops=flops, bytes=nbytes)
            entry = dict(timing, shape=list(shape))
    lib = _build.load("alignment_attention", _SIGNATURES)
    entry.update(max_abs_err=err_max, ptxas=alignment_ptxas(compiled, lib))
    return entry


def grads_of(torch, fn, leaves, cotangents):
    """Gradients of Σ out·cotangent for the leaves; every output must carry
    a grad_fn."""
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    outs = fn(*leaves)
    if any(o.grad_fn is None for o in outs):
        raise AssertionError("an output has no grad_fn")
    total = sum((o * c).sum() for o, c in zip(outs, cotangents))
    return torch.autograd.grad(total, leaves)


def kernel_backward(torch, np, kernels):
    """Each kernel's autograd.Function against autograd through its plain
    version, on the card, at training shapes."""
    from smart_nar_fast_tts_tpu_torch.ops import gaussian_upsample
    rng = np.random.default_rng(4)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()

    errors = {}
    q, k, v = (randn(8, 2, TRAIN_T, 128) for _ in range(3))
    valid = torch.from_numpy(np.arange(TRAIN_T)[None, :] < rng.integers(
        TRAIN_T // 2, TRAIN_T + 1, size=8)[:, None]).cuda()
    ct = [randn(8, 2, TRAIN_T, 128)]
    cases = [("flash_attention", (q, k, v), ct,
              lambda *a: (kernels.flash_attention(*a, valid),),
              lambda *a: (kernels.attention_reference(*a, valid),))]
    x = randn(8, TRAIN_L, 256)
    d = torch.from_numpy(rng.integers(0, 12, (8, TRAIN_L))).float().cuda()
    pv = (torch.arange(TRAIN_L, device="cuda")[None] < torch.from_numpy(
        rng.integers(TRAIN_L - 32, TRAIN_L + 1, (8, 1))).cuda()).float()
    cases.append((
        "gaussian_upsample_banded", (x,), [randn(8, TRAIN_T, 256)],
        lambda x: (kernels.gaussian_upsample_banded(x, d, TRAIN_T, pv)[0],),
        lambda x: (gaussian_upsample(x, d, TRAIN_T, pv)[0],)))
    q, k, v, valid_a, src, mel = alignment_inputs(
        torch, np, rng, 8, 2, TRAIN_T, TRAIN_L, 128)
    fixed = (valid_a, src, mel)

    def out_gnum(fn):
        return lambda *a: (lambda r: (r[0], r[2]))(fn(*a, *fixed))
    cases.append(("alignment_attention", (q, k, v),
                  [randn(8, 2, TRAIN_T, 128), randn(8)],
                  out_gnum(kernels.alignment_attention),
                  out_gnum(kernels.alignment_reference)))
    for name, leaves, cts, kernel_fn, plain_fn in cases:
        with Phase("kernel backward") as f:
            got = grads_of(torch, kernel_fn, leaves, cts)
            want = grads_of(torch, plain_fn, leaves, cts)
            err = max(check_close(f"{name} gradient", g, w, GRAD_TOL, torch,
                                  rtol=GRAD_TOL)
                      for g, w in zip(got, want))
            errors[name] = err
            f.update(kernel=name, shapes=[list(t.shape) for t in leaves],
                     grad_max_abs_err=err)
    return errors


def train_batch(torch, np, synth, inv):
    """The flagship training batch, made on the card from a seed: texts
    from the trained phone inventory, and as targets the port's own stage-A
    output for them, cut to TRAIN_T frames, so that the alignment has a
    real diagonal to find."""
    from smart_nar_fast_tts_tpu_torch.data import Batch
    rng = np.random.default_rng(0)
    texts = torch.from_numpy(rng.choice(inv, size=(TRAIN_B, TRAIN_L)))
    src_lens = torch.from_numpy(rng.integers(TRAIN_L - 32, TRAIN_L + 1,
                                             size=TRAIN_B))
    out = synth.stage_a(texts, src_lens)
    # clones: stage A runs in inference mode, whose tensors autograd
    # cannot save
    return Batch(texts=texts.cuda(), src_lens=src_lens.cuda(),
                 mels=out.postnet_mel[:, :TRAIN_T].clone(),
                 mel_lens=out.mel_lens.clamp(max=TRAIN_T).clone(),
                 pitch=out.pitch_prediction[:, :TRAIN_T].clone(),
                 energy=out.energy_prediction[:, :TRAIN_T].clone())


def check_finite_losses(torch, losses, what):
    bad = [n for n in losses._fields
           if not torch.isfinite(getattr(losses, n))]
    if bad:
        raise AssertionError(f"{what}: non-finite loss terms {bad}")


def train_phase(torch, np, kernels, synth, inv):
    from smart_nar_fast_tts_tpu_torch.config import ModelConfig
    from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Loss
    from smart_nar_fast_tts_tpu_torch.serving import committed_flagship
    from smart_nar_fast_tts_tpu_torch.training import (create_train_state,
                                                       make_train_step)
    loss_fn = FastSpeech2Loss()
    with Phase("train") as f:
        batch = train_batch(torch, np, synth, inv)
        cfg = ModelConfig(duration_extraction="intended",
                          duration_head_reduce="first")
        t0 = time.perf_counter()
        state = create_train_state(committed_flagship(cfg))
        f["load_seconds"] = time.perf_counter() - t0
        step = make_train_step(loss_fn, keep_outputs=True)
        generator = torch.Generator(device="cuda").manual_seed(0)
        last = cfg.transformer.decoder_layer - 1
        # the last MelEncoder layer's value path ends in the hidden state
        # that the model discards: it gets no gradient
        no_grad = {n for n, _ in state.model.named_parameters()
                   if n.startswith(f"mel_encoder.layer_stack.{last}.")
                   and n.split(".")[4] not in ("w_qs", "w_ks")}
        before = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, totals = [], []
        # the main path, through the user's entry points
        kernels.reset_launches()
        for i in range(TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses, outs = step(state, batch, generator)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            check_finite_losses(torch, losses, f"train step {i + 1}")
            totals.append(float(losses.total))
            durations = outs[0].duration_targets
            if not torch.equal(durations.sum(1), batch.mel_lens.to(
                    durations.dtype)):
                raise AssertionError("duration targets do not sum to "
                                     "mel_lens")
            if i == 0:
                grads = {n: p.grad for n, p in
                         state.model.named_parameters()}
                if not all(torch.isfinite(g).all() for g in grads.values()):
                    raise AssertionError("a non-finite gradient")
                zero = {n for n, g in grads.items() if not g.any()}
                if not no_grad <= zero:
                    raise AssertionError("a gradient reached "
                                         f"{sorted(no_grad - zero)[:4]}")
                # Adam's first update moves an element whose (clipped)
                # gradient exceeds 1e-8 by ≥ 0.9·lr(1) ≈ 2.2e-7, more than
                # half an f32 ulp of any value below 1: each must change
                stuck = [n for n, p in state.model.named_parameters()
                         if ((grads[n].abs() > 1e-8) & (before[n].abs() < 1)
                             & (p.detach() == before[n])).any()]
                if stuck:
                    raise AssertionError(f"step 1 left {stuck[:4]} "
                                         "unchanged")
                # reported: a saturated softmax passes no gradient to its
                # queries and keys, and none reaches a key bias (one
                # constant added to a row), up to rounding
                gradient_free = sorted(zero - no_grad)
                below_1e8 = sorted(n for n, g in grads.items()
                                   if n not in zero
                                   and not g.abs().max() > 1e-8)
                first = dict(losses._asdict())
        counts = kernels.launches()
        want = {n: k * TRAIN_STEPS for n, k in PER_TRAIN_STEP.items()}
        if counts != want:
            raise AssertionError(f"train launches {counts}, expected {want}")
        step_ms = statistics.median(times[-3:])
        frames = int(batch.mel_lens.sum())
        f.update(launches=counts, step_ms=times, step_ms_median_last3=step_ms,
                 mel_frames_per_step=frames,
                 mel_frames_per_second=frames / step_ms * 1e3,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 first_step_losses={k: float(v) for k, v in first.items()},
                 total_loss_per_step=totals,
                 params=len(before), params_without_gradient=len(no_grad),
                 gradient_free_beyond_those=gradient_free,
                 gradient_max_below_1e8=below_1e8,
                 mel_lens=batch.mel_lens.tolist()[:8],
                 src_lens=batch.src_lens.tolist()[:8],
                 frames_per_phoneme_max=int(durations.max()))
        del state, step, outs, grads, before

    with Phase("train soft/mean") as f:
        state = create_train_state(committed_flagship(ModelConfig()))
        kernels.reset_launches()
        losses = make_train_step(loss_fn)(state, batch, generator)
        torch.cuda.synchronize()
        soft = kernels.launches()
        check_finite_losses(torch, losses, "soft/mean train step")
        if soft != dict(PER_TRAIN_STEP, alignment_attention=0):
            raise AssertionError(f"soft/mean launches {soft}")
        f.update(launches=soft,
                 losses={k: float(v) for k, v in losses._asdict().items()})
        del state
    return counts


def train_reference_phase(torch, np, inv):
    """One step on the card against the same step through the port's plain
    versions on the CPU: seeded-init weights, a small seeded batch, no
    dropout."""
    import copy

    from smart_nar_fast_tts_tpu_torch.config import ModelConfig
    from smart_nar_fast_tts_tpu_torch.data import Batch
    from smart_nar_fast_tts_tpu_torch.models import (FastSpeech2Align,
                                                     FastSpeech2Loss)
    from smart_nar_fast_tts_tpu_torch.training import (compute_gradients,
                                                       create_train_state)
    with Phase("train_reference") as f:
        torch.manual_seed(0)
        model = FastSpeech2Align(ModelConfig(
            duration_extraction="intended", duration_head_reduce="first"))
        rng = np.random.default_rng(1)
        b, t = 4, 160

        def normal(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32))
        batch = Batch(texts=torch.from_numpy(rng.choice(inv, size=(b, 32))),
                      src_lens=torch.tensor([32, 28, 24, 20]),
                      mels=normal(b, t, 80),
                      mel_lens=torch.tensor([160, 140, 120, 100]),
                      pitch=normal(b, t), energy=normal(b, t))
        res = {}
        for device in ("cuda", "cpu"):
            state = create_train_state(copy.deepcopy(model), device=device)
            losses, outs = compute_gradients(state, FastSpeech2Loss(), batch)
            norm = state.apply_gradients()
            res[device] = ({k: float(v) for k, v in losses._asdict().items()},
                           outs[0].duration_targets.cpu(), float(norm))
        (gl, gd, gn), (cl, cd, cn) = res["cuda"], res["cpu"]
        n_differ = int((gd != cd).sum())
        f.update(duration_targets_differing=n_differ, losses_card=gl,
                 losses_cpu=cl, grad_norm_card=gn, grad_norm_cpu=cn,
                 duration_targets_card=gd[0].tolist())
        if n_differ:
            raise AssertionError(f"{n_differ} duration targets differ "
                                 "between the card and the CPU")
        rel = {k: abs(gl[k] - cl[k]) / abs(cl[k]) for k in cl}
        rel["grad_norm"] = abs(gn - cn) / abs(cn)
        f["relative_err"] = rel
        bad = {k: e for k, e in rel.items() if not e <= TRAIN_RTOL}
        if bad:
            raise AssertionError(f"card vs CPU beyond rtol {TRAIN_RTOL}: "
                                 f"{bad}")


def upsampling_spy(calls):
    """A stand-in for the model's ``gaussian_upsample_banded`` that records
    each call's arguments and calls the wrapper."""
    from smart_nar_fast_tts_tpu_torch.models import variance
    wrapper = variance.gaussian_upsample_banded

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return wrapper(*args, **kwargs)
    return spy


def upsampling_on_path(torch, kernels, calls):
    """The upsampling kernel alone on a path's own recorded inputs (shape,
    durations, mask), after the launch counts were read: checked against
    the dense plain version and timed beside it."""
    (x, d, T, valid), kw = calls[0]
    res = upsample_check(torch, kernels, f"on the path at T {T}", x, d, T,
                         valid, kw.get("sigma", 10.0))
    return {k: res[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "max_abs_err", "shape", "total_frames")}


def e2e_phase(torch, kernels, texts, src_lens):
    """The serving main path at cap 1000, once, through the user's entry
    point; then stage timings and the upsampling kernel alone on the
    path's own inputs."""
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.models import variance
    from smart_nar_fast_tts_tpu_torch.serving import Synthesizer, bucket
    with Phase("e2e") as f:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        synth = Synthesizer.from_committed()
        f["load_seconds"] = time.perf_counter() - t0
        calls = []
        kernels.reset_launches()
        with mock.patch.object(variance, "gaussian_upsample_banded",
                               upsampling_spy(calls)):
            wav, mel_lens = synth.synthesize(texts, src_lens)
        torch.cuda.synchronize()
        counts = kernels.launches()
        if counts != PER_SERVING_BATCH:
            raise AssertionError(f"serving launches {counts}, expected "
                                 f"{PER_SERVING_BATCH}")
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
        upsampling = upsampling_on_path(torch, kernels, calls)
        f.update(upsampling_on_path=upsampling)
    return synth, out, wav, mel_lens, counts, upsampling


def e2e_long_phase(torch, kernels, synth, short, texts, src_lens):
    """Stage A of the same inputs at cap 4096, through ``Synthesizer(...,
    t_cap=4096)``: the decoder's four self-attentions run the flash kernel
    at (8, 2, 4096, 128), the encoder's none.  Its durations equal the
    cap-1000 run's; its mel differs over the frames they share because the
    decoder attends over every frame (up to 4096 instead of 1000) and
    through the kernel's bf16 operands: reported, not held."""
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.models import layers, variance
    from smart_nar_fast_tts_tpu_torch.serving import Synthesizer
    with Phase("e2e cap 4096") as f:
        long_synth = Synthesizer(synth.model, synth.vocoder, t_cap=T_CAP_LONG)
        calls, flash, up_calls = [], layers.flash_attention, []

        def spy(q, k, v, key_valid):          # the model's call, recorded
            calls.append((q, k, v, key_valid))
            return flash(q, k, v, key_valid)

        kernels.reset_launches()
        with mock.patch.object(layers, "flash_attention", spy), \
                mock.patch.object(variance, "gaussian_upsample_banded",
                                  upsampling_spy(up_calls)):
            out = long_synth.stage_a(torch.from_numpy(texts),
                                     torch.from_numpy(src_lens))
        torch.cuda.synchronize()
        counts = kernels.launches()
        shapes = [list(c[0].shape) for c in calls]
        if counts != PER_SERVING_BATCH_LONG or shapes != [
                [B, 2, T_CAP_LONG, 128]] * 4:
            raise AssertionError(f"cap-4096 launches {counts} at {shapes}, "
                                 f"expected {PER_SERVING_BATCH_LONG}")
        if not torch.equal(out.duration_rounded, short.duration_rounded):
            raise AssertionError("cap-4096 durations differ from cap 1000")
        if out.postnet_mel.shape != (B, T_CAP_LONG, 80) or not torch.isfinite(
                out.postnet_mel).all():
            raise AssertionError("cap-4096 mel: bad shape or non-finite")
        n = torch.clamp(out.mel_lens, max=T_CAP)
        shared = torch.arange(T_CAP, device="cuda")[None] < n[:, None]
        diff = (out.postnet_mel[:, :T_CAP] - short.postnet_mel).abs()[shared]
        stage_a_ms = wall_ms(lambda: long_synth.stage_a(
            torch.from_numpy(texts), torch.from_numpy(src_lens)), torch)
        # the kernel alone at the path's own inputs (shape, mask, values),
        # after the launch counts were read; the first layer's output
        # against both plain versions, reported (the flagship's attention
        # logits reach ~1e3, where bf16 operands move scores by units)
        with torch.inference_mode():
            flash_ms = [device_ms(lambda c=c: kernels.flash_attention(*c),
                                  torch) for c in calls]
            first = kernels.flash_attention(*calls[0])
            errs = {f"layer1_vs_{n}": (first - ref(*calls[0])).abs().max(
            ).item() for n, ref in (
                ("f32_plain", kernels.attention_reference),
                ("bf16_plain", kernels.attention_bf16_reference))}
        valid_keys = int(calls[0][3].sum())
        flops = 4 * 2 * T_CAP_LONG * 128 * valid_keys
        nbytes = 4 * 4 * calls[0][0].numel() + calls[0][3].numel()
        path_bound_ms, path_bound_by = bound(nbytes, flops, BF16_FLOPS)
        f.update(flash_valid_keys=valid_keys, flash_ms_on_path=flash_ms,
                 flash_ms_on_path_sum=sum(flash_ms),
                 flash_bound_ms_on_path=path_bound_ms,
                 flash_bound_by_on_path=path_bound_by, **errs)
        f.update(launches=counts, flash_shapes=shapes,
                 mel_lens=out.mel_lens.tolist(),
                 mel_lens_cap1000=short.mel_lens.tolist(),
                 postnet_mel_vs_cap1000_max=diff.max().item(),
                 postnet_mel_vs_cap1000_mean=diff.mean().item(),
                 stage_a_ms=stage_a_ms)
        upsampling = upsampling_on_path(torch, kernels, up_calls)
        f.update(upsampling_on_path=upsampling)
    return counts, upsampling


def reference_phase(torch, np, synth, inv):
    """The card's stage A and vocoder against the port's plain versions on
    the CPU, same weights, small input."""
    from smart_nar_fast_tts_tpu_torch.serving import Synthesizer
    with Phase("reference") as f:
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
        # every self-attention here (T 1000, L 16) takes the f32 einsum
        # branch on both sides, as the JAX model below 2048 frames
        mel_err = (got.postnet_mel.cpu() - expect.postnet_mel).abs()
        f.update(mel_lens=got.mel_lens.tolist(), log_duration_err=logd_err,
                 vocoder_err=wav_err, postnet_mel_max_err=mel_err.max().item(),
                 postnet_mel_mean_err=mel_err.mean().item())
        check_close("postnet mel", got.postnet_mel.cpu(), expect.postnet_mel,
                    MEL_TOL, torch)


def vocoder_segments(torch, np, wav, mel_lens, hop):
    """The GAN phase's batch: VOC_B segments of VOC_SEG samples drawn by
    the port's ``sample_segments`` with ``default_rng(0)`` from the e2e
    phase's waveforms, item i cut to its ``mel_lens[i]·hop`` samples."""
    from smart_nar_fast_tts_tpu_torch.training import sample_segments
    clips = [w[:int(n) * hop].cpu().numpy() for w, n in zip(wav, mel_lens)]
    return torch.from_numpy(sample_segments(
        clips, VOC_B, VOC_SEG, np.random.default_rng(0))).cuda()


def tone_with_pause(torch, np, rng, b, n):
    """Harmonic tones of falling loudness with a silent stretch under a
    noise floor 100 dB down: bins ~110 dB below a frame's loudest, where
    an f32 DFT or FFT is least exact after log compression."""
    t = np.arange(n) / 22050.0
    out = np.zeros((b, n))
    for i in range(b):
        out[i] = sum(np.sin(2 * np.pi * (90.0 + 15.0 * i) * h * t
                            + rng.uniform(0, 6)) / h ** 2
                     for h in range(1, 30))
        out[i] *= 0.4 * np.exp(-4.0 * t / t[-1])
        out[i, n // 3: n // 2] = 0.0
    out += 1e-5 * rng.standard_normal((b, n))
    return torch.from_numpy(out.astype(np.float32)).cuda()


def kernel_fused_log_mel(torch, np, kernels, segments, compiled):
    """The log-mel kernel against its plain version (cuFFT rfft and the mel
    product) on noise, the speech segments and silence at the GAN step's
    shape and on noise at a tiny configuration; each also against the plain
    version run in float64.  On tones with a pause, where the f32 plain
    version is itself off, the kernel is held to the float64 run only.  Its
    FFT is f64 up to an f32 epilogue, so on every case, and on (3, 5000)
    and n_fft 4096 besides, it is also held to the float64 run within
    FFT_MEL_ATOL / FFT_ENERGY_RTOL and to ``log_mel_fft_reference`` (its
    schedule in float64 torch) within FFT_REF_ATOL, and two launches are
    bit-equal.  Then timed on the speech segments.  Other n_fft sizes go to
    the DFT kernel (:func:`kernel_general_paths`)."""
    from smart_nar_fast_tts_tpu_torch.audio import (MelSpectrogramConfig,
                                                    mel_spectrogram)
    from smart_nar_fast_tts_tpu_torch.kernels import _build
    from smart_nar_fast_tts_tpu_torch.kernels.stft import _SIGNATURES
    rng = np.random.default_rng(5)
    cfg = MelSpectrogramConfig()
    tiny = MelSpectrogramConfig(n_fft=32, hop_length=8, win_length=32,
                                n_mels=8, mel_fmax=None)
    wide = MelSpectrogramConfig(n_fft=4096, win_length=4096,
                                hop_length=1024)
    noise = torch.from_numpy(rng.uniform(-1, 1, segments.shape).astype(
        np.float32)).cuda()
    tones = tone_with_pause(torch, np, rng, *segments.shape)
    entry, err_max, fft_err_max = {}, 0.0, 0.0
    for name, y, c in (("noise", noise, cfg), ("speech", segments, cfg),
                       ("zeros", torch.zeros_like(segments), cfg),
                       ("tiny noise", noise[:3, :300].contiguous(), tiny),
                       ("tones with a pause", tones, cfg),
                       ("(3, 5000)", noise[:3, :5000].contiguous(), cfg),
                       ("n_fft 4096", noise[:4].contiguous(), wide)):
        with Phase("kernel fused_log_mel") as f:
            mel, energy = kernels.fused_log_mel(y, c)
            mel2, energy2 = kernels.fused_log_mel(y, c)
            torch.cuda.synchronize()
            ref_mel, ref_energy = mel_spectrogram(y, c)
            exact_mel, exact_energy = mel_spectrogram(y.double(), c)
            fft_mel, fft_energy = kernels.log_mel_fft_reference(y, c)
            if mel.shape != ref_mel.shape or energy.shape != ref_energy.shape:
                raise AssertionError(f"fused_log_mel {name}: shapes "
                                     f"{tuple(mel.shape)} {tuple(energy.shape)}")
            held = [("float64", exact_mel.float(), exact_energy.float())]
            if name != "tones with a pause":
                held.append(("plain", ref_mel, ref_energy))
            errs = {}
            for against, m, e in held:
                errs[f"mel_vs_{against}"] = check_close(
                    f"fused_log_mel {name} mel vs {against}", mel, m,
                    LOGMEL_ATOL, torch, rtol=LOGMEL_RTOL)
                errs[f"energy_vs_{against}"] = check_close(
                    f"fused_log_mel {name} energy vs {against}", energy, e,
                    ENERGY_ATOL, torch, rtol=LOGMEL_RTOL)
            # in float64: the f64 FFT's own error, not the run's f32 rounding
            errs["mel_vs_float64"] = (mel.double() - exact_mel).abs().max(
            ).item()
            errs["energy_rel_vs_float64"] = ((
                energy.double() - exact_energy).abs() / exact_energy.clamp(
                min=1e-30)).max().item()
            if (errs["mel_vs_float64"] > FFT_MEL_ATOL
                    or errs["energy_rel_vs_float64"] > FFT_ENERGY_RTOL):
                raise AssertionError(
                    f"fused_log_mel {name} vs float64: mel "
                    f"{errs['mel_vs_float64']} (atol {FFT_MEL_ATOL}), energy "
                    f"{errs['energy_rel_vs_float64']} relative (rtol "
                    f"{FFT_ENERGY_RTOL})")
            errs["mel_vs_fft_reference"] = check_close(
                f"fused_log_mel {name} mel vs log_mel_fft_reference", mel,
                fft_mel, FFT_REF_ATOL, torch)
            check_close(f"fused_log_mel {name} energy vs "
                        "log_mel_fft_reference", energy, fft_energy, 0.0,
                        torch, rtol=FFT_ENERGY_RTOL)
            if not (torch.equal(mel, mel2) and torch.equal(energy, energy2)):
                raise AssertionError(f"fused_log_mel {name}: two launches "
                                     "differ")
            errs["plain_mel_vs_float64"] = (ref_mel.double() - exact_mel
                                            ).abs().max().item()
            errs["fft_reference_mel_vs_float64"] = (
                fft_mel.double() - exact_mel).abs().max().item()
            if name == "zeros" and not (torch.equal(mel, torch.log(
                    torch.full_like(mel, c.compression_clip)))
                    and not energy.any()):
                raise AssertionError("fused_log_mel of silence is not "
                                     "log(clip) and 0")
            err_max = max(err_max, errs["mel_vs_float64"],
                          errs.get("mel_vs_plain", 0.0))
            fft_err_max = max(fft_err_max, errs["mel_vs_float64"])
            f.update(case=name, shape=list(y.shape), n_fft=c.n_fft,
                     mel_min=mel.min().item(), bit_equal=True, **errs)
            if name != "speech":
                continue
            ms = device_ms(lambda: kernels.fused_log_mel(y, c), torch)
            plain_ms = device_ms(lambda: mel_spectrogram(y, c), torch)
            b, n_frames = energy.shape
            n_bins = c.n_fft // 2 + 1
            # the least work of the function per frame: the window, a real
            # FFT (2.5·n·log2 n, the usual count), power, sqrt and the energy
            # sum per bin, the filterbank's nonzeros, clip and log per mel
            per_frame = (c.win_length + 2.5 * c.n_fft * math.log2(c.n_fft)
                         + 5 * n_bins + 2 * np.count_nonzero(c.mel_basis)
                         + 2 * c.n_mels + 1)
            flops = b * n_frames * per_frame
            nbytes = 4 * (y.numel() + mel.numel() + energy.numel())
            bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=plain_ms,
                          library="the plain version (cuFFT rfft + mel "
                                  "product): no one PyTorch call computes "
                                  "log-mel",
                          bound_ms=bound_ms, bound_by=bound_by, flops=flops)
            f.update(timing)
            entry.update(timing, shape=list(y.shape))
    lib = _build.load("log_mel", _SIGNATURES)
    entry.update(max_abs_err=err_max, fft_max_abs_err_vs_float64=fft_err_max,
                 ptxas=kernel_ptxas(compiled, "log_mel", lib, {
                     f"n_fft {n}": lib.log_mel_smem_bytes(n)
                     for n in (1024, 4096)}))
    return entry


def grad_norm(torch, module):
    return torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in module.parameters()])).item()


def vocoder_train_phase(torch, kernels, synth, segments):
    """The vocoder slice's main path at full width: 5 GAN steps of the
    committed HiFi-GAN V1 against a seeded full discriminator."""
    from smart_nar_fast_tts_tpu_torch.audio import MelSpectrogramConfig
    from smart_nar_fast_tts_tpu_torch.serving import committed_vocoder
    from smart_nar_fast_tts_tpu_torch.training import (
        VocoderOptimizer, create_vocoder_state, make_vocoder_train_step)
    from smart_nar_fast_tts_tpu_torch.vocoder import HiFiGANDiscriminator
    with Phase("vocoder train") as f:
        tx = VocoderOptimizer()
        state = create_vocoder_state(committed_vocoder(),
                                     HiFiGANDiscriminator(seed=0), tx, tx)
        step = make_vocoder_train_step(MelSpectrogramConfig())
        trees = {"generator": state.generator,
                 "discriminator": state.discriminator}
        before = {t: {n: p.detach().clone() for n, p in
                      m.state_dict().items()} for t, m in trees.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, metrics = [], []
        # the main path, through the user's entry points
        kernels.reset_launches()
        for i in range(VOC_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(state, segments)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            m = {k: float(v) for k, v in m._asdict().items()}
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"GAN step {i + 1}: metrics {m}")
            metrics.append(m)
            if i == 0:
                # every tensor moved, spectral-norm u included, but a u of
                # one output, which stays ±1
                stuck = [f"{t}.{n}" for t, m_ in trees.items()
                         for n, v in m_.state_dict().items()
                         if v.numel() > 1 and torch.equal(v, before[t][n])]
                if stuck:
                    raise AssertionError(f"step 1 left {stuck[:4]} unchanged")
                norms = {t: grad_norm(torch, m_) for t, m_ in trees.items()}
        counts = kernels.launches()
        want = {n: k * VOC_STEPS for n, k in PER_GAN_STEP.items()}
        if counts != want:
            raise AssertionError(f"GAN launches {counts}, expected {want}")
        step_ms = statistics.median(times[-3:])
        audio = VOC_B * VOC_SEG / synth.sampling_rate
        f.update(launches=counts, step_ms=times, step_ms_median_last3=step_ms,
                 segments_per_second=VOC_B / step_ms * 1e3,
                 audio_seconds_per_second=audio / step_ms * 1e3,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 metrics_per_step=metrics, step1_grad_norms=norms,
                 params={t: sum(p.numel() for p in m_.parameters())
                         for t, m_ in trees.items()})
        del state, step, before
    return counts


def vocoder_train_reference_phase(torch, np):
    """One GAN step of a narrow configuration (hop 8, n_fft 32, 8 mels, a
    narrow discriminator) on the card and on the CPU from the same seeded
    state and segments: metrics and both gradient norms within rtol 1e-3."""
    import copy

    from smart_nar_fast_tts_tpu_torch.audio import MelSpectrogramConfig
    from smart_nar_fast_tts_tpu_torch.training import (
        VocoderOptimizer, create_vocoder_state, make_vocoder_train_step)
    from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                      HiFiGANDiscriminator,
                                                      HiFiGANGenerator)
    with Phase("vocoder train reference") as f:
        torch.manual_seed(0)
        gen = HiFiGANGenerator(HiFiGANConfig(
            upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), n_mels=8))
        disc = HiFiGANDiscriminator(
            periods=(2, 3), period_channels=(4, 8), n_scales=2,
            scale_layers=((8, 15, 1, 1), (16, 41, 4, 4), (16, 5, 1, 1)),
            seed=1)
        mel_cfg = MelSpectrogramConfig(n_fft=32, hop_length=8, win_length=32,
                                       n_mels=8, mel_fmax=None)
        rng = np.random.default_rng(2)
        t = np.arange(1024) / 22050.0
        wavs = torch.from_numpy((0.3 * np.sin(2 * np.pi * 440.0 * t)
                                 + 0.05 * rng.standard_normal((4, 1024))
                                 ).astype(np.float32))
        res = {}
        for device in ("cuda", "cpu"):
            tx = VocoderOptimizer()
            state = create_vocoder_state(copy.deepcopy(gen),
                                         copy.deepcopy(disc), tx, tx,
                                         device=device)
            m = make_vocoder_train_step(mel_cfg)(state, wavs)
            res[device] = {**{k: float(v) for k, v in m._asdict().items()},
                           "gen_grad_norm": grad_norm(torch, state.generator),
                           "disc_grad_norm": grad_norm(
                               torch, state.discriminator)}
        rel = {k: abs(res["cuda"][k] - v) / abs(v)
               for k, v in res["cpu"].items()}
        f.update(card=res["cuda"], cpu=res["cpu"], relative_err=rel)
        bad = {k: e for k, e in rel.items() if not e <= VOC_RTOL}
        if bad:
            raise AssertionError(f"GAN step card vs CPU beyond rtol "
                                 f"{VOC_RTOL}: {bad}")


def alignment_general_check(torch, kernels, name, args):
    """The general alignment kernel (f32 CUDA-core products) against the
    f32 plain version: out F32_TOL, idx exact, gnum GNUM_ATOL/GNUM_RTOL;
    two launches bit-equal."""
    out, idx, gnum = kernels.alignment_attention(*args)
    out2, idx2, gnum2 = kernels.alignment_attention(*args)
    torch.cuda.synchronize()
    r_out, r_idx, r_gnum = kernels.alignment_reference(*args)
    err = check_close(f"alignment_attention {name} out", out, r_out,
                      F32_TOL, torch)
    n_idx = int((idx != r_idx).sum())
    if n_idx:
        raise AssertionError(f"alignment_attention {name}: {n_idx} argmax "
                             "indices differ")
    gnum_err = check_close(f"alignment_attention {name} gnum", gnum, r_gnum,
                           GNUM_ATOL, torch, rtol=GNUM_RTOL)
    if not (torch.equal(out, out2) and torch.equal(idx, idx2)
            and torch.equal(gnum, gnum2)):
        raise AssertionError(f"alignment_attention {name}: two launches "
                             "differ")
    return dict(max_abs_err=err,
                mean_abs_err=(out - r_out).abs().mean().item(),
                gnum_max_abs_err=gnum_err, idx_differ=0, bit_equal=True)


def routed(kernels, name, fn):
    """``fn()``, and whether the wrapper launched its second kernel
    (``name`` of :func:`kernels.general_launches`) for it."""
    before = kernels.general_launches()[name]
    out = fn()
    return out, kernels.general_launches()[name] > before


def kernel_general_paths(torch, np, kernels, compiled):
    """The widths the first kernels do not take (ROADMAP §C.2).  Flash
    attention at head dims 32, 80 and 96 (zero-padded to the tensor-core
    kernel's 64 or 128) and 192 and 256 (the general kernel), f32 and bf16
    operands, held as the tensor-core kernel is (:func:`flash_errors`);
    alignment attention at D 30 and 96 (zero-padded to a multiple of 4:
    :func:`alignment_check`) and 192 (the general kernel:
    :func:`alignment_general_check`); the log-mel DFT kernel at n_fft 16,
    800, 1000, 1200 and 8192 against the float64 plain version
    (FFT_MEL_ATOL / FFT_ENERGY_RTOL) and ``log_mel_dft_reference``
    (FFT_REF_ATOL), bit-equal across launches.  Then each general kernel
    timed: flash at (8, 2, 4096, 192) beside its plain version and SDPA,
    alignment at the training shape with D 192, log-mel at (16, 8192) with
    n_fft 1200.  Returns the three kernels' entries."""
    import torch.nn.functional as F

    from smart_nar_fast_tts_tpu_torch.audio import (MelSpectrogramConfig,
                                                    mel_spectrogram)
    rng = np.random.default_rng(6)
    flash, align, dft = {}, {}, {}
    flash_err = align_err = dft_err = 0.0
    for D in (32, 80, 96, 192, 256):
        valid = flash_valid(torch, np, rng, 4, 700, "prefix")
        base = [torch.from_numpy(rng.standard_normal(
            (4, 2, 700, D)).astype(np.float32)).cuda() for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            with Phase("kernel flash_attention general widths") as f:
                q, k, v = (t.to(dtype) for t in base)
                out, general = routed(
                    kernels, "flash_attention_general",
                    lambda: kernels.flash_attention(q, k, v, valid))
                torch.cuda.synchronize()
                if general != (D > 128):
                    raise AssertionError(f"flash_attention D {D}: general "
                                         f"kernel launched: {general}")
                err, err_emu, share, mean = flash_errors(
                    torch, kernels, f"D {D}", out, q, k, v, valid)
                if general:
                    flash_err = max(flash_err, err_emu)
                f.update(D=D, dtype=str(dtype), shape=list(q.shape),
                         route="general" if general else
                         "tensor cores, D zero-padded",
                         max_abs_err=err, max_abs_err_vs_bf16_plain=err_emu,
                         bf16_tolerance_share=share,
                         mean_abs_err_vs_bf16_plain=mean)
    with Phase("kernel flash_attention general") as f:
        valid = flash_valid(torch, np, rng, B, T_CAP_LONG, "prefix")
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, 2, T_CAP_LONG, 192)).astype(np.float32)).cuda()
            for _ in range(3))
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        mask = valid[:, None, None, :]
        out = kernels.flash_attention(q, k, v, valid)
        err, err_emu, share, _ = flash_errors(torch, kernels, "D 192 timed",
                                              out, q, k, v, valid)
        ms = device_ms(lambda: kernels.flash_attention(q, k, v, valid),
                       torch, reps=5, warmup=1)
        plain_ms = device_ms(lambda: kernels.attention_reference(
            q, k, v, valid), torch, reps=5, warmup=1)
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=mask), torch)
        library_f32_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), torch)
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel()) + valid.numel()
        flops = 4 * 2 * T_CAP_LONG * 192 * int(valid.sum())
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
        flash = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     library="SDPA on bf16 operands",
                     library_f32_ms=library_f32_ms, bound_ms=bound_ms,
                     bound_by=bound_by, bound_share=bound_ms / ms,
                     shape=list(q.shape), max_abs_err=max(flash_err, err_emu),
                     max_abs_err_vs_f32_plain=err,
                     bf16_tolerance_share=share)
        f.update(flash)
    for D in (30, 96, 192):
        with Phase("kernel alignment_attention general widths") as f:
            args = alignment_inputs(torch, np, rng, 4, 2, 300, 70, D)
            check = (alignment_general_check if D > 128 else
                     alignment_check)
            checks, general = routed(
                kernels, "alignment_attention_general",
                lambda: check(torch, kernels, f"D {D}", args))
            if general != (D > 128):
                raise AssertionError(f"alignment_attention D {D}: general "
                                     f"kernel launched: {general}")
            if general:
                align_err = max(align_err, checks["max_abs_err"])
            f.update(D=D, route="general" if general else
                     "tensor cores, D zero-padded", **checks)
    with Phase("kernel alignment_attention general") as f:
        shape = (TRAIN_B, 2, TRAIN_T, TRAIN_L, 192)
        args = alignment_inputs(torch, np, rng, *shape)
        checks = alignment_general_check(torch, kernels, "D 192 timed", args)
        q, k, v, valid = args[:4]
        ms = device_ms(lambda: kernels.alignment_attention(*args), torch)
        plain_ms = device_ms(lambda: kernels.alignment_reference(*args),
                             torch)
        sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=valid[:, None, None, :]), torch)
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel()
                      + TRAIN_B * TRAIN_T + TRAIN_B
                      + 2 * args[4].numel()) + valid.numel()
        flops = 4 * 2 * TRAIN_T * 192 * int(valid.sum())
        bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
        align = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                     sdpa_f32_out_only_ms=sdpa_ms, bound_ms=bound_ms,
                     bound_by=bound_by, bound_share=bound_ms / ms,
                     shape=list(shape),
                     max_abs_err=max(align_err, checks["max_abs_err"]))
        f.update(align, gnum_max_abs_err=checks["gnum_max_abs_err"])
    tones = tone_with_pause(torch, np, rng, 4, 16384)
    for n in (16, 800, 1000, 1200, 8192):
        with Phase("kernel fused_log_mel dft") as f:
            c = MelSpectrogramConfig(n_fft=n, win_length=n,
                                     hop_length=max(n // 4, 1))
            (mel, energy), general = routed(
                kernels, "fused_log_mel_dft",
                lambda: kernels.fused_log_mel(tones, c))
            mel2, energy2 = kernels.fused_log_mel(tones, c)
            torch.cuda.synchronize()
            if not general:
                raise AssertionError(f"fused_log_mel n_fft {n}: the DFT "
                                     "kernel did not run")
            exact_mel, exact_energy = mel_spectrogram(tones.double(), c)
            twin_mel, twin_energy = kernels.log_mel_dft_reference(tones, c)
            mel_err = (mel.double() - exact_mel).abs().max().item()
            energy_err = ((energy.double() - exact_energy).abs()
                          / exact_energy.clamp(min=1e-30)).max().item()
            if mel_err > FFT_MEL_ATOL or energy_err > FFT_ENERGY_RTOL:
                raise AssertionError(
                    f"fused_log_mel n_fft {n} vs float64: mel {mel_err} "
                    f"(atol {FFT_MEL_ATOL}), energy {energy_err} relative "
                    f"(rtol {FFT_ENERGY_RTOL})")
            twin_err = check_close(f"fused_log_mel n_fft {n} vs "
                                   "log_mel_dft_reference", mel, twin_mel,
                                   FFT_REF_ATOL, torch)
            check_close(f"fused_log_mel n_fft {n} energy vs "
                        "log_mel_dft_reference", energy, twin_energy, 0.0,
                        torch, rtol=FFT_ENERGY_RTOL)
            if not (torch.equal(mel, mel2) and torch.equal(energy, energy2)):
                raise AssertionError(f"fused_log_mel n_fft {n}: two "
                                     "launches differ")
            dft_err = max(dft_err, mel_err)
            f.update(n_fft=n, shape=list(tones.shape), route="dft",
                     mel_vs_float64=mel_err, energy_rel_vs_float64=energy_err,
                     mel_vs_dft_reference=twin_err, bit_equal=True)
    with Phase("kernel fused_log_mel dft") as f:
        c = MelSpectrogramConfig(n_fft=1200, win_length=1200)
        y = torch.from_numpy(rng.uniform(-1, 1, (VOC_B, VOC_SEG)).astype(
            np.float32)).cuda()
        mel, energy = kernels.fused_log_mel(y, c)
        ms = device_ms(lambda: kernels.fused_log_mel(y, c), torch)
        plain_ms = device_ms(lambda: mel_spectrogram(y, c), torch)
        b, n_frames = energy.shape
        n_bins = c.n_fft // 2 + 1
        # the function's least work, as for the FFT kernel's entry
        per_frame = (c.win_length + 2.5 * c.n_fft * math.log2(c.n_fft)
                     + 5 * n_bins + 2 * np.count_nonzero(c.mel_basis)
                     + 2 * c.n_mels + 1)
        flops = b * n_frames * per_frame
        nbytes = 4 * (y.numel() + mel.numel() + energy.numel())
        bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
        dft = dict(ms=ms, plain_ms=plain_ms, library_ms=plain_ms,
                   library="the plain version (cuFFT rfft + mel product): "
                           "no one PyTorch call computes log-mel",
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms / ms, shape=list(y.shape),
                   n_fft=1200, max_abs_err=dft_err)
        f.update(dft)
    ptxas = kernel_ptxas(compiled, "attention_general", None, {})
    flash.update(ptxas=ptxas)
    align.update(ptxas=ptxas)
    return {"flash_attention_general": flash,
            "alignment_attention_general": align,
            "fused_log_mel_dft": dft}


# the CLI phase: configs/scaled/ and the committed 8-speaker flagship, with
# the committed HiFi-GAN V1 as an upstream-layout torch checkpoint
CLI_DIR = os.path.join(REPO, "build", "cli_smoke")
CLI_SPEAKER = 3
CLI_TEXT = ("The quick brown fox jumps over the lazy dog, while five boxing "
            "wizards jump quickly.")
# 336 phonemes: a predicted length between 2048 and 4096 frames
CLI_LONG = (
    "Speech synthesis turns written text into sound that people can listen "
    "to. A fast system reads the whole sentence at once, predicts how long "
    "each sound should last, and then paints a picture of the voice, frame "
    "by frame, before a second network turns that picture into a waveform. "
    "Long passages like this one are a good test, because the number of "
    "frames grows past the first capacity, so the program must notice, "
    "choose a larger capacity, and run the model again without cutting any "
    "words.")
# each within the configured text bucket (24 phonemes)
CLI_SOURCE = ("Hello world.", "Good morning to you.",
              "The sun is bright today.", "Please call me soon.",
              "We went for a walk.", "It is time to eat.",
              "She sells sea shells.", "Open the door slowly.",
              "Read the book again.", "The cat sat on a mat.",
              "Turn left at the light.", "Rain falls on the roof.")


def cli_workspace(torch, np):
    """``build/cli_smoke/``: copies of ``configs/scaled/*.yaml`` whose paths
    point there, ``stats.json`` from ``scaled_flagship_meta.json``, a port
    checkpoint of the committed 8-speaker flagship at its training step,
    HiFi-GAN V1 as ``{"generator": state_dict}`` (weight norm written out)
    with its ``config.json``, and the metadata file of the source run.
    Returns (config paths, step, vocoder path, metadata path)."""
    import re
    import shutil

    from smart_nar_fast_tts_tpu_torch.config import Config
    from smart_nar_fast_tts_tpu_torch.serving import (committed_flagship,
                                                      committed_vocoder)
    from smart_nar_fast_tts_tpu_torch.text import text_to_sequence
    from smart_nar_fast_tts_tpu_torch.text.g2p import G2P
    from smart_nar_fast_tts_tpu_torch.training import (CheckpointManager,
                                                       create_train_state)
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(os.path.join(CLI_DIR, "preprocessed"))
    moved = {"preprocessed_path": "preprocessed", "data_path": "raw",
             "ckpt_path": "ckpt", "log_path": "log", "result_path": "result"}
    paths = []
    for name in ("preprocess", "model", "train"):
        with open(os.path.join(REPO, "configs", "scaled",
                               f"{name}.yaml")) as f:
            text = f.read()
        for key, sub in moved.items():
            text = re.sub(rf'(\n\s*{key}:\s*)"[^"]*"',
                          lambda m, s=sub: f'{m.group(1)}"'
                          f'{os.path.join(CLI_DIR, s)}"', text)
        paths.append(os.path.join(CLI_DIR, f"{name}.yaml"))
        with open(paths[-1], "w") as f:
            f.write(text)
    results = os.path.join(REPO, "benchmarks", "results")
    with open(os.path.join(results, "scaled_flagship_meta.json")) as f:
        meta = json.load(f)
    st = meta["stats"]
    with open(os.path.join(CLI_DIR, "preprocessed", "stats.json"), "w") as f:
        json.dump({kind: [st[f"{kind}_{k}"] for k in ("min", "max", "mean",
                                                      "std")]
                   for kind in ("pitch", "energy")}, f)
    cfg = Config.from_yaml_triplet(*paths)
    if cfg.train.ckpt_path != os.path.join(CLI_DIR, "ckpt"):
        raise AssertionError(f"ckpt_path {cfg.train.ckpt_path}")
    state = create_train_state(
        committed_flagship(cfg.model, name="scaled_flagship"),
        cfg.train.optimizer, "cpu")
    state.step = int(meta["steps"])
    CheckpointManager(cfg.train.ckpt_path).save(state)
    vocoder = committed_vocoder()
    sd = {}
    for key, value in vocoder.state_dict().items():
        if key.endswith(".weight") and value.ndim == 3:   # weight norm, dim 0
            base = key[:-len(".weight")]
            sd[base + ".weight_g"] = value.flatten(1).norm(dim=1)[:, None,
                                                                  None]
            sd[base + ".weight_v"] = value
        else:
            sd[key] = value
    voc_dir = os.path.join(CLI_DIR, "hifigan")
    os.makedirs(voc_dir)
    voc_path = os.path.join(voc_dir, "generator_v1.pth.tar")
    torch.save({"generator": sd}, voc_path)
    with open(os.path.join(results, "vocoder_meta.json")) as f:
        voc_config = json.load(f)["config"]
    with open(os.path.join(voc_dir, "config.json"), "w") as f:
        json.dump({**voc_config, "num_mels": voc_config.get("n_mels", 80)},
                  f)
    g2p = G2P(cfg.preprocess.lexicon_path)
    lines = []
    for i, sentence in enumerate(CLI_SOURCE):
        phones = g2p(sentence)
        n = len(text_to_sequence(phones, list(cfg.preprocess.text_cleaners)))
        if n > max(cfg.train.text_buckets):
            raise AssertionError(f"{sentence!r}: {n} phonemes")
        lines.append(f"utt{i:02d}|{i % cfg.model.n_speakers}|{phones}|"
                     f"{sentence}")
    meta_path = os.path.join(CLI_DIR, "metadata.txt")
    with open(meta_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return paths, state.step, voc_path, meta_path


def cli_run(torch, np, kernels, synthesize, argv, flash_calls=None):
    """One call of the CLI's ``main`` with the launch counts set to 0 just
    before and read just after; checks every written file.  Returns (the
    utterances, counts, wall seconds, seconds of audio)."""
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.models import layers
    flash = layers.flash_attention

    def spy(q, k, v, key_valid):          # the model's call, recorded
        out = flash(q, k, v, key_valid)
        flash_calls.append((q, k, v, key_valid, out))
        return out

    kernels.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(layers, "flash_attention",
                           spy if flash_calls is not None else flash):
        utts = synthesize.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**kernels.launches(), **kernels.general_launches()}
    for u in utts:
        with open(u.base + ".png", "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"{u.base}.png is no PNG")
        if os.path.getsize(u.base + ".wav") != 44 + 2 * u.wav.shape[0]:
            raise AssertionError(f"{u.base}.wav: wrong size")
        if not (u.mel_len > 0 and np.isfinite(u.postnet_mel).all()
                and np.isfinite(u.wav).all()):
            raise AssertionError(f"{u.name}: empty or non-finite output")
    seconds = sum(u.mel_len for u in utts) * 256 / 22050
    return utts, counts, wall, seconds


def cli_reference(torch, np, kernels, synthesize, cfg, step, runs):
    """Each run's batches through the same checkpoint on the CPU (the plain
    versions), at the run's controls: capacity and durations exact, the
    postnet mel within MEL_TOL.  In the long run the decoder's flash
    launches are replaced on the CPU by their card outputs (recorded on
    the path), which were held to ``attention_bf16_reference`` of their own
    inputs; so the rest of the model is held at MEL_TOL there too.  Also
    reported: the long run against a CPU run whose flash calls take
    ``attention_bf16_reference``."""
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.models import layers
    model, restored = synthesize.load_model(cfg, step, torch.device("cpu"))
    if restored != step:
        raise AssertionError(f"CPU model restored step {restored}")
    report = {}
    for name, (utts, controls, flash_calls) in runs.items():
        fwd = synthesize.make_forward(model, cfg, *controls)
        errs, done = [], {}
        for u in utts:
            key = id(u.batch)
            if key not in done:
                if flash_calls:
                    card = [c[4].cpu() for c in flash_calls]
                    with mock.patch.object(layers, "flash_attention",
                                           lambda *a: card.pop(0)):
                        done[key] = fwd(*u.batch)
                    if card:
                        raise AssertionError(f"{name}: {len(card)} flash "
                                             "outputs not replayed")
                else:
                    done[key] = fwd(*u.batch)
            out = done[key]
            L = len(u.ids)
            if out.postnet_mel.shape[1] != u.cap or int(
                    out.mel_lens[u.j]) != u.mel_len:
                raise AssertionError(f"{name} {u.name}: capacity or mel_len "
                                     "differs from the CPU run")
            if not np.array_equal(out.duration_rounded[u.j, :L].numpy(),
                                  u.duration):
                raise AssertionError(f"{name} {u.name}: durations differ "
                                     "from the CPU run")
            n = u.postnet_mel.shape[0]
            errs.append(np.abs(out.postnet_mel[u.j, :n].numpy()
                               - u.postnet_mel).max())
        err = float(max(errs))
        if not err <= MEL_TOL:
            raise AssertionError(f"{name}: postnet mel {err} from the CPU "
                                 f"run, over {MEL_TOL}")
        report[name] = err
        if flash_calls:
            def bf16_plain(q, k, v, key_valid):
                return kernels.attention_bf16_reference(q, k, v, key_valid)
            with mock.patch.object(layers, "flash_attention", bf16_plain):
                out = fwd(*utts[0].batch)
            n = utts[0].postnet_mel.shape[0]
            gap = np.abs(out.postnet_mel[0, :n].numpy()
                         - utts[0].postnet_mel)
            report[f"{name}_vs_cpu_bf16_plain_max"] = float(gap.max())
            report[f"{name}_vs_cpu_bf16_plain_mean"] = float(gap.mean())
    return report


def cli_phase(torch, np, kernels):
    """This slice's main path: ``python -m
    smart_nar_fast_tts_tpu_torch.cli.synthesize`` as ``main(argv)`` on the
    committed 8-speaker flagship (``configs/scaled/``) and HiFi-GAN V1, each
    run with the launch counts set to 0 just before and read just after:
    (a) ``--text`` with speaker 3; (b) a passage whose predicted length
    passes 2048 frames: it escalates to cap 4096 (4 flash launches, 2
    upsampling: probe and rerun), each flash output held to
    ``attention_bf16_reference`` of its own inputs; (c) ``--source`` on 12
    sentences, batch 8, the configured text bucket; (d) ``--duration_control
    1.8 --pitch_control 1.2``; (e) Griffin-Lim (no vocoder checkpoint).
    Every .wav and .png is checked; durations and postnet mel against the
    CPU (:func:`cli_reference`).  Then the CLI is imported in a process
    where yaml, matplotlib, jax and the JAX package cannot be imported."""
    import argparse

    from smart_nar_fast_tts_tpu_torch.cli import synthesize
    from smart_nar_fast_tts_tpu_torch.cli._args import load_config
    with Phase("cli setup") as f:
        paths, step, voc, meta = cli_workspace(torch, np)
        cfg = load_config(argparse.Namespace(
            preprocess_config=paths[0], model_config=paths[1],
            train_config=paths[2]))
        if cfg.preprocess.stats is None:
            raise AssertionError("stats.json was not found")
        f.update(step=step, configs=paths, vocoder=voc)
    base = ["-p", paths[0], "-m", paths[1], "-t", paths[2],
            "--restore_step", str(step)]
    hifigan = ["--vocoder_ckpt", voc]
    runs, entry, flash_calls = {}, {}, []
    plan = (
        ("text", ["--text", CLI_TEXT, "--speaker_id", str(CLI_SPEAKER)]
         + hifigan, (1.0, 1.0, 1.0), None),
        ("long", ["--text", CLI_LONG, "--speaker_id", str(CLI_SPEAKER)]
         + hifigan, (1.0, 1.0, 1.0), flash_calls),
        ("source", ["--source", meta, "--batch_size", "8"] + hifigan,
         (1.0, 1.0, 1.0), None),
        ("controls", ["--text", CLI_TEXT, "--duration_control", "1.8",
                      "--pitch_control", "1.2"] + hifigan,
         (1.2, 1.0, 1.8), None),
        ("griffin-lim", ["--text", CLI_TEXT], (1.0, 1.0, 1.0), None))
    for name, argv, controls, calls in plan:
        with Phase(f"cli {name}") as f:
            utts, counts, wall, seconds = cli_run(
                torch, np, kernels, synthesize, base + argv, calls)
            caps = sorted({u.cap for u in utts})
            f.update(utterances=len(utts), caps=caps, launches=counts,
                     mel_lens=[u.mel_len for u in utts],
                     audio_seconds=seconds, wall_seconds=wall,
                     wall_seconds_per_utterance=wall / len(utts),
                     rtf=wall / seconds, nvidia_smi=nvidia_smi())
            if name == "long":
                if caps != [T_CAP_LONG] or counts["flash_attention"] != 4 \
                        or counts["gaussian_upsample_banded"] != 2:
                    raise AssertionError(f"long run: caps {caps}, launches "
                                         f"{counts}")
                shares = []
                for q, k, v, valid, out in flash_calls:
                    ref = kernels.attention_bf16_reference(q, k, v, valid)
                    tol = kernels.attention_bf16_tolerance(q, k, v, valid,
                                                           ref)
                    shares.append(((out - ref).abs() / tol).max().item())
                if len(shares) != 4 or not max(shares) <= 1.0:
                    raise AssertionError(f"long run: flash outputs beyond "
                                         f"attention_bf16_tolerance {shares}")
                f.update(flash_shapes=[list(c[0].shape) for c in flash_calls],
                         flash_bf16_tolerance_share=shares)
            elif counts["flash_attention"] or not counts[
                    "gaussian_upsample_banded"]:
                raise AssertionError(f"{name}: launches {counts}")
            if name == "source" and len(utts) != len(CLI_SOURCE):
                raise AssertionError(f"source run wrote {len(utts)}")
            runs[name] = (utts, controls, calls)
            entry[name] = dict(launches=counts, rtf=wall / seconds,
                               wall_seconds=wall, audio_seconds=seconds,
                               utterances=len(utts), caps=caps)
    with Phase("cli reference") as f:
        report = cli_reference(torch, np, kernels, synthesize, cfg, step,
                               runs)
        f.update(postnet_mel_max_err=report, mel_tol=MEL_TOL)
    with Phase("cli imports") as f:
        blocked = ("yaml", "matplotlib", "jax", "flax",
                   "smart_nar_fast_tts_tpu")
        code = (f"import sys\nfor n in {blocked!r}:\n    sys.modules[n] = "
                "None\nimport smart_nar_fast_tts_tpu_torch.cli.synthesize\n")
        res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise AssertionError(f"the CLI needs a blocked module:\n"
                                 f"{res.stderr[-2000:]}")
        f.update(blocked=list(blocked))
    return entry, report


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

    with Phase("env") as f:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = nvidia_smi()
        f.update(nvidia_smi=smi, torch=torch.__version__,
                 cuda=torch.version.cuda, python=sys.version.split()[0],
                 device=torch.cuda.get_device_name(0),
                 count=torch.cuda.device_count(), tf32=False)

    with Phase("build") as f:
        compiled = _build.build_all()
        f.update(nvcc=_build.find_nvcc(), out=str(_build.build_dir()),
                 compiled=compiled)

    entries = {
        "flash_attention": dict(
            route="cuda",
            source="smart_nar_fast_tts_tpu_torch/csrc/flash_attention.cu",
            replaces="smart_nar_fast_tts_tpu/ops/pallas/attention.py:52",
            **kernel_flash_attention(torch, np, kernels, compiled)),
        "gaussian_upsample_banded": dict(
            route="cuda",
            source="smart_nar_fast_tts_tpu_torch/csrc/gaussian_upsample.cu",
            replaces="smart_nar_fast_tts_tpu/ops/pallas/upsample.py:25",
            **kernel_gaussian_upsample(torch, np, kernels, compiled)),
        "alignment_attention": dict(
            route="cuda",
            source="smart_nar_fast_tts_tpu_torch/csrc/alignment_attention.cu",
            replaces="smart_nar_fast_tts_tpu/ops/pallas/alignment.py:67",
            **kernel_alignment_attention(torch, np, kernels, compiled)),
    }
    for name, err in kernel_backward(torch, np, kernels).items():
        entries[name]["grad_max_abs_err"] = err
    general = kernel_general_paths(torch, np, kernels, compiled)

    texts, src_lens, inv = bench_inputs(np)
    synth, short, wav, mel_lens, serving, ups_cap1000 = e2e_phase(
        torch, kernels, texts, src_lens)
    long_counts, ups_cap4096 = e2e_long_phase(torch, kernels, synth, short,
                                              texts, src_lens)
    entries["gaussian_upsample_banded"].update(
        cap1000_path=ups_cap1000, cap4096_path=ups_cap4096)
    segments = vocoder_segments(torch, np, wav, mel_lens, synth.hop_length)
    entries["fused_log_mel"] = dict(
        route="cuda", source="smart_nar_fast_tts_tpu_torch/csrc/log_mel.cu",
        replaces="smart_nar_fast_tts_tpu/ops/pallas/stft.py:46",
        **kernel_fused_log_mel(torch, np, kernels, segments, compiled))
    reference_phase(torch, np, synth, inv)
    cli_counts, cli_errs = cli_phase(torch, np, kernels)

    train_counts = train_phase(torch, np, kernels, synth, inv)
    train_reference_phase(torch, np, inv)
    gan_counts = vocoder_train_phase(torch, kernels, synth, segments)
    vocoder_train_reference_phase(torch, np)

    # each kernel's launches on its path's run: flash attention on the
    # cap-4096 serving batch, upsampling and alignment attention over the
    # training steps, the log-mel kernel over the GAN steps
    paths = {"flash_attention": ("serving stage A at cap 4096", long_counts),
             "gaussian_upsample_banded": (f"{TRAIN_STEPS} train steps",
                                          train_counts),
             "alignment_attention": (f"{TRAIN_STEPS} train steps",
                                     train_counts),
             "fused_log_mel": (f"{VOC_STEPS} GAN steps", gan_counts)}
    for name, (path, counts) in paths.items():
        if counts[name] == 0:
            raise AssertionError(f"{path} never launched {name}")
        entries[name].update(
            launches=counts[name], path=path,
            launches_per_serving_batch=serving[name],
            launches_per_serving_batch_cap4096=long_counts[name],
            launches_per_train_step=train_counts[name] // TRAIN_STEPS,
            launches_per_gan_step=gan_counts[name] // VOC_STEPS,
            launches_cli={run: c["launches"][name]
                          for run, c in cli_counts.items()})
    # the second kernels: no driven path has a head dim past 128 or an
    # n_fft that is not a power of two, so each counts 0 on every path
    sources = {
        "flash_attention_general": (
            "smart_nar_fast_tts_tpu_torch/csrc/attention_general.cu",
            "smart_nar_fast_tts_tpu/ops/pallas/attention.py:52"),
        "alignment_attention_general": (
            "smart_nar_fast_tts_tpu_torch/csrc/attention_general.cu",
            "smart_nar_fast_tts_tpu/ops/pallas/alignment.py:67"),
        "fused_log_mel_dft": (
            "smart_nar_fast_tts_tpu_torch/csrc/log_mel.cu",
            "smart_nar_fast_tts_tpu/ops/pallas/stft.py:46")}
    for name, entry in general.items():
        source, replaces = sources[name]
        launched = {run: c["launches"][name] for run, c in cli_counts.items()}
        entries[name] = dict(
            route="cuda", source=source, replaces=replaces,
            launches=launched["long"], launches_cli=launched,
            path="none: the driven paths have head dim 128 and n_fft 1024",
            **entry)
    entries["flash_attention"]["cli_long_path"] = (
        "synthesize CLI, long passage: cap 4096")

    emit({"kernels": [{"name": name, **entry}
                      for name, entry in entries.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
