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
            registers, shared memory and spills of each of its kernels
  e2e       ``Synthesizer.from_committed().synthesize`` on bench.py's serving
            inputs (B 8, L 128, T_CAP 1000), with every kernel's launch count
            set to 0 just before and read just after; then stage timings.
            Self-attention runs the flash kernel only past 2048 frames, as
            the JAX model, so this path launches upsampling alone
  e2e cap 4096  stage A of the same inputs at the 4096-frame cap of the JAX
            package's ``serving_mel_caps``: the decoder's self-attention runs
            the flash kernel (4 launches at (8, 2, 4096, 128)), the encoder's
            does not; then the kernel alone on each launch's own inputs
  kernel fused_log_mel  the log-mel kernel against its plain version on
            noise, the synthesised speech segments of the GAN phase and
            silence, at the GAN step's shape (B 16 × 8192 samples) and a tiny
            configuration, and against the plain version run in float64 on
            those and on tones with a pause; then timed
  reference the card's output against the port's CPU run (plain versions)
            on a small input: durations exact, postnet mel within 1e-3
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
                    # most L terms, and what the band leaves out weighs
                    # below exp(-36) ≈ 2e-16 of the total
PRED_TOL = 1e-2     # log-durations on the card vs the f32 CPU run
MEL_TOL = 1e-3      # postnet mel on the card vs the f32 CPU run (ROADMAP's
                    # "done" tolerance for mels)
LOGMEL_ATOL, LOGMEL_RTOL = 2e-4, 1e-4    # the log-mel kernel against its
ENERGY_ATOL = 2e-3  # plain version (cuFFT): the JAX package's kernel test
VOC_RTOL = 1e-3     # a narrow GAN step on the card vs the CPU, f32 both
WAV_TOL = 1e-3      # the vocoder (f32 convolutions, no TF32) on one input
GNUM_ATOL, GNUM_RTOL = 1e-4, 1e-5   # the alignment kernel's guided
                    # numerator: sums of up to T·L f32 terms (the JAX
                    # package's kernel test)
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


def kernel_gaussian_upsample(torch, np, kernels):
    from smart_nar_fast_tts_tpu_torch.kernels.upsample import BAND_SIGMAS
    from smart_nar_fast_tts_tpu_torch.ops import gaussian_upsample
    rng = np.random.default_rng(2)
    entry, err_max = {}, 0.0
    # serving: Σd below T (durations 0..7) and above T (4..15); training:
    # (48, 128, 256) to 896 frames, Σd around T (durations 5..9)
    for name, b, Lx, T, (lo, hi) in (
            ("short", B, L, T_CAP, (0, 8)), ("long", B, L, T_CAP, (4, 16)),
            ("train", TRAIN_B, TRAIN_L, TRAIN_T, (5, 10))):
        if name != "long":
            x = torch.from_numpy(rng.standard_normal((b, Lx, 256)).astype(
                np.float32)).cuda()
            lens = torch.from_numpy(rng.integers(Lx - 32, Lx + 1, size=b)
                                    ).cuda()
            valid = (torch.arange(Lx, device="cuda")[None]
                     < lens[:, None]).float()
        with Phase("kernel gaussian_upsample") as f:
            d = torch.from_numpy(rng.integers(lo, hi, size=(b, Lx))
                                 ).float().cuda()
            out, mel_len = kernels.gaussian_upsample_banded(x, d, T, valid)
            torch.cuda.synchronize()
            ref, ref_len, _ = gaussian_upsample(x, d, T, valid)
            err = check_close(f"gaussian_upsample {name}", out, ref,
                              F32_TOL, torch)
            if not torch.equal(mel_len, ref_len):
                raise AssertionError("gaussian_upsample: mel_len differs")
            err_max = max(err_max, err)
            ms = device_ms(lambda: kernels.gaussian_upsample_banded(
                x, d, T, valid), torch)
            plain_ms = device_ms(lambda: gaussian_upsample(
                x, d, T, valid), torch)
            # (frame, phoneme) pairs within the band (σ = 10, the default
            # used above), over valid phonemes and frames below min(Σd, T)
            dv = d * valid
            e = torch.cumsum(dv, 1)
            c = e - 0.5 * dv
            t = torch.arange(T, device="cuda", dtype=torch.float32)
            near = ((t[None, :, None] - c[:, None, :]).abs()
                    <= BAND_SIGMAS * 10.0) \
                & (valid[:, None, :] > 0) \
                & (t[None, :, None] < e[:, -1, None, None])
            flops = 2 * 256 * int(near.sum())
            nbytes = 4 * (x.numel() + d.numel() + valid.numel()
                          + out.numel() + mel_len.numel())
            bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
            f.update(case=name, total_frames=e[:, -1].tolist()[:8],
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
            if name == "long":
                entry.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                             bound_ms=bound_ms, bound_by=bound_by,
                             shape=[B, L, 256, T_CAP])
            elif name == "train":
                entry.update(train_ms=ms, train_plain_ms=plain_ms,
                             train_bound_ms=bound_ms, train_bound_by=bound_by,
                             train_shape=[b, Lx, 256, T])
    entry["max_abs_err"] = err_max
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


def kernel_alignment_attention(torch, np, kernels):
    import torch.nn.functional as F
    rng = np.random.default_rng(3)
    entry, err_max = None, 0.0
    # the flagship training shape, and a ragged one (T not a multiple of
    # the kernel's 32-frame tile, L 13)
    for name, shape in (("train", (TRAIN_B, 2, TRAIN_T, TRAIN_L, 128)),
                        ("ragged", (3, 2, 45, 13, 128))):
        with Phase("kernel alignment_attention") as f:
            args = alignment_inputs(torch, np, rng, *shape)
            out, idx, gnum = kernels.alignment_attention(*args)
            _, idx2, gnum2 = kernels.alignment_attention(*args)
            torch.cuda.synchronize()
            r_out, r_idx, r_gnum = kernels.alignment_reference(*args)
            err = check_close(f"alignment_attention {name} out", out, r_out,
                              F32_TOL, torch)
            n_idx = int((idx != r_idx).sum())
            if n_idx:
                raise AssertionError(f"alignment_attention {name}: {n_idx} "
                                     "argmax indices differ")
            gnum_err = check_close(f"alignment_attention {name} gnum", gnum,
                                   r_gnum, GNUM_ATOL, torch, rtol=GNUM_RTOL)
            if not (torch.equal(gnum, gnum2) and torch.equal(idx, idx2)):
                raise AssertionError("alignment_attention: two launches "
                                     "differ")
            err_max = max(err_max, err)
            f.update(case=name, shape=list(shape), max_abs_err=err,
                     gnum_max_abs_err=gnum_err, idx_differ=n_idx,
                     src_lens=args[4].tolist()[:4],
                     gnum_bit_equal_across_launches=True)
            if name != "train":
                continue
            q, k, v, valid = args[:4]
            ms = device_ms(lambda: kernels.alignment_attention(*args), torch)
            plain_ms = device_ms(lambda: kernels.alignment_reference(*args),
                                 torch)
            sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=valid[:, None, None, :]), torch)
            nbytes = 4 * (2 * q.numel() + k.numel() + v.numel() + idx.numel()
                          + gnum.numel() + 2 * args[4].numel()) \
                + valid.numel()
            # QKᵀ and PV over the valid keys, every frame, in f32
            b_, h_, t_, _, d_ = shape
            flops = 4 * h_ * t_ * d_ * int(valid.sum())
            bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
            f.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                     sdpa_f32_out_only_ms=sdpa_ms, bound_ms=bound_ms,
                     bound_by=bound_by, flops=flops, bytes=nbytes)
            entry = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                         sdpa_f32_out_only_ms=sdpa_ms, bound_ms=bound_ms,
                         bound_by=bound_by, shape=list(shape))
    entry["max_abs_err"] = err_max
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


def e2e_phase(torch, kernels, texts, src_lens):
    """The serving main path at cap 1000, once, through the user's entry
    point; then stage timings."""
    from smart_nar_fast_tts_tpu_torch.serving import Synthesizer, bucket
    with Phase("e2e") as f:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        synth = Synthesizer.from_committed()
        f["load_seconds"] = time.perf_counter() - t0
        kernels.reset_launches()
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
    return synth, out, wav, mel_lens, counts


def e2e_long_phase(torch, kernels, synth, short, texts, src_lens):
    """Stage A of the same inputs at cap 4096, through ``Synthesizer(...,
    t_cap=4096)``: the decoder's four self-attentions run the flash kernel
    at (8, 2, 4096, 128), the encoder's none.  Its durations equal the
    cap-1000 run's; its mel differs over the frames they share because the
    decoder attends over every frame (up to 4096 instead of 1000) and
    through the kernel's bf16 operands: reported, not held."""
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.models import layers
    from smart_nar_fast_tts_tpu_torch.serving import Synthesizer
    with Phase("e2e cap 4096") as f:
        long_synth = Synthesizer(synth.model, synth.vocoder, t_cap=T_CAP_LONG)
        calls, flash = [], layers.flash_attention

        def spy(q, k, v, key_valid):          # the model's call, recorded
            calls.append((q, k, v, key_valid))
            return flash(q, k, v, key_valid)

        kernels.reset_launches()
        with mock.patch.object(layers, "flash_attention", spy):
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
    return counts


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


def kernel_fused_log_mel(torch, np, kernels, segments):
    """The log-mel kernel against its plain version (cuFFT rfft and the mel
    product) on noise, the speech segments and silence at the GAN step's
    shape and on noise at a tiny configuration; each also against the plain
    version run in float64.  On tones with a pause, where the f32 plain
    version is itself off, the kernel is held to the float64 run only.
    Then timed on the speech segments."""
    from smart_nar_fast_tts_tpu_torch.audio import (MelSpectrogramConfig,
                                                    mel_spectrogram)
    rng = np.random.default_rng(5)
    cfg = MelSpectrogramConfig()
    tiny = MelSpectrogramConfig(n_fft=32, hop_length=8, win_length=32,
                                n_mels=8, mel_fmax=None)
    noise = torch.from_numpy(rng.uniform(-1, 1, segments.shape).astype(
        np.float32)).cuda()
    tones = tone_with_pause(torch, np, rng, *segments.shape)
    entry, err_max = {}, 0.0
    for name, y, c in (("noise", noise, cfg), ("speech", segments, cfg),
                       ("zeros", torch.zeros_like(segments), cfg),
                       ("tiny noise", noise[:3, :300].contiguous(), tiny),
                       ("tones with a pause", tones, cfg)):
        with Phase("kernel fused_log_mel") as f:
            mel, energy = kernels.fused_log_mel(y, c)
            torch.cuda.synchronize()
            ref_mel, ref_energy = mel_spectrogram(y, c)
            exact_mel, exact_energy = (t.float() for t in mel_spectrogram(
                y.double(), c))
            if mel.shape != ref_mel.shape or energy.shape != ref_energy.shape:
                raise AssertionError(f"fused_log_mel {name}: shapes "
                                     f"{tuple(mel.shape)} {tuple(energy.shape)}")
            held = [("float64", exact_mel, exact_energy)]
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
            errs["plain_mel_vs_float64"] = (ref_mel - exact_mel).abs().max(
            ).item()
            if name == "zeros" and not (torch.equal(mel, torch.log(
                    torch.full_like(mel, c.compression_clip)))
                    and not energy.any()):
                raise AssertionError("fused_log_mel of silence is not "
                                     "log(clip) and 0")
            err_max = max(err_max, errs["mel_vs_float64"],
                          errs.get("mel_vs_plain", 0.0))
            f.update(case=name, shape=list(y.shape), n_fft=c.n_fft,
                     mel_min=mel.min().item(), **errs)
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
            # what the kernel's own algorithm does: the two windowed DFT
            # products and the dense mel product
            dft_flops = 2 * b * n_frames * (2 * c.n_fft * n_bins
                                            + n_bins * c.n_mels)
            nbytes = 4 * (y.numel() + mel.numel() + energy.numel())
            bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=plain_ms,
                          library="the plain version (cuFFT rfft + mel "
                                  "product): no one PyTorch call computes "
                                  "log-mel",
                          bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                          dft_flops=dft_flops,
                          dft_bound_ms=dft_flops / F32_FLOPS * 1e3)
            f.update(timing)
            entry.update(timing, shape=list(y.shape))
    entry["max_abs_err"] = err_max
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
            **kernel_gaussian_upsample(torch, np, kernels)),
        "alignment_attention": dict(
            route="cuda",
            source="smart_nar_fast_tts_tpu_torch/csrc/alignment_attention.cu",
            replaces="smart_nar_fast_tts_tpu/ops/pallas/alignment.py:67",
            **kernel_alignment_attention(torch, np, kernels)),
    }
    for name, err in kernel_backward(torch, np, kernels).items():
        entries[name]["grad_max_abs_err"] = err

    texts, src_lens, inv = bench_inputs(np)
    synth, short, wav, mel_lens, serving = e2e_phase(torch, kernels, texts,
                                                     src_lens)
    long_counts = e2e_long_phase(torch, kernels, synth, short, texts,
                                 src_lens)
    segments = vocoder_segments(torch, np, wav, mel_lens, synth.hop_length)
    entries["fused_log_mel"] = dict(
        route="cuda", source="smart_nar_fast_tts_tpu_torch/csrc/log_mel.cu",
        replaces="smart_nar_fast_tts_tpu/ops/pallas/stft.py:46",
        **kernel_fused_log_mel(torch, np, kernels, segments))
    reference_phase(torch, np, synth, inv)

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
            launches_per_gan_step=gan_counts[name] // VOC_STEPS)

    emit({"kernels": [{"name": name, **entry}
                      for name, entry in entries.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
