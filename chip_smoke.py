#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; each prints one JSON line with its elapsed seconds, and
any failure raises (exit code 1):

  env       card, torch and CUDA versions; TF32 off for matmuls and cuDNN
  build     nvcc of every ``smart_nar_fast_tts_tpu_torch/csrc/*.cu``
  kernel    each CUDA kernel against its plain PyTorch version on the card at
            the shapes of its path (serving for flash attention and
            upsampling, training for alignment attention), then timed beside
            it (and beside one PyTorch library call where one computes the
            same function); then each kernel's backward (its
            ``autograd.Function``) against autograd through its plain version
  e2e       ``Synthesizer.from_committed().synthesize`` on bench.py's serving
            inputs (B 8, L 128, T_CAP 1000), with every kernel's launch count
            set to 0 just before and read just after; then stage timings
  reference the card's output against the port's CPU run (plain versions)
            on a small input
  train     the training slice's main path: ``make_train_step`` on the
            committed flagship with ``intended``/``first`` duration
            extraction (the alignment kernel's path) at the flagship training
            shape (B 48, L 128, T 896), 5 steps with seeded dropout, with the
            launch counts set to 0 just before and read just after; then one
            step of the default ``soft``/``mean`` configuration
  train_reference  one step on the card against the same step through the
            port's plain versions on the CPU, seeded weights and batch

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
# the flagship training shape (benchmarks/train_throughput.py:27)
TRAIN_B, TRAIN_L, TRAIN_T, TRAIN_STEPS = 48, 128, 896, 5
# launches of each kernel per training step: 4 text-encoder and 4
# mel-decoder self-attentions, one per MelEncoder layer, one upsampling
PER_TRAIN_STEP = {"flash_attention": 8, "alignment_attention": 4,
                  "gaussian_upsample_banded": 1}

BF16_TOL = 2e-2     # the flash kernel rounds q·scale, k, v and p to bf16
F32_TOL = 1e-5      # the upsampling kernel is f32 throughout: sums of at
                    # most L terms, and what the band leaves out weighs
                    # below exp(-36) ≈ 2e-16 of the total
PRED_TOL = 1e-2     # log-durations on the card vs the f32 CPU run
WAV_TOL = 1e-3      # the vocoder (f32 convolutions, no TF32) on one input
GNUM_ATOL, GNUM_RTOL = 1e-4, 1e-5   # the alignment kernel's guided
                    # numerator: sums of up to T·L f32 terms (the JAX
                    # package's kernel test)
GRAD_TOL = 1e-4     # a backward recomputes the plain version: f32 rounding
TRAIN_RTOL = 2e-2   # a train step on the card vs the CPU: the flash
                    # kernel's bf16 operands move losses and gradients


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
    entry, err_max = {}, 0.0
    # serving encoder (8, 2, 128, 128) and decoder (8, 2, 1000, 128), then
    # training encoder (48, 2, 128, 128) and decoder (48, 2, 896, 128)
    for name, b, Lx in (("encoder", B, L), ("decoder", B, T_CAP),
                        ("train encoder", TRAIN_B, TRAIN_L),
                        ("train decoder", TRAIN_B, TRAIN_T)):
        lens = rng.integers(Lx // 2, Lx + 1, size=b)
        lens[0] = 0                                   # a fully masked item
        valid = torch.from_numpy(np.arange(Lx)[None, :] < lens[:, None]
                                 ).cuda()
        base = [torch.from_numpy(rng.standard_normal(
            (b, 2, Lx, 128)).astype(np.float32)).cuda() for _ in range(3)]
        dtypes = (torch.float32,) if name.startswith("train") \
            else (torch.float32, torch.bfloat16)
        for dtype in dtypes:
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
                f.update(case=name, shape=list(q.shape), dtype=str(dtype),
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
                    entry.update(ms=ms, plain_ms=plain_ms,
                                 library_ms=library_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, shape=list(q.shape))
                elif name == "train decoder":
                    entry.update(train_ms=ms, train_plain_ms=plain_ms,
                                 train_library_ms=library_ms,
                                 train_bound_ms=bound_ms,
                                 train_bound_by=bound_by,
                                 train_shape=list(q.shape))
    entry["max_abs_err"] = err_max
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
        "alignment_attention": dict(
            route="cuda",
            source="smart_nar_fast_tts_tpu_torch/csrc/alignment_attention.cu",
            replaces="smart_nar_fast_tts_tpu/ops/pallas/alignment.py:67",
            **kernel_alignment_attention(torch, np, kernels)),
    }
    for name, err in kernel_backward(torch, np, kernels).items():
        entries[name]["grad_max_abs_err"] = err

    texts, src_lens, inv = bench_inputs(np)
    with Phase("e2e") as f:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        synth = Synthesizer.from_committed()
        f["load_seconds"] = time.perf_counter() - t0
        # the main path, once, through the user's entry point
        kernels.reset_launches()
        wav, mel_lens = synth.synthesize(texts, src_lens)
        torch.cuda.synchronize()
        counts = kernels.launches()
        for name in ("flash_attention", "gaussian_upsample_banded"):
            if counts[name] == 0:
                raise AssertionError(f"serving never launched {name}")
        for name, n in counts.items():
            entries[name]["launches_per_serving_batch"] = n
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

    counts = train_phase(torch, np, kernels, synth, inv)
    for name, n in counts.items():
        entries[name]["launches"] = n
        entries[name]["launches_per_train_step"] = n // TRAIN_STEPS
    train_reference_phase(torch, np, inv)

    emit({"kernels": [{"name": name, **entry}
                      for name, entry in entries.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
