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
            At head dims 192 and 256 (64-key tiles) it is checked and timed
            the same way at (8, 2, 4096, D), at D 192 also on holes and
            last-tile masks, bit-equal across launches, the wide kernel
            not launched.  The alignment kernel (3xTF32 products) is also
            held to ``alignment_tf32x3_reference`` at the training shape, a
            ragged one and L 1000, and on q = 0 and v = identity (each
            product apart), and so at D 192 and 256 (training shape, q = 0,
            v = identity); it is timed at the training shape at D 128, 192
            and 256 beside its plain version and f32 SDPA on ``out`` alone,
            against its 3xTF32 tensor-core bound and the f32 CUDA-core one,
            with its ptxas figures.  The upsampling kernel is
            also checked on a channel tail (D 70), 300 phonemes of 0 or 1
            frames, all durations 0, T 4096 (frames past Σd exactly 0,
            mel_len exact) and phonemes longer than 12σ (one of 132 frames;
            [7, 9, 4, 11, 6, d_last] for d_last 120-190), with its ptxas
            figures
  kernel ... widths  the widths the first kernels do not take as they
            are: flash attention at head dims 32, 80, 96, 160, 200
            (zero-padded to 64, 128, 192 or 256), 192, 256, 288 and 320 (the
            wide kernel, past 256), alignment attention at D 30, 96, 150
            (padded), 192, 256, 300 and 320 (wide), the log-mel mixed-radix
            FFT kernel at n_fft 16, 8192, 400, 800, 882, 1000, 1200, 1920,
            2400, 1001, 1202, 1201, 7263 and 14526 and the DFT kernel at
            7265 and 14527 (each against float64, its twin, and itself);
            then the wide kernels at head dims 320, 384 and 512: flash at
            (8, 2, 4096, D) (at 320 also on holes and last-tile masks), f32
            and bf16 operands, bit-equal across launches, timed beside its
            plain version and SDPA on both; alignment at the training shape,
            held as above and timed beside its plain version and f32 SDPA
            on ``out``; with their ptxas figures; the mixed-radix kernel
            timed at (16, 8192) for n_fft 1200, 400, 882, 1001, 1201, 1202
            and 8192 (the DFT kernel's body beside it at 1200-1202), the
            DFT kernel at n_fft 7265
  e2e       ``Synthesizer.from_committed().synthesize`` on bench.py's serving
            inputs (B 8, L 128, T_CAP 1000), with every kernel's launch count
            set to 0 just before and read just after; then stage timings,
            and the upsampling kernel alone on the path's own recorded
            inputs.  Self-attention runs the flash kernel only past 2048
            frames, as the JAX model, so this path launches upsampling and
            HiFi-GAN V1's 72 resblock convs alone
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
            ``attention_bf16_reference`` of its own inputs); then the seven
            CLIs (synthesize, train, evaluate, train_vocoder, preprocess,
            import_checkpoint, train_g2p) and the vocoder package imported where yaml, matplotlib,
            tensorboard, msgpack and JAX cannot be
  preprocess cli  the preprocessing CLI from a raw corpus to training: the
            first 240 utterances (8 speakers, seed 0) of
            ``benchmarks/corpus.py``'s scaled corpus with ground-truth
            TextGrids under the git-ignored ``build/preprocess_smoke/``;
            ``cli.preprocess`` on a copy of ``configs/scaled/preprocess.yaml``
            on the card (the mel on the card, F0 by the host's native DIO +
            StoneMask, built with g++), its launch counts set to 0 just
            before and read just after (0 for every kernel), its time split
            into F0, mel, reads and writes; the same corpus with ``--device
            cpu --workers 4`` in a subprocess: lists, splits and speakers
            equal, pitch exact, mel within 1e-3, energy and its statistics
            within 1e-5 relative; ``cli.train`` for 2 steps on the card's
            store from a copy of the cli phase's flagship checkpoint
            (finite losses, a checkpoint written, one upsampling launch a
            step); the cli imports check covers ``cli.preprocess``
  import checkpoint  the cli phase's checkpoint of the 8-speaker flagship
            written as a reference ``20184.pth.tar`` (``{"model": ...,
            "optimizer": ...}`` with the ``position_enc`` tables, bins and
            ``num_batches_tracked`` only a reference state dict holds) under
            the git-ignored ``build/import_smoke/``; ``cli.import_checkpoint``
            on the card (no launch; the imported model bit-equal to the
            saved one, ``data.json``); ``cli.synthesize --restore_step``
            from it on sentence (a) and passage (b) (cap 4096: 4 flash and
            2 upsampling launches), durations exact, postnet mel within
            1e-3 and waveform within 1e-3 of the cli phase's runs
  import resume  on the preprocess phase's card store with
            ``intended``/``first`` extraction: ``cli.evaluate`` of the
            imported and of the saved checkpoint (equal val losses, 4
            alignment and 1 upsampling launch a batch), 2 resumed
            ``cli.train`` steps from the imported one (updates 20185 and
            20186 at their Noam rates, finite losses, 8 alignment and 2
            upsampling launches, step 20186 saved); the file with a key
            removed through ``python -m ...cli.import_checkpoint`` exits
            non-zero naming it and writes nothing
  train g2p ``cli.train_g2p --epochs 2`` on the committed seed lexicon on
            the card and with ``--device cpu``: epoch 0's loss within 1e-4
            relative (epoch 1's and the weights' distance reported: the
            training amplifies rounding past its first epoch), seconds per
            epoch, the card's held-out PER through the numpy ``G2PModel``;
            on a 150-word slice (batch 16) both losses within 1e-4
            relative and the weights within 1e-4; the cli imports check
            covers ``cli.import_checkpoint`` and ``cli.train_g2p``
  train     the training slice's main path: ``make_train_step`` on the
            committed flagship with ``intended``/``first`` duration
            extraction (the alignment kernel's path) at the flagship training
            shape (B 48, L 128, T 896), 5 steps with seeded dropout, with the
            launch counts set to 0 just before and read just after; then one
            step of the default ``soft``/``mean`` configuration
  train_reference  one step on the card against the same step through the
            port's plain versions on the CPU, seeded weights and batch
  trainer cli  the training CLIs (``cli.train``, ``cli.evaluate``) on the
            flagship with ``intended``/``first`` extraction at the flagship
            training shape (B 48, text bucket 128, mel bucket 896): a corpus
            under the git-ignored ``build/trainer_smoke/`` (96 train and 40
            val utterances of seeded phone strings, the port's stage-A
            output as targets), a step-0 checkpoint of the committed
            flagship; 6 steps over 3 epochs (log every 2, validation every
            3, a checkpoint every 3, samples with HiFi-GAN audio at 6, the
            profiler over steps 4-5), a resume to step 8, then
            ``cli.evaluate`` of step 8, each with the launch counts set to 0
            just before and read just after (4 alignment and 1 upsampling
            launch a forward); checkpoints 0, 3, 6, 8, the data positions,
            log.txt, every event record's CRCs and the count of its
            ``Loss/*``, ``Perf/*``, image and audio values, the
            profiler's trace (``profile_trainer.py`` times the loop's parts)
  trainer reference  ``cli.evaluate --device cpu`` of the same checkpoint:
            the 7 val loss terms within rtol 1e-4 of the card's, the CPU
            taking the card's alignment argmax; every kernel pick that the
            plain version does not share on the launch's inputs a float64
            near-tie
  fastspeech serving / train  FastSpeech's widths (384 hidden, 2 heads:
            head dim 192, filter 1536, 6 + 6 layers) with seeded weights:
            stage A of bench.py's inputs at cap 4096 (6 flash launches at
            D 192, each held to ``attention_bf16_tolerance`` of its own
            inputs; durations equal to cap 1000), then 3 train steps at the
            flagship training shape (6 alignment launches a step at D 192,
            each held as the alignment kernel phase holds it), each with
            the launch counts set to 0 just before and read just after
  vocoder train  the vocoder slice's main path: ``make_vocoder_train_step``
            on the committed HiFi-GAN V1 and a seeded full-width
            discriminator, B 16 × 8192-sample segments of the e2e phase's
            waveforms, 5 GAN steps with the launch counts set to 0 just
            before and read just after (``fused_log_mel`` 2 per step)
  vocoder train reference  one GAN step of a narrow configuration on the
            card against the same step on the CPU, from the same state
  train_vocoder cli  ``cli.train_vocoder`` warm-started from the cli
            phase's HiFi-GAN V1 checkpoint on the e2e waveforms (22,050 Hz
            wavs under ``build/train_vocoder_smoke/``): 4 GAN steps of B 16
            × 8192 samples, 8 log-mel launches; its checkpoints, config and
            meta; ``load_vocoder`` of step 4 vocodes the e2e mel, and the
            synthesize CLI runs with it as ``--vocoder_ckpt``

  streaming the streaming vocoder (``vocoder.StreamingVocoder``, chunk 64,
            halo 14) on the committed HiFi-GAN V1 over item 0 of the e2e
            mel: the chunks against the full forward within 1e-4 (both
            also against a float64 run), the online mode fed in pieces of
            37 frames, its buffer's high water, time to first audio (CUDA
            events and a synchronise) and a window's device time; then
            ``cli.synthesize --stream_chunk 64`` on the cli phase's
            sentence (a), its waveform within 1e-4 of run (a)'s
  bf16 serving  the committed flagship and V1 under
            ``compute_dtype="bfloat16"`` on bench.py's inputs: stage A at
            cap 1000 and at cap 4096 (4 flash launches on bf16 operands,
            each held to ``attention_bf16_reference`` of its own inputs),
            launches counted; durations within one frame of the f32 run
            and of the CPU's bf16 run; the bf16 vocoder on the f32 mel
            within 0.08 mean relative error; the postnet mel's distance
            reported; stage A and B times in turns with the f32 ones
  hifigan v3  a seeded HiFi-GAN V3 generator (ResBlock2, upstream V3
            widths) on item 0 of the e2e mel, the card against the CPU
            within 1e-4
  export    ``cli.export`` of the cli phase's checkpoint and HiFi-GAN V1
            with text buckets 64 and 384 and frame capacities 1000 and 4096
            (12 ``torch.export`` programs under the git-ignored
            ``build/export_smoke/``; the programs under 5 % of
            ``params.npz``); ``serving.ExportedTTS`` on the card serves
            sentence (a) and passage (b) (cap 4096) with ``synthesize`` and
            ``stream``, the launch counts set to 0 just before and read just
            after each served call and held to the registered operators'
            calls in the programs it ran; durations exact and postnet mel
            within 1e-3 of the live model at the same capacity; ``stream``
            within 1e-4 of ``synthesize``
  vocos serving / melgan serving  ``Synthesizer.from_committed(family=
            ...)``: the committed flagship with the committed Vocos
            (``vocos_params.npz``) or MelGAN (``melgan_params.npz``) on
            bench.py's inputs (cap 1000), launch counts as in e2e
            (upsampling 1); stage A / B and RTF; item 0's waveform on the
            card within 1e-4 of the port's CPU run on the same mel; for
            Vocos a bf16 stage B on the f32 mel below 0.1 mean relative
            error, timed in turns with f32
  vocoder families streaming  ``StreamingVocoder`` (chunk 64) on both
            over item 0: chunks within 1e-4 of the full forward, time to
            first audio by CUDA events
  train_vocoder cli vocos / melgan  ``cli.train_vocoder --generator
            <family>`` at full width from the seed, 4 GAN steps of B 16 ×
            8192 samples (8 log-mel launches, no other kernel); its files;
            ``load_vocoder`` of step 4 vocodes item 0; ``cli.synthesize
            --vocoder_ckpt`` on it writes a wav
  export vocos  ``export_serving_artifacts`` of the cli phase's
            checkpoint with the committed Vocos (text bucket 64, cap 1000,
            under the git-ignored ``build/export_vocos_smoke/``, deleted
            after); ``ExportedTTS.synthesize`` of sentence (a) within 1e-3
            of the live ``Synthesizer`` with Vocos, its launches held to
            the programs' operator calls; ``stream`` within 1e-4 of it
  multi_device  the multi-device axes (``parallel/``) on WORLD ranks, one
            per card over NCCL (WORLD the largest power of two up to
            min(4, cards): 1 on a one-card machine, a one-rank
            communicator), spawned by ``torch.multiprocessing``; each rank
            holds its launch counts and rank 0 each path against the single
            card: the DP step (the committed flagship, intended/first, on
            the train phase's batch B 48 × T 896, mesh (WORLD,), 3 steps:
            losses and the step-1 gradient norm within 1e-4, parameters
            after step 1 within 2·lr(1), the same on every rank); the SP
            step (the decoder's self-attention ringed over the world, B 8,
            T 2048, where the dense step takes the f32 einsum: losses 1e-4,
            gradients at JAX's bar, the same on every rank), with WORLD ≥ 4
            the hybrid (2, WORLD/2) step, then one SP step at T 8192 beside
            the dense single-card one (flash), ms and peak memory reported;
            the committed HiFi-GAN V1 channel-sharded over mesh (1, WORLD)
            (and (2, WORLD/2)) on the serving batch's mel within 2e-4, stage
            B ms; the DP GAN step (B 16 × 8192, 2 steps, metrics within
            1e-3); prints the world and the cards on lines of their own
  multi_device cli  the training CLIs under ``torch.distributed.run
            --standalone --nproc_per_node WORLD`` (this script's
            ``--rank-cli`` mode, one rank a card) on the trainer phase's
            corpus, from a copy of its step-0 checkpoint under the
            git-ignored ``build/multi_device_smoke/``: ``cli.train
            --distributed`` to step 2, resumed to step 3 (one validation),
            only rank 0 writing checkpoints, logs and event files;
            ``cli.evaluate`` of step 3 within 1e-4 of the same CLI in one
            process; ``cli.train_vocoder`` for 2 GAN steps; each rank's
            launches held
  kernel hifigan_resblock  the resblock conv kernel against float64 and
            cuDNN float32 at V1's and V3's convs (each epilogue, every
            tile; at most 1e-5 of the largest output and 2x cuDNN's error
            above 1e-6), the tile it chooses for each of V1's 72 convs
            (every tile chosen by some shape of the benchmark's HiFi-GAN
            cells); at the batch (B 16 x 1000 frames) and online (B 2 x 500)
            shapes each timed conv held to the same limits, timed beside its
            plain version and cuDNN's convolution; the whole V1 generator
            there: 72 launches, within 2x the module chain's error against
            float64.  ``chip_smoke.py --resblock`` runs this phase alone

Every phase that runs a kernel holds each wrapper's launch count to what its
path should launch (the PER_* tables; the resblock kernel's 72 a V1 and 18
a V3 forward without a gradient in float32 on the card, 0 for bf16, the
GAN generator update, the sharded generator and the acoustic runs).

The last three lines are the kernel table as one JSON object, the card's
name and power limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the rest
of the repository, it exits non-zero before printing any result.
"""

import collections
import copy
import io
import itertools
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
# HiFi-GAN's resblock convs on the kernel (csrc/hifigan_resblock.cu) a
# float32 generator forward without a gradient: V1's 4 stages x 3 resblocks
# x 3 dilations x 2 convs, V3's 3 stages x 3 x 2 dilations x 1
RB_V1_LAUNCHES, RB_V3_LAUNCHES = 72, 18
# launches of each kernel per training step: one per MelEncoder layer, one
# upsampling; the self-attentions (T 896, L 128) take the einsum branch; no
# vocoder
PER_TRAIN_STEP = {"flash_attention": 0, "alignment_attention": 4,
                  "gaussian_upsample_banded": 1, "fused_log_mel": 0,
                  "hifigan_resblock_conv": 0}
# per serving batch: at cap 1000 no self-attention passes 2048 frames, and
# HiFi-GAN V1 vocodes the batch once; stage A alone at cap 4096: the 4
# decoder layers on the flash kernel
PER_SERVING_BATCH = {"flash_attention": 0, "alignment_attention": 0,
                     "gaussian_upsample_banded": 1, "fused_log_mel": 0,
                     "hifigan_resblock_conv": RB_V1_LAUNCHES}
PER_SERVING_BATCH_LONG = dict(PER_SERVING_BATCH, flash_attention=4,
                              hifigan_resblock_conv=0)
# FastSpeech's published widths (Ren et al. 2019, "FastSpeech: Fast, Robust
# and Controllable Text to Speech", "Model Configuration"): 384 hidden, 2
# heads (head dim 192), conv filter 1536, 6 + 6 FFT blocks; the conv kernel
# sizes stay the repo's (9, 1).  No such weights are committed: seeded, with
# the duration head's bias raised by log FS_FRAMES (the committed flagship
# predicts 8-11 frames a phoneme on bench.py's inputs)
FS_WIDTHS = dict(encoder_layer=6, encoder_head=2, encoder_hidden=384,
                 decoder_layer=6, decoder_head=2, decoder_hidden=384,
                 conv_filter_size=1536)
FS_SEED, FS_FRAMES, FS_TRAIN_STEPS = 0, 10.0, 3
# its six decoder self-attentions at cap 4096 (stage A alone), its six
# MelEncoder layers
PER_SERVING_BATCH_FS = dict(PER_SERVING_BATCH_LONG, flash_attention=6)
PER_TRAIN_STEP_FS = dict(PER_TRAIN_STEP, alignment_attention=6)
# the vocoder GAN step (smart_nar_fast_tts_tpu/cli/train_vocoder.py:30-31
# defaults): B 16 segments of 8192 samples; 2 log-mel launches per step;
# the discriminator update's generator forward runs without a gradient (the
# resblock kernel), the generator update's with one (the module chain)
VOC_B, VOC_SEG, VOC_STEPS = 16, 8192, 5
PER_GAN_STEP = {"flash_attention": 0, "alignment_attention": 0,
                "gaussian_upsample_banded": 0, "fused_log_mel": 2,
                "hifigan_resblock_conv": RB_V1_LAUNCHES}

BF16_TOL = 2e-2     # the flash kernel rounds q·scale, k, v and p to bf16;
                    # against attention_bf16_reference, which rounds at the
                    # same points, it is held per element to
                    # kernels.attention_bf16_tolerance (1e-3 + 2^-8·Σp|v|/l,
                    # + 2^-7·|ref| for a bf16 output) and, where each item's
                    # valid keys sit in one key tile (the online softmax
                    # is then the two-pass one), on average to ONE_TILE_MEAN:
                    # a moved rounding point costs ≥ 1.6e-4 there
ONE_TILE_MEAN = 1e-5


# n_fft of the log-mel kernels past the first FFT kernel's (powers of two
# from 32 to 4096), checked on tones with a pause: the mixed-radix kernel at
# powers of two outside that range, the 7-smooth sizes of users'
# configurations (400 to 2400), generic radices (1001 = 7·11·13), a prime
# half (1202, M = 601), a prime (1201) and its largest odd and even n_fft;
# the DFT kernel at the odd n_fft past those, its smallest and largest
MIXED_N_FFTS = (16, 8192, 400, 800, 882, 1000, 1200, 1920, 2400, 1001, 1202,
                1201, 7263, 14526)
DFT_N_FFTS = (7265, 14527)
# (n_fft, hop) timed at the GAN step's (16, 8192) beside the plain version:
# the first is the kernels line's entry; the DFT kernel's body is also timed
# at DFT_BODY_TIMED (the route took n_fft 1200 before the mixed-radix kernel)
MIXED_TIMED = ((1200, 256), (400, 160), (882, 256), (1001, 256),
               (1201, 256), (1202, 256), (8192, 2048))
DFT_BODY_TIMED = (1200, 1201, 1202)

# head dims past 128 that the first tensor-core kernels take, timed:
# FastSpeech's 192 (384 hidden, 2 heads) and the widest, 256; the wide
# kernels' (past 256), checked and timed at WIDE_HEAD_DS
WIDE_DS = (192, 256)
WIDE_HEAD_DS = (320, 384, 512)


def flash_tile(d):
    """The flash kernel's key tile at head dim d (csrc/flash_attention.cu
    Tiling<D>::BN of the padded width): 128 keys up to 128, 64 past it."""
    return 128 if d <= 128 else 64

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
ARGMAX_EXACT_MAX_D = 128   # the alignment kernel's head-0 argmax equals
                    # the f32 plain version's up to this head dim; past it
                    # (the 3xTF32 kernel at DP 192/256) a differing index
                    # passes only at a float64 near-tie (argmax_ties)
TF32X3_PRODUCT_EPS = 3 * 2.0 ** -22   # a 3xTF32 product q_i k_i is off by
                    # at most this share of |q_i k_i|: the dropped lo·lo
                    # term and the rounding of each lo part (2^-22 each)
F32_U = 2.0 ** -24  # f32 unit roundoff: a D-term sum in any order is off by
                    # at most D·u of the sum of its terms' magnitudes
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


def flash_valid(torch, np, rng, b, Lx, kind, tile=128):
    """key_valid (b, Lx) on the card, item 0 fully masked: ``prefix`` keys
    below lengths in [Lx/2, Lx]; ``holes`` each key valid with probability
    0.3 (no prefix); ``last tile`` valid keys only in the last 128 keys
    (the last 64 where ``tile`` is 64), a ragged tile when Lx is not a
    multiple of it."""
    if kind == "prefix":
        lens = rng.integers(Lx // 2, Lx + 1, size=b)
        lens[0] = 0
        valid = np.arange(Lx)[None, :] < lens[:, None]
    elif kind == "holes":
        valid = rng.random((b, Lx)) < 0.3
        valid[0] = False
    else:
        valid = np.zeros((b, Lx), bool)
        last = (Lx - 1) // tile * tile
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
    tile = flash_tile(q.shape[-1])
    first = torch.where(valid, keys, valid.shape[1]).amin(1) // tile
    last = torch.where(valid, keys, -1).amax(1) // tile
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
    """ptxas registers, static shared memory and spills of the first
    kernel of csrc/flash_attention.cu and its bf16 conversion (when this
    run compiled them; the wide kernel's: :func:`wide_ptxas`), and the
    attention kernel's dynamic shared memory."""
    import re
    out = {"dynamic_smem_bytes": {
        f"D {d}, Lk {T_CAP_LONG}": lib.flash_attention_smem_bytes(
            d, T_CAP_LONG) for d in (64, 128, 192, 256)}}
    if "flash_attention" not in compiled:
        out["kernels"] = "not compiled in this run: the build directory had it"
        return out
    for name, info in compiled["flash_attention"]["kernels"].items():
        label = re.search(r"(flash_attention|kv_to_bf16)_kernel", name)
        if label is None:               # the wide kernel's: wide_ptxas
            continue
        label = label.group(0)
        d = re.search(r"ILi(\d+)E(?:Li(\d+)ELi(\d+)E)?", name)
        if d:
            label += f"<D {d.group(1)}"
            if label.startswith("flash_attention_kernel"):
                label += f", BN {d.group(2)}, {d.group(3)} stages"
                label += ", bf16" if "nv_bfloat16" in name else ", f32"
            label += ">"
        out[label] = info
    return out


def flash_timing(torch, kernels, q, k, v, valid, reps=25):
    """The flash wrapper on f32 q, k, v and on their bf16 roundings, beside
    its plain version and SDPA on both; the bound counts the products over
    the valid keys (QKᵀ and PV) at the bf16 tensor-core rate, and q, k, v,
    the mask and out moved once."""
    import torch.nn.functional as F
    mask = valid[:, None, None, :]
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    ms = device_ms(lambda: kernels.flash_attention(q, k, v, valid), torch,
                   reps=reps)
    bf16_ms = device_ms(lambda: kernels.flash_attention(qb, kb, vb, valid),
                        torch, reps=reps)
    plain_ms = device_ms(lambda: kernels.attention_reference(
        q, k, v, valid), torch, reps=reps)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), torch)
    library_bf16_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask), torch)
    _, H, Lq, D = q.shape
    nbytes = 4 * (q.numel() * 2 + k.numel() + v.numel()) + valid.numel()
    flops = 4 * H * Lq * D * int(valid.sum())
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms, tflops=flops / ms / 1e9,
                bf16_ms=bf16_ms, library_bf16_ms=library_bf16_ms,
                vs_library_bf16=ms / library_bf16_ms)


def kernel_flash_attention(torch, np, kernels, compiled):
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
                timing = flash_timing(torch, kernels, q, k, v, valid)
                f.update(timing)
                crossover.append(dict(T=Lx, **timing))
                if Lx == T_CAP_LONG:
                    # what a launch costs beside its products: one valid
                    # key tile per item (q load, output store, set-up)
                    one = torch.zeros_like(valid)
                    one[:, :flash_tile(128)] = True
                    timing["one_tile_ms"] = device_ms(
                        lambda: kernels.flash_attention(q, k, v, one), torch)
                    f.update(one_tile_ms=timing["one_tile_ms"])
                    entry.update(timing, shape=list(q.shape))
    # the head dims past 128 on the tensor cores (WIDE_DS: FastSpeech's 192
    # and 256; 64-key tiles): the serving decoder at T_CAP_LONG, timed, and
    # at D 192 a mask with holes and one whose valid keys sit in the last
    # (ragged) 64-key tile; f32 and bf16 operands; the wide kernel must
    # not run
    wide = [(d, T_CAP_LONG, "prefix") for d in WIDE_DS] + [
        (WIDE_DS[0], T_CAP_LONG, "holes"), (WIDE_DS[0], 4000, "last tile")]
    for d, Lx, kind in wide:
        valid = flash_valid(torch, np, rng, B, Lx, kind, flash_tile(d))
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, 2, Lx, d)).astype(np.float32)).cuda() for _ in range(3))
        with Phase("kernel flash_attention") as f:
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                args = (*(t.to(dtype) for t in (q, k, v)), valid)
                out, wide = routed(
                    kernels, "flash_attention_wide",
                    lambda: kernels.flash_attention(*args))
                again = kernels.flash_attention(*args)
                torch.cuda.synchronize()
                if wide or not torch.equal(out, again):
                    raise AssertionError(f"flash_attention D {d}: wide "
                                         f"kernel {wide}, or two "
                                         "launches differ")
                err, err_emu, share, mean = flash_errors(
                    torch, kernels, f"D {d} {kind}", out, *args)
                err_max, emu_max = max(err_max, err), max(emu_max, err_emu)
                share_max = max(share_max, share)
                errs[str(dtype)] = dict(
                    max_abs_err=err, max_abs_err_vs_bf16_plain=err_emu,
                    bf16_tolerance_share=share,
                    mean_abs_err_vs_bf16_plain=mean)
            f.update(case=f"decoder {Lx} D {d} {kind}", shape=list(q.shape),
                     mask=kind, valid_keys=int(valid.sum()),
                     route="tensor cores", bit_equal=True, errors=errs)
            if kind == "prefix":
                timing = flash_timing(torch, kernels, q, k, v, valid)
                f.update(timing)
                entry[f"d{d}"] = dict(timing, shape=list(q.shape),
                                      errors=errs)
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
    """ptxas registers, static shared memory and spills of the first
    kernel of csrc/alignment_attention.cu and its sum (when this run
    compiled them; the wide kernels': :func:`wide_ptxas`), and the dynamic
    shared memory of each instantiation."""
    import re
    out = {"dynamic_smem_bytes": {f"D {d}": lib.alignment_attention_smem_bytes(
        d) for d in (32, 64, 128, 192, 256)}}
    if "alignment_attention" not in compiled:
        out["kernels"] = "not compiled in this run: the build directory had it"
        return out
    for name, info in compiled["alignment_attention"]["kernels"].items():
        label = re.search(r"(alignment|gnum_reduce)_kernel", name)
        if label is None:               # the wide kernels': wide_ptxas
            continue
        label = label.group(0)
        d = re.search(r"ILi(\d+)E", name)
        out[label + (f"<D {d.group(1)}>" if d else "")] = info
    return out


def argmax_ties(torch, args, idx, r_idx):
    """The frames where the kernel's head-0 argmax ``idx`` differs from the
    f32 plain version's ``r_idx``: the float64 argmax (first index among
    equal maxima), and for each pick how far its float64 score lies below
    the maximum beside its version's error bound.  At head dim D a score
    scale·Σ q_i k_i is off by at most eps·scale·Σ|q_i k_i|, eps = D·F32_U
    for the f32 sum and TF32X3_PRODUCT_EPS more for the kernel's 3xTF32
    products; so a version may rank a key over the maximum where their gap
    is below the sum of the two keys' bounds.  A difference is a near-tie
    when both picks lie within that of the maximum."""
    q, k, _, valid = args[:4]
    d = q.shape[-1]
    scale = 1 / math.sqrt(d)
    eps = {"kernel": TF32X3_PRODUCT_EPS + d * F32_U, "plain": d * F32_U}
    out = []
    for b, t in (idx != r_idx).nonzero().tolist():
        qt, kb = q[b, 0, t].double(), k[b, 0].double()
        s64 = torch.where(valid[b], (kb @ qt) * scale, -1e30)
        mag = (kb.abs() @ qt.abs()) * scale
        top = s64.max()
        first = int(torch.nonzero(s64 == top)[0, 0])
        tie = dict(frame=(b, t), float64_argmax=first,
                   float64_max=top.item(),
                   float64_top2_gap=(top - s64[s64 < top].max()).item(),
                   near_tie=True)
        for who, pick in (("kernel", int(idx[b, t])),
                          ("plain", int(r_idx[b, t]))):
            below = (top - s64[pick]).item()
            limit = eps[who] * (mag[pick] + mag[first]).item()
            tie.update({who: pick, f"{who}_below_max": below,
                        f"{who}_bound": limit})
            tie["near_tie"] &= below <= limit
        out.append(tie)
    return out


def alignment_check(torch, kernels, name, args, got=None):
    """The kernel against the f32 plain version (out F32_TOL; idx exact up
    to head dim ARGMAX_EXACT_MAX_D, past it exact but at float64 near-ties:
    :func:`argmax_ties`; gnum GNUM_ATOL/GNUM_RTOL), twice (out, idx and
    gnum bit-equal) and against alignment_tf32x3_reference (out
    TF32X3_ATOL at most and TF32X3_MEAN on average, gnum as above); returns
    the figures.  ``got``: a launch's outputs recorded on a path, which take
    the first launch's place."""
    out, idx, gnum = got or kernels.alignment_attention(*args)
    out2, idx2, gnum2 = kernels.alignment_attention(*args)
    torch.cuda.synchronize()
    r_out, r_idx, r_gnum = kernels.alignment_reference(*args)
    err = check_close(f"alignment_attention {name} out", out, r_out,
                      F32_TOL, torch)
    ties = argmax_ties(torch, args, idx, r_idx)
    if ties and (args[0].shape[-1] <= ARGMAX_EXACT_MAX_D
                 or not all(t["near_tie"] for t in ties)):
        raise AssertionError(f"alignment_attention {name}: {len(ties)} "
                             f"argmax indices differ: {ties[:4]}")
    gnum_err = check_close(f"alignment_attention {name} gnum", gnum, r_gnum,
                           GNUM_ATOL, torch, rtol=GNUM_RTOL)
    if not (torch.equal(out, out2) and torch.equal(gnum, gnum2)
            and torch.equal(idx, idx2)):
        raise AssertionError(f"alignment_attention {name}: two launches "
                             "differ")
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
                idx_differ=len(ties), idx_near_ties=ties,
                idx_differ_vs_tf32x3_plain=n_t_idx,
                gnum_bit_equal_across_launches=True)


def alignment_timing(torch, kernels, args, reps=25):
    """The alignment wrapper beside its plain version and f32 SDPA on
    ``out`` alone.  Its bound counts QKᵀ and PV over the valid keys, every
    frame, as three TF32 passes each at the tensor cores' TF32 rate (the
    kernel's 3xTF32), with the bound at the f32 CUDA-core rate (one pass)
    beside it; q, k, v, the mask, the lengths and the outputs move once."""
    import torch.nn.functional as F
    q, k, v, valid = args[:4]
    ms = device_ms(lambda: kernels.alignment_attention(*args), torch,
                   reps=reps)
    plain_ms = device_ms(lambda: kernels.alignment_reference(*args), torch,
                         reps=reps)
    sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=valid[:, None, None, :]), torch)
    b_, h_, t_, d_ = q.shape
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel() + b_ * t_ + b_
                  + 2 * args[4].numel()) + valid.numel()
    flops = 4 * h_ * t_ * d_ * int(valid.sum())
    bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOPS)
    f32_bound_ms, f32_bound_by = bound(nbytes, flops, F32_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                sdpa_f32_out_only_ms=sdpa_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_share=bound_ms / ms,
                f32_bound_ms=f32_bound_ms, f32_bound_by=f32_bound_by,
                f32_bound_share=f32_bound_ms / ms,
                tflops_3xtf32=3 * flops / ms / 1e9, flops=flops,
                bytes=nbytes)


def kernel_alignment_attention(torch, np, kernels, compiled):
    from smart_nar_fast_tts_tpu_torch.kernels import _build
    from smart_nar_fast_tts_tpu_torch.kernels.alignment import _SIGNATURES
    rng = np.random.default_rng(3)
    entry, err_max = {}, 0.0
    # the flagship training shape, a ragged one (T not a multiple of 16,
    # L 13) and L 1000 (max_seq_len; 16 key chunks); then each product
    # apart: q = 0 (uniform p: PV alone) and v = identity (out = P: QKᵀ
    # through the softmax alone); then the head dims past 128 on the
    # tensor cores (WIDE_DS: FastSpeech's 192 and 256) at the training
    # shape and each product apart, the wide kernel not launched
    cases = [("train", 128), ("ragged", 128), ("L 1000", 128),
             ("q zero", 128), ("v identity", 128)]
    cases += [(name, d) for d in WIDE_DS
              for name in ("train", "q zero", "v identity")]
    for name, d in cases:
        shape = {"train": (TRAIN_B, 2, TRAIN_T, TRAIN_L, d),
                 "ragged": (3, 2, 45, 13, d), "L 1000": (2, 2, 1500, 1000, d),
                 "q zero": (4, 2, 300, d, d),
                 "v identity": (4, 2, 300, d, d)}[name]
        with Phase("kernel alignment_attention") as f:
            args = alignment_inputs(torch, np, rng, *shape)
            if name == "q zero":
                args = (torch.zeros_like(args[0]), *args[1:])
            elif name == "v identity":
                eye = torch.eye(d, device="cuda").expand(4, 2, d, d)
                args = (*args[:2], eye.contiguous(), *args[3:])
            checks, wide = routed(kernels, "alignment_attention_wide",
                                  lambda: alignment_check(
                                      torch, kernels, f"{name} D {d}",
                                      args))
            if wide:
                raise AssertionError(f"alignment_attention D {d}: the "
                                     "wide kernel ran")
            err_max = max(err_max, checks["max_abs_err"])
            f.update(case=name, shape=list(shape), **checks,
                     src_lens=args[4].tolist()[:4])
            if name != "train":
                continue
            timing = dict(alignment_timing(torch, kernels, args),
                          shape=list(shape), max_abs_err=checks[
                              "max_abs_err"])
            f.update(timing)
            if d == 128:
                entry.update(timing)
            else:
                entry[f"d{d}"] = timing
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
    return counts, step_ms


def fastspeech_model(torch):
    """FastSpeech's widths (FS_WIDTHS) in the port's ``FastSpeech2Align``
    with ``intended``/``first`` duration extraction and the committed
    flagship's feature stats, weights from the port's initialisers after
    ``torch.manual_seed(FS_SEED)``; the duration head's bias raised by
    log FS_FRAMES, so that the seeded model predicts speech-like lengths."""
    from smart_nar_fast_tts_tpu_torch.config import (FeatureStats,
                                                     ModelConfig,
                                                     PreprocessConfig,
                                                     TransformerConfig)
    from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
    with open(os.path.join(REPO, "benchmarks", "results",
                           "flagship_meta.json")) as f:
        stats = json.load(f)["stats"]
    cfg = ModelConfig(transformer=TransformerConfig(**FS_WIDTHS),
                      duration_extraction="intended",
                      duration_head_reduce="first")
    torch.manual_seed(FS_SEED)
    model = FastSpeech2Align(cfg, PreprocessConfig(
        stats=FeatureStats(**stats)))
    with torch.no_grad():
        model.variance_adaptor.duration_predictor.linear_layer.bias += \
            math.log(FS_FRAMES)
    return model


def fastspeech_phase(torch, np, kernels, synth, inv, texts, src_lens):
    """The FastSpeech-width path, whose attention has head dim 192: (a)
    stage A of bench.py's inputs at cap 4096 through ``Synthesizer(...,
    t_cap=4096)``, with the launch counts set to 0 just before and read
    just after: the decoder's six self-attentions run the tensor-core flash
    kernel at (8, 2, 4096, 192), the wide kernel none; each launch's
    output held to ``attention_bf16_tolerance`` of its own inputs;
    durations equal to a cap-1000 card run of the same model; finite
    outputs.  (b) FS_TRAIN_STEPS train steps (``intended``/``first``) at the
    flagship training shape on the flagship phase's batch, with the counts
    set to 0 just before and read just after: the six MelEncoder layers run
    the alignment kernel at D 192 each step, each launch's out, idx and gnum
    held as :func:`alignment_check` holds them (its outputs recorded on the
    path, then a second launch bit-equal); finite losses; step time, peak
    memory, and one step's alignment launches timed on their recorded
    inputs.  Returns the two runs' counts."""
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Loss, layers
    from smart_nar_fast_tts_tpu_torch.serving import Synthesizer
    from smart_nar_fast_tts_tpu_torch.training import (create_train_state,
                                                       make_train_step)
    with Phase("fastspeech serving") as f:
        t0 = time.perf_counter()
        model = fastspeech_model(torch)
        f["build_seconds"] = time.perf_counter() - t0
        long_synth = Synthesizer(model, synth.vocoder, t_cap=T_CAP_LONG)
        flash, calls = layers.flash_attention, []

        def spy(q, k, v, key_valid):          # the model's call, recorded
            out = flash(q, k, v, key_valid)
            calls.append((q, k, v, key_valid, out))
            return out

        tokens, lens = torch.from_numpy(texts), torch.from_numpy(src_lens)
        kernels.reset_launches()
        with mock.patch.object(layers, "flash_attention", spy):
            out = long_synth.stage_a(tokens, lens)
        torch.cuda.synchronize()
        serving = {**kernels.launches(), **kernels.route_launches()}
        shapes = [list(c[0].shape) for c in calls]
        want = dict(PER_SERVING_BATCH_FS, **{
            n: 0 for n in kernels.route_launches()})
        if serving != want or shapes != [[B, 2, T_CAP_LONG, 192]] * 6:
            raise AssertionError(f"FastSpeech cap-4096 launches {serving} "
                                 f"at {shapes}, expected {want}")
        shares = []
        for q, k, v, valid, o in calls:
            ref = kernels.attention_bf16_reference(q, k, v, valid)
            tol = kernels.attention_bf16_tolerance(q, k, v, valid, ref)
            shares.append(((o - ref).abs() / tol).max().item())
        if not max(shares) <= 1.0:
            raise AssertionError("FastSpeech flash outputs beyond "
                                 f"attention_bf16_tolerance: {shares}")
        if out.postnet_mel.shape != (B, T_CAP_LONG, 80) or not all(
                torch.isfinite(t).all() for t in (
                    out.postnet_mel, out.mel, out.log_duration_prediction,
                    out.pitch_prediction, out.energy_prediction)):
            raise AssertionError("FastSpeech cap-4096 output: bad shape or "
                                 "non-finite")
        short = Synthesizer(model, synth.vocoder, t_cap=T_CAP).stage_a(
            tokens, lens)
        if not torch.equal(out.duration_rounded, short.duration_rounded):
            raise AssertionError("FastSpeech durations at cap 4096 differ "
                                 "from cap 1000")
        if not int(out.mel_lens.min()) > 0:
            raise AssertionError("FastSpeech: an empty utterance")
        stage_a_ms = wall_ms(lambda: long_synth.stage_a(tokens, lens), torch)
        with torch.inference_mode():
            flash_ms = [device_ms(lambda c=c: kernels.flash_attention(*c[:4]),
                                  torch) for c in calls]
        valid_keys = int(calls[0][3].sum())
        flops = 4 * 2 * T_CAP_LONG * 192 * valid_keys
        nbytes = 4 * 4 * calls[0][0].numel() + calls[0][3].numel()
        path_bound_ms, path_bound_by = bound(nbytes, flops, BF16_FLOPS)
        f.update(widths=FS_WIDTHS, frames_per_phoneme_bias=FS_FRAMES,
                 params=sum(p.numel() for p in model.parameters()),
                 launches=serving, flash_shapes=shapes,
                 flash_bf16_tolerance_share=shares,
                 mel_lens=out.mel_lens.tolist(), stage_a_ms=stage_a_ms,
                 stage_a_cap1000_durations_equal=True,
                 flash_valid_keys=valid_keys, flash_ms_on_path=flash_ms,
                 flash_ms_on_path_sum=sum(flash_ms),
                 flash_bound_ms_on_path=path_bound_ms,
                 flash_bound_by_on_path=path_bound_by,
                 nvidia_smi=nvidia_smi())
        del calls, out, short, long_synth

    with Phase("fastspeech train") as f:
        batch = train_batch(torch, np, synth, inv)
        state = create_train_state(model)
        step = make_train_step(FastSpeech2Loss(), keep_outputs=True)
        generator = torch.Generator(device="cuda").manual_seed(0)
        align, records = layers.alignment_attention, []

        def align_spy(*args):                 # the model's call, recorded
            got = align(*args)
            records.append((tuple(a.detach() if torch.is_tensor(a) else a
                                  for a in args),
                            tuple(t.detach() for t in got)))
            return got

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, totals = [], []
        kernels.reset_launches()
        with mock.patch.object(layers, "alignment_attention", align_spy):
            for i in range(FS_TRAIN_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                losses, outs = step(state, batch, generator)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
                check_finite_losses(torch, losses,
                                    f"FastSpeech train step {i + 1}")
                totals.append(float(losses.total))
                durations = outs[0].duration_targets
                if not torch.equal(durations.sum(1), batch.mel_lens.to(
                        durations.dtype)):
                    raise AssertionError("FastSpeech duration targets do "
                                         "not sum to mel_lens")
        train = {**kernels.launches(), **kernels.route_launches()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {n: c * FS_TRAIN_STEPS for n, c in PER_TRAIN_STEP_FS.items()}
        want.update({n: 0 for n in kernels.route_launches()})
        if train != want:
            raise AssertionError(f"FastSpeech train launches {train}, "
                                 f"expected {want}")
        worst, ties = {}, []
        for i, (args, got) in enumerate(records):
            if list(args[0].shape) != [TRAIN_B, 2, TRAIN_T, 192]:
                raise AssertionError(f"alignment launch {i}: q "
                                     f"{list(args[0].shape)}")
            name = (f"FastSpeech step {i // 6 + 1} layer {i % 6 + 1}")
            checks = alignment_check(torch, kernels, name, args, got=got)
            ties += [dict(t, launch=i) for t in checks.pop("idx_near_ties")]
            for key, value in checks.items():
                if not isinstance(value, bool):
                    worst[key] = max(worst.get(key, 0), value)
        per_step = PER_TRAIN_STEP_FS["alignment_attention"]
        with torch.no_grad():            # one step's launches, each timed
            align_ms = [device_ms(         # on its recorded inputs
                lambda a=a: kernels.alignment_attention(*a), torch)
                for a, _ in records[:per_step]]
        f.update(launches=train, step_ms=times,
                 step_ms_median=statistics.median(times),
                 alignment_ms_on_path=align_ms,
                 alignment_ms_on_path_per_step=sum(align_ms),
                 peak_mem_gib=peak, total_loss_per_step=totals,
                 alignment_launches_held=len(records),
                 alignment_worst=worst, idx_near_ties=ties,
                 alignment_tolerances=dict(
                     out=F32_TOL, gnum_atol=GNUM_ATOL, gnum_rtol=GNUM_RTOL,
                     tf32x3_max=TF32X3_ATOL, tf32x3_mean=TF32X3_MEAN,
                     idx=f"exact but at float64 near-ties past head dim "
                         f"{ARGMAX_EXACT_MAX_D} (argmax_ties)"),
                 frames_per_phoneme_max=int(durations.max()),
                 nvidia_smi=nvidia_smi())
        del state, step, outs, records, model
    return serving, train


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


def log_mel_timing(torch, np, kernels, y, c, mel, energy):
    """The log-mel kernel of ``c``'s route timed on y beside the plain
    version (cuFFT rfft and the mel product), with its bound: the
    function's least work per frame is the window, a real FFT
    (2.5·n·log2 n, the usual count), power, sqrt and the energy sum per
    bin, the filterbank's nonzeros, clip and log per mel; y read and the
    outputs written once."""
    from smart_nar_fast_tts_tpu_torch.audio import mel_spectrogram
    ms = device_ms(lambda: kernels.fused_log_mel(y, c), torch)
    plain_ms = device_ms(lambda: mel_spectrogram(y, c), torch)
    b, n_frames = energy.shape
    n_bins = c.n_fft // 2 + 1
    per_frame = (c.win_length + 2.5 * c.n_fft * math.log2(c.n_fft)
                 + 5 * n_bins + 2 * np.count_nonzero(c.mel_basis)
                 + 2 * c.n_mels + 1)
    flops = b * n_frames * per_frame
    nbytes = 4 * (y.numel() + mel.numel() + energy.numel())
    bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=plain_ms,
                library="the plain version (cuFFT rfft + mel product): no "
                        "one PyTorch call computes log-mel",
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms, flops=flops)


def dft_body(torch, lib, y, c):
    """A launch of the DFT kernel on y at ``c``'s n_fft, whatever its route
    (timed beside the mixed-radix kernel; counted nowhere)."""
    from smart_nar_fast_tts_tpu_torch.kernels.stft import (_tables_on,
                                                           num_frames)
    b, S = y.shape
    F = num_frames(S, c)
    window, twiddles, ranges, weights = _tables_on(c, y.device)
    mel = torch.empty((b, c.n_mels, F), device=y.device)
    energy = torch.empty((b, F), device=y.device)

    def launch():
        status = lib.log_mel_dft_forward(
            y.data_ptr(), window.data_ptr(), twiddles.data_ptr(),
            ranges.data_ptr(), weights.data_ptr(), mel.data_ptr(),
            energy.data_ptr(), b, S, F, c.n_fft, c.hop_length, c.n_mels,
            float(c.compression_clip),
            torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"log_mel_dft_forward: status {status}")
    return launch


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
    the mixed-radix and DFT kernels (:func:`kernel_widths`)."""
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
            timing = log_mel_timing(torch, np, kernels, y, c, mel, energy)
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
    return counts, step_ms


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


def routed(kernels, name, fn):
    """``fn()``, and whether the wrapper launched its second kernel
    (``name`` of :func:`kernels.route_launches`) for it."""
    before = kernels.route_launches()[name]
    out = fn()
    return out, kernels.route_launches()[name] > before


def wide_ptxas(compiled, flash_lib, align_lib):
    """ptxas registers, static shared memory and spills of the wide kernels
    and the bf16 conversion (when this run compiled them), and each wide
    kernel's shape at WIDE_HEAD_DS: the flash kernel's dynamic shared memory
    and ring stages (negative where q streams) at Lk T_CAP_LONG, the
    alignment kernel's route (``team`` or ``wide``), warps, columns of K
    staged at once, slices and dynamic shared memory."""
    import ctypes
    import re
    out = {}
    for d in WIDE_HEAD_DS + (1024,):
        stages = ctypes.c_int(0)
        smem = flash_lib.flash_attention_wide_smem_bytes(
            d, T_CAP_LONG, ctypes.byref(stages))
        shape = (ctypes.c_int * 5)()
        align_lib.alignment_attention_wide_shape(d, shape)
        out[f"D {d}"] = dict(
            flash_dynamic_smem_bytes=smem, flash_stages=stages.value,
            alignment_kernel="team" if shape[0] else "wide",
            alignment_warps=shape[1], alignment_chunk_columns=shape[2],
            alignment_slices=shape[3], alignment_dynamic_smem_bytes=shape[4])
    for stem, pattern in (
            ("flash_attention", r"flash_wide_kernel|(?<!kv_)to_bf16_kernel"),
            ("alignment_attention",
             r"alignment_wide_kernel|alignment_team_kernel")):
        if stem not in compiled:
            out[stem] = "not compiled in this run: the build directory had it"
            continue
        for name, info in compiled[stem]["kernels"].items():
            found = re.search(pattern, name)
            if found:
                arg = re.search(r"_kernelI(f|13__nv_bfloat16)E", name)
                dtype = "" if arg is None else (
                    ", f32" if arg.group(1) == "f" else ", bf16")
                out[found.group(0) + dtype] = info
    return out


def log_mel_widths(torch, np, kernels, compiled, rng):
    """The log-mel kernels past the first FFT kernel's n_fft: the
    mixed-radix kernel at MIXED_N_FFTS and the DFT kernel at DFT_N_FFTS on
    tones with a pause (4, 16384), hop n_fft/4, each launch on its route's
    counter, against the float64 plain version (FFT_MEL_ATOL /
    FFT_ENERGY_RTOL) and its twin (FFT_REF_ATOL), bit-equal across
    launches; then timed at (16, 8192) as :func:`kernel_widths` says.
    Returns the mixed-radix and DFT kernels' entries."""
    from smart_nar_fast_tts_tpu_torch.audio import (MelSpectrogramConfig,
                                                    mel_spectrogram)
    from smart_nar_fast_tts_tpu_torch.kernels import _build
    from smart_nar_fast_tts_tpu_torch.kernels.stft import (
        _SIGNATURES as LOG_MEL_SIGNATURES)
    from smart_nar_fast_tts_tpu_torch.kernels.stft import fft_plan
    log_mel_lib = _build.load("log_mel", LOG_MEL_SIGNATURES)
    tones = tone_with_pause(torch, np, rng, 4, 16384)
    mixed, mixed_err, dft_err = {}, 0.0, 0.0
    for n, route in [(n, "mixed") for n in MIXED_N_FFTS] + [
            (n, "dft") for n in DFT_N_FFTS]:
        with Phase(f"kernel fused_log_mel {route}") as f:
            c = MelSpectrogramConfig(n_fft=n, win_length=n,
                                     hop_length=max(n // 4, 1))
            (mel, energy), launched = routed(
                kernels, f"fused_log_mel_{route}",
                lambda: kernels.fused_log_mel(tones, c))
            mel2, energy2 = kernels.fused_log_mel(tones, c)
            torch.cuda.synchronize()
            if not launched:
                raise AssertionError(f"fused_log_mel n_fft {n}: the {route} "
                                     "kernel did not run")
            twin = (kernels.log_mel_fft_reference if route == "mixed"
                    else kernels.log_mel_dft_reference)
            exact_mel, exact_energy = mel_spectrogram(tones.double(), c)
            twin_mel, twin_energy = twin(tones, c)
            mel_err = (mel.double() - exact_mel).abs().max().item()
            energy_err = ((energy.double() - exact_energy).abs()
                          / exact_energy.clamp(min=1e-30)).max().item()
            if mel_err > FFT_MEL_ATOL or energy_err > FFT_ENERGY_RTOL:
                raise AssertionError(
                    f"fused_log_mel n_fft {n} vs float64: mel {mel_err} "
                    f"(atol {FFT_MEL_ATOL}), energy {energy_err} relative "
                    f"(rtol {FFT_ENERGY_RTOL})")
            twin_err = check_close(f"fused_log_mel n_fft {n} vs "
                                   f"{twin.__name__}", mel, twin_mel,
                                   FFT_REF_ATOL, torch)
            check_close(f"fused_log_mel n_fft {n} energy vs "
                        f"{twin.__name__}", energy, twin_energy, 0.0,
                        torch, rtol=FFT_ENERGY_RTOL)
            if not (torch.equal(mel, mel2) and torch.equal(energy, energy2)):
                raise AssertionError(f"fused_log_mel n_fft {n}: two "
                                     "launches differ")
            if route == "mixed":
                mixed_err = max(mixed_err, mel_err)
            else:
                dft_err = max(dft_err, mel_err)
            f.update(n_fft=n, shape=list(tones.shape), route=route,
                     plan=fft_plan(n if n % 2 else n // 2)
                     if route == "mixed" else None,
                     mel_vs_float64=mel_err, energy_rel_vs_float64=energy_err,
                     mel_vs_twin=twin_err, twin=twin.__name__,
                     bit_equal=True)
    y = torch.from_numpy(rng.uniform(-1, 1, (VOC_B, VOC_SEG)).astype(
        np.float32)).cuda()
    for n, hop in MIXED_TIMED:
        with Phase("kernel fused_log_mel mixed timed") as f:
            c = MelSpectrogramConfig(n_fft=n, win_length=n, hop_length=hop)
            (mel, energy), launched = routed(
                kernels, "fused_log_mel_mixed",
                lambda: kernels.fused_log_mel(y, c))
            if not launched:
                raise AssertionError(f"fused_log_mel n_fft {n}: the mixed "
                                     "kernel did not run")
            timing = log_mel_timing(torch, np, kernels, y, c, mel, energy)
            if n in DFT_BODY_TIMED:
                timing["dft_body_ms"] = device_ms(
                    dft_body(torch, log_mel_lib, y, c), torch)
            timing.update(shape=list(y.shape), n_fft=n, hop_length=hop,
                          plan=fft_plan(n if n % 2 else n // 2),
                          dynamic_smem_bytes=(
                              log_mel_lib.log_mel_mixed_smem_bytes(n)))
            f.update(timing)
            if not mixed:
                mixed.update(timing)
            else:
                mixed.setdefault("sizes", {})[f"n_fft {n}"] = timing
    mixed.update(max_abs_err=mixed_err)
    with Phase("kernel fused_log_mel dft") as f:
        n = DFT_N_FFTS[0]
        c = MelSpectrogramConfig(n_fft=n, win_length=n)
        (mel, energy), launched = routed(
            kernels, "fused_log_mel_dft",
            lambda: kernels.fused_log_mel(y, c))
        if not launched:
            raise AssertionError(f"fused_log_mel n_fft {n}: the DFT kernel "
                                 "did not run")
        dft = dict(log_mel_timing(torch, np, kernels, y, c, mel, energy),
                   shape=list(y.shape), n_fft=n, max_abs_err=dft_err,
                   dynamic_smem_bytes=log_mel_lib.log_mel_dft_smem_bytes(n))
        f.update(dft)
    ptxas = kernel_ptxas(compiled, "log_mel", log_mel_lib, {
        f"mixed n_fft {n}": log_mel_lib.log_mel_mixed_smem_bytes(n)
        for n, _ in MIXED_TIMED})
    mixed.update(ptxas=ptxas)
    dft.update(ptxas=ptxas)
    return mixed, dft


def kernel_widths(torch, np, kernels, compiled):
    """The widths the first kernels do not take as they are (ROADMAP
    §C.2).  Flash attention at head dims 32, 80, 96, 160 and 200
    (zero-padded to the tensor-core kernel's 64, 128, 192 or 256), 192,
    256, and 288 and 320 (the wide kernel, 288 padded to 320), f32 and bf16
    operands, held as the tensor-core kernel is (:func:`flash_errors`);
    alignment attention at D 30, 96 and 150 (zero-padded to a multiple of
    4), 192, 256, 300 and 320 (the wide kernel), held as
    :func:`alignment_check` holds it; the log-mel mixed-radix kernel at
    MIXED_N_FFTS and the DFT kernel at DFT_N_FFTS, on tones with a pause,
    each against the float64 plain version (FFT_MEL_ATOL /
    FFT_ENERGY_RTOL) and its twin, ``log_mel_fft_reference`` or
    ``log_mel_dft_reference`` (FFT_REF_ATOL), bit-equal across launches.
    Then the wide kernels at
    WIDE_HEAD_DS: flash at (8, 2, 4096, D) on prefix masks (at D 320 also
    holes and a last-tile mask), f32 and bf16 operands, bit-equal across
    launches, timed beside its plain version and SDPA on f32 and bf16
    operands; alignment at the training shape with head dim D, timed
    beside its plain version and f32 SDPA on ``out`` alone; the log-mel
    mixed-radix kernel timed at (16, 8192) at MIXED_TIMED beside its plain
    version and, at DFT_BODY_TIMED, the DFT kernel's body; the DFT kernel
    at (16, 8192) with n_fft DFT_N_FFTS[0].  Returns the four further
    kernels' entries."""
    from smart_nar_fast_tts_tpu_torch.kernels import _build
    from smart_nar_fast_tts_tpu_torch.kernels.alignment import (
        _SIGNATURES as ALIGN_SIGNATURES)
    from smart_nar_fast_tts_tpu_torch.kernels.attention import (
        _SIGNATURES as FLASH_SIGNATURES)
    rng = np.random.default_rng(6)
    flash, align = {}, {}
    flash_err = flash_share = align_err = 0.0
    for D in (32, 80, 96, 160, 192, 200, 256, 288, 320):
        valid = flash_valid(torch, np, rng, 4, 700, "prefix")
        base = [torch.from_numpy(rng.standard_normal(
            (4, 2, 700, D)).astype(np.float32)).cuda() for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            with Phase("kernel flash_attention widths") as f:
                q, k, v = (t.to(dtype) for t in base)
                out, wide = routed(
                    kernels, "flash_attention_wide",
                    lambda: kernels.flash_attention(q, k, v, valid))
                torch.cuda.synchronize()
                if wide != (D > 256):
                    raise AssertionError(f"flash_attention D {D}: wide "
                                         f"kernel launched: {wide}")
                err, err_emu, share, mean = flash_errors(
                    torch, kernels, f"D {D}", out, q, k, v, valid)
                if wide:
                    flash_err = max(flash_err, err_emu)
                    flash_share = max(flash_share, share)
                f.update(D=D, dtype=str(dtype), shape=list(q.shape),
                         route=("wide" if wide else "tensor cores") + (
                             ", D zero-padded" if D not in (
                                 64, 128, 192, 256, 320) else ""),
                         max_abs_err=err, max_abs_err_vs_bf16_plain=err_emu,
                         bf16_tolerance_share=share,
                         mean_abs_err_vs_bf16_plain=mean)
    cases = [(d, "prefix") for d in WIDE_HEAD_DS] + [
        (WIDE_HEAD_DS[0], "holes"), (WIDE_HEAD_DS[0], "last tile")]
    for D, kind in cases:
        with Phase("kernel flash_attention wide") as f:
            Lx = T_CAP_LONG if kind != "last tile" else 4000
            valid = flash_valid(torch, np, rng, B, Lx, kind, flash_tile(D))
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (B, 2, Lx, D)).astype(np.float32)).cuda() for _ in range(3))
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                args = (*(t.to(dtype) for t in (q, k, v)), valid)
                out, wide = routed(kernels, "flash_attention_wide",
                                   lambda: kernels.flash_attention(*args))
                again = kernels.flash_attention(*args)
                torch.cuda.synchronize()
                if not wide or not torch.equal(out, again):
                    raise AssertionError(f"flash_attention D {D}: wide "
                                         f"kernel {wide}, or two launches "
                                         "differ")
                err, err_emu, share, mean = flash_errors(
                    torch, kernels, f"D {D} {kind}", out, *args)
                flash_err = max(flash_err, err_emu)
                flash_share = max(flash_share, share)
                errs[str(dtype)] = dict(
                    max_abs_err=err, max_abs_err_vs_bf16_plain=err_emu,
                    bf16_tolerance_share=share,
                    mean_abs_err_vs_bf16_plain=mean)
            f.update(case=f"decoder {Lx} D {D} {kind}", shape=list(q.shape),
                     mask=kind, valid_keys=int(valid.sum()), route="wide",
                     bit_equal=True, errors=errs)
            if kind == "prefix":
                timing = flash_timing(torch, kernels, q, k, v, valid)
                entry = dict(timing, library_ms=timing["library_bf16_ms"],
                             library="SDPA on bf16 operands",
                             library_f32_ms=timing["library_ms"],
                             shape=list(q.shape), errors=errs)
                f.update(entry)
                if D == WIDE_HEAD_DS[0]:
                    flash.update(entry)
                else:
                    flash[f"d{D}"] = entry
    flash.update(max_abs_err=flash_err, bf16_tolerance_share=flash_share)
    for D in (30, 96, 150, 192, 256, 300, 320):
        with Phase("kernel alignment_attention widths") as f:
            args = alignment_inputs(torch, np, rng, 4, 2, 300, 70, D)
            checks, wide = routed(
                kernels, "alignment_attention_wide",
                lambda: alignment_check(torch, kernels, f"D {D}", args))
            if wide != (D > 256):
                raise AssertionError(f"alignment_attention D {D}: wide "
                                     f"kernel launched: {wide}")
            if wide:
                align_err = max(align_err, checks["max_abs_err"])
            f.update(D=D, route=("wide" if wide else "tensor cores") + (
                         ", D zero-padded" if D not in (
                             32, 64, 128, 192, 256, 320) else ""),
                     **checks)
    for D in WIDE_HEAD_DS:
        with Phase("kernel alignment_attention wide") as f:
            shape = (TRAIN_B, 2, TRAIN_T, TRAIN_L, D)
            args = alignment_inputs(torch, np, rng, *shape)
            checks, wide = routed(
                kernels, "alignment_attention_wide",
                lambda: alignment_check(torch, kernels, f"D {D} timed", args))
            if not wide:
                raise AssertionError(f"alignment_attention D {D}: the wide "
                                     "kernel did not run")
            align_err = max(align_err, checks["max_abs_err"])
            entry = dict(alignment_timing(torch, kernels, args),
                         shape=list(shape), **checks)
            f.update(entry)
            if D == WIDE_HEAD_DS[0]:
                align.update(entry)
            else:
                align[f"d{D}"] = entry
    align.update(max_abs_err=align_err)
    mixed, dft = log_mel_widths(torch, np, kernels, compiled, rng)
    ptxas = wide_ptxas(compiled,
                       _build.load("flash_attention", FLASH_SIGNATURES),
                       _build.load("alignment_attention", ALIGN_SIGNATURES))
    flash.update(ptxas=ptxas)
    align.update(ptxas=ptxas)
    return {"flash_attention_wide": flash,
            "alignment_attention_wide": align,
            "fused_log_mel_mixed": mixed,
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


def write_hifigan(torch, voc_dir):
    """The committed HiFi-GAN V1 as an upstream torch checkpoint,
    ``{"generator": state_dict}`` with weight norm written out, and its
    ``config.json``, in ``voc_dir``.  Returns the checkpoint's path."""
    from smart_nar_fast_tts_tpu_torch.serving import committed_vocoder
    sd = {}
    for key, value in committed_vocoder().state_dict().items():
        if key.endswith(".weight") and value.ndim == 3:   # weight norm, dim 0
            base = key[:-len(".weight")]
            sd[base + ".weight_g"] = value.flatten(1).norm(dim=1)[:, None,
                                                                  None]
            sd[base + ".weight_v"] = value
        else:
            sd[key] = value
    os.makedirs(voc_dir)
    voc_path = os.path.join(voc_dir, "generator_v1.pth.tar")
    torch.save({"generator": sd}, voc_path)
    with open(os.path.join(REPO, "benchmarks", "results",
                           "vocoder_meta.json")) as f:
        voc_config = json.load(f)["config"]
    with open(os.path.join(voc_dir, "config.json"), "w") as f:
        json.dump({**voc_config, "num_mels": voc_config.get("n_mels", 80)},
                  f)
    return voc_path


def scaled_configs(out_dir, moved, names=("preprocess", "model", "train")):
    """Copies of ``configs/scaled/<name>.yaml`` in ``out_dir`` with each
    path key of ``moved`` set to its value.  Returns their paths."""
    import re
    paths = []
    for name in names:
        with open(os.path.join(REPO, "configs", "scaled",
                               f"{name}.yaml")) as f:
            text = f.read()
        for key, value in moved.items():
            text = re.sub(rf'(\n\s*{key}:\s*)"[^"]*"',
                          lambda m, v=value: f'{m.group(1)}"{v}"', text)
        paths.append(os.path.join(out_dir, f"{name}.yaml"))
        with open(paths[-1], "w") as f:
            f.write(text)
    return paths


def cli_workspace(torch, np):
    """``build/cli_smoke/``: copies of ``configs/scaled/*.yaml`` whose paths
    point there, ``stats.json`` from ``scaled_flagship_meta.json``, a port
    checkpoint of the committed 8-speaker flagship at its training step,
    HiFi-GAN V1 as ``{"generator": state_dict}`` (weight norm written out)
    with its ``config.json``, and the metadata file of the source run.
    Returns (config paths, step, vocoder path, metadata path)."""
    import shutil

    from smart_nar_fast_tts_tpu_torch.config import Config
    from smart_nar_fast_tts_tpu_torch.serving import committed_flagship
    from smart_nar_fast_tts_tpu_torch.text import text_to_sequence
    from smart_nar_fast_tts_tpu_torch.text.g2p import G2P
    from smart_nar_fast_tts_tpu_torch.training import (CheckpointManager,
                                                       create_train_state)
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(os.path.join(CLI_DIR, "preprocessed"))
    paths = scaled_configs(CLI_DIR, {
        key: os.path.join(CLI_DIR, sub) for key, sub in (
            ("preprocessed_path", "preprocessed"), ("data_path", "raw"),
            ("ckpt_path", "ckpt"), ("log_path", "log"),
            ("result_path", "result"))})
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
    voc_path = write_hifigan(torch, os.path.join(CLI_DIR, "hifigan"))
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
    counts = {**kernels.launches(), **kernels.route_launches()}
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
            # HiFi-GAN V1 vocodes each utterance alone; Griffin-Lim none
            if counts["hifigan_resblock_conv"] != RB_V1_LAUNCHES * len(
                    utts) * ("--vocoder_ckpt" in argv):
                raise AssertionError(f"{name}: resblock launches {counts} "
                                     f"for {len(utts)} utterances")
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
        blocked = ("yaml", "matplotlib", "tensorboard", "jax", "flax",
                   "msgpack", "smart_nar_fast_tts_tpu")
        clis = ("synthesize", "train", "evaluate", "train_vocoder",
                "preprocess", "import_checkpoint", "train_g2p")
        code = (f"import sys\nfor n in {blocked!r}:\n    sys.modules[n] = "
                f"None\nfor c in {clis!r}:\n    __import__("
                "'smart_nar_fast_tts_tpu_torch.cli.' + c)\n"
                "import smart_nar_fast_tts_tpu_torch.vocoder\n"
                "import smart_nar_fast_tts_tpu_torch.vocoder.sharding\n"
                "import smart_nar_fast_tts_tpu_torch.parallel\n")
        res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise AssertionError(f"a CLI needs a blocked module:\n"
                                 f"{res.stderr[-2000:]}")
        f.update(blocked=list(blocked), clis=list(clis))
    return entry, report, dict(configs=paths, step=step, vocoder=voc,
                               text_wav=runs["text"][0][0].wav,
                               utts={name: runs[name][0]
                                     for name in IMPORT_RUNS})


# the preprocess CLI's raw corpus (build/preprocess_smoke/): the first 240
# utterances of benchmarks/corpus.py's scaled corpus (seed 0, 8 speakers,
# ground-truth TextGrids), on which configs/scaled/ and the committed
# 8-speaker flagship were built; preprocessed on the card, then again by 4
# CPU workers; then 2 train steps of the flagship on the card's store
PRE_DIR = os.path.join(REPO, "build", "preprocess_smoke")
PRE_UTTS, PRE_SPEAKERS, PRE_SEED = 240, 8, 0
PRE_WORKERS = 4
PRE_TRAIN_STEPS = 2
STORE_ENERGY_RTOL = 1e-5   # the store's energy, card against CPU, in its
# own units (z · std + mean), and the energy statistics


def preprocess_corpus(np, root):
    """``benchmarks/corpus.py``'s ``make_scaled_corpus`` for its first
    PRE_UTTS utterances, with the port's ``save_wav`` (that function
    imports the JAX package's): ``raw/<spk>/uttNNNNN.{wav,lab}`` and
    ``TextGrid/<spk>/uttNNNNN.TextGrid`` under ``root``.  Returns the
    seconds of audio written."""
    from benchmarks import corpus

    from smart_nar_fast_tts_tpu_torch.data import save_wav
    rng = np.random.default_rng(PRE_SEED)
    speakers = {f"spk{s}": corpus.speaker_params(s, rng)
                for s in range(PRE_SPEAKERS)}
    seconds = 0.0
    for u in range(PRE_UTTS):
        name = f"spk{u % PRE_SPEAKERS}"
        spk_dir = os.path.join(root, "raw", name)
        tg_dir = os.path.join(root, "TextGrid", name)
        os.makedirs(spk_dir, exist_ok=True)
        os.makedirs(tg_dir, exist_ok=True)
        entries = corpus.sample_entries(speakers[name], rng)
        wav = corpus.synth_utterance(entries, speakers[name], rng)
        seconds += len(wav) / corpus.SR
        base = f"utt{u:05d}"
        save_wav(os.path.join(spk_dir, f"{base}.wav"), wav, corpus.SR)
        with open(os.path.join(spk_dir, f"{base}.lab"), "w") as f:
            f.write(f"scaled synthetic utterance {u} ({name})")
        corpus._write_textgrid(os.path.join(tg_dir, f"{base}.TextGrid"),
                               entries, entries[-1][1])
    return seconds


def npy_header(np, path):
    """(shape, fortran order, dtype) of a ``.npy`` file."""
    fmt = np.lib.format
    with open(path, "rb") as f:
        version = fmt.read_magic(f)
        return (fmt.read_array_header_1_0 if version == (1, 0)
                else fmt.read_array_header_2_0)(f)


def store_errors(np, a, b):
    """Store ``a`` against store ``b``: the file lists, every ``.npy``
    header, ``speakers.json``, ``train.txt`` and ``val.txt`` equal; pitch
    and its statistics exact; mel within MEL_TOL; energy in its own units
    and its statistics within STORE_ENERGY_RTOL.  Returns the max errors."""
    for name in ("speakers.json", "train.txt", "val.txt"):
        with open(os.path.join(a, name)) as fa, \
                open(os.path.join(b, name)) as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{name} differs")
    stats = []
    for d in (a, b):
        with open(os.path.join(d, "stats.json")) as f:
            stats.append(json.load(f))
    if stats[0]["pitch"] != stats[1]["pitch"]:
        raise AssertionError(f"pitch stats {stats}")
    ea, eb = (np.asarray(st["energy"]) for st in stats)
    errs = {"energy_stats_rel": float((abs(ea - eb) / abs(eb)).max()),
            "mel_max_abs": 0.0, "energy_max_rel": 0.0, "pitch_max_abs": 0.0}
    for kind in ("mel", "pitch", "energy"):
        names = sorted(os.listdir(os.path.join(a, kind)))
        if names != sorted(os.listdir(os.path.join(b, kind))):
            raise AssertionError(f"{kind}/ file lists differ")
        for name in names:
            pa, pb = (os.path.join(d, kind, name) for d in (a, b))
            if npy_header(np, pa) != npy_header(np, pb):
                raise AssertionError(f"{kind}/{name}: headers differ")
            x, y = np.load(pa), np.load(pb)
            if kind == "mel":
                errs["mel_max_abs"] = max(errs["mel_max_abs"],
                                          float(abs(x - y).max()))
            elif kind == "pitch":
                errs["pitch_max_abs"] = max(errs["pitch_max_abs"],
                                            float(abs(x - y).max()))
            else:
                x, y = x * ea[3] + ea[2], y * eb[3] + eb[2]
                errs["energy_max_rel"] = max(errs["energy_max_rel"], float(
                    (abs(x - y) / abs(y)).max()))
    errs["utterances"] = len(names)
    if not (errs["pitch_max_abs"] == 0.0 and errs["mel_max_abs"] <= MEL_TOL
            and errs["energy_max_rel"] <= STORE_ENERGY_RTOL
            and errs["energy_stats_rel"] <= STORE_ENERGY_RTOL):
        raise AssertionError(f"stores differ beyond the gates: {errs}")
    return errs


def preprocess_phase(torch, np, kernels, cli):
    """The preprocessing CLI from a raw corpus to training: PRE_UTTS
    utterances written under ``build/preprocess_smoke/``; ``python -m
    smart_nar_fast_tts_tpu_torch.cli.preprocess`` as ``main(argv)`` on a
    copy of ``configs/scaled/preprocess.yaml`` (the card's mel, the host's
    native F0), the launch counts set to 0 just before and read just after
    (0 for every kernel), its time split into F0, mel (host and CUDA
    events), reads and writes; the same corpus by ``python -m ...
    --device cpu --workers 4`` in a subprocess, into a second store held to
    the first (:func:`store_errors`); then ``cli.train`` for
    PRE_TRAIN_STEPS steps on the card's store from a copy of the cli
    phase's checkpoint of the 8-speaker flagship: finite losses, a
    checkpoint written, one upsampling launch a step.  Returns the launch
    counts of the preprocessing run and of the training run."""
    import contextlib
    import io
    import shutil
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.cli import preprocess as preprocess_cli
    from smart_nar_fast_tts_tpu_torch.cli import train as train_cli
    from smart_nar_fast_tts_tpu_torch.data import native_f0
    from smart_nar_fast_tts_tpu_torch.data import preprocessor
    from smart_nar_fast_tts_tpu_torch.training import CheckpointManager
    from smart_nar_fast_tts_tpu_torch.training import trainer as trainer_mod
    raw = os.path.join(PRE_DIR, "raw")
    stores = {run: os.path.join(PRE_DIR, run, "preprocessed")
              for run in ("card", "cpu")}
    with Phase("preprocess setup") as f:
        shutil.rmtree(PRE_DIR, ignore_errors=True)
        audio_s = preprocess_corpus(np, PRE_DIR)
        for store in stores.values():
            shutil.copytree(os.path.join(PRE_DIR, "TextGrid"),
                            os.path.join(store, "TextGrid"))
        card = os.path.join(PRE_DIR, "card")
        paths = scaled_configs(card, {
            "data_path": raw, "preprocessed_path": stores["card"],
            **{key: os.path.join(card, key.split("_")[0])
               for key in ("ckpt_path", "log_path", "result_path")}})
        cpu_config, = scaled_configs(
            os.path.join(PRE_DIR, "cpu"), {
                "data_path": raw, "preprocessed_path": stores["cpu"]},
            names=("preprocess",))
        t0 = time.perf_counter()
        if not native_f0.native_available():
            raise AssertionError("the native F0 library does not build")
        f.update(utterances=PRE_UTTS, speakers=PRE_SPEAKERS,
                 audio_seconds=audio_s, configs=[*paths, cpu_config],
                 native_f0_build_seconds=time.perf_counter() - t0,
                 native_f0_library=os.path.relpath(native_f0.lib_path(),
                                                   REPO))

    with Phase("preprocess cli") as f:
        split = {"f0": 0.0, "mel_host": 0.0, "reads": 0.0, "writes": 0.0}
        events = []

        def timed(key, fn):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    split[key] += time.perf_counter() - t0
            return wrapper

        mel_fn = preprocessor.mel_spectrogram

        def mel_events(y, cfg):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = mel_fn(y, cfg)
            ev[1].record()
            events.append(ev)
            return out

        spies = [(native_f0, "estimate_f0_native", "f0"),
                 (preprocessor.Preprocessor, "mel_energy", "mel_host"),
                 (preprocessor, "load_wav", "reads"),
                 (preprocessor, "read_textgrid", "reads"),
                 (np, "load", "reads"), (np, "save", "writes")]
        printed = io.StringIO()
        with contextlib.ExitStack() as stack:
            for owner, name, key in spies:
                stack.enter_context(mock.patch.object(
                    owner, name, timed(key, getattr(owner, name))))
            stack.enter_context(mock.patch.object(
                preprocessor, "mel_spectrogram", mel_events))
            stack.enter_context(contextlib.redirect_stdout(printed))
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = preprocess_cli.main([paths[0]])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {**kernels.launches(), **kernels.route_launches()}
        line = printed.getvalue().strip().splitlines()[-1]
        if line != f"preprocessed {PRE_UTTS} utterances → {stores['card']}":
            raise AssertionError(f"cli.preprocess printed {line!r}")
        if len(out) != PRE_UTTS or any(counts.values()):
            raise AssertionError(f"{len(out)} utterances, launches {counts}")
        mel_device_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
        split = {f"{k}_seconds": v for k, v in split.items()}
        split["other_seconds"] = wall - sum(split.values())
        f.update(utterances=len(out), launches=counts, wall_seconds=wall,
                 audio_seconds=audio_s,
                 audio_seconds_per_wall_second=audio_s / wall,
                 split=split, mel_device_seconds=mel_device_s,
                 mel_calls=len(events), nvidia_smi=nvidia_smi())

    with Phase("preprocess cli cpu") as f:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "smart_nar_fast_tts_tpu_torch.cli."
             "preprocess", cpu_config, "--device", "cpu", "--workers",
             str(PRE_WORKERS)], cwd=REPO, capture_output=True, text=True,
            timeout=900)
        cpu_wall = time.perf_counter() - t0
        if res.returncode != 0 or res.stdout.strip().splitlines()[-1] != (
                f"preprocessed {PRE_UTTS} utterances → {stores['cpu']}"):
            raise AssertionError(f"cli.preprocess --device cpu: rc "
                                 f"{res.returncode}\n{res.stdout[-1000:]}"
                                 f"\n{res.stderr[-3000:]}")
        errs = store_errors(np, stores["card"], stores["cpu"])
        f.update(workers=PRE_WORKERS, wall_seconds=cpu_wall,
                 audio_seconds_per_wall_second=audio_s / cpu_wall,
                 card_against_cpu=errs, mel_tol=MEL_TOL,
                 energy_rtol=STORE_ENERGY_RTOL)

    with Phase("preprocess train") as f:
        step = cli["step"]
        shutil.copytree(os.path.join(CLI_DIR, "ckpt", str(step)),
                        os.path.join(card, "ckpt", str(step)))
        make = trainer_mod.make_train_step
        losses = []

        def recording_make(*args, **kwargs):
            train_step = make(*args, **kwargs)

            def spy(*a, **k):
                out = train_step(*a, **k)
                losses.append(out)
                return out
            return spy

        p, m, t = paths
        kernels.reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(trainer_mod, "make_train_step",
                               recording_make):
            trainer = train_cli.main(["-p", p, "-m", m, "-t", t,
                                      "--total_step",
                                      str(step + PRE_TRAIN_STEPS)])
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_counts = {**kernels.launches(), **kernels.route_launches()}
        if len(losses) != PRE_TRAIN_STEPS:
            raise AssertionError(f"{len(losses)} train steps")
        for i, lo in enumerate(losses):
            check_finite_losses(torch, lo, f"train step {step + i + 1}")
        saved = CheckpointManager(trainer.cfg.train.ckpt_path).all_steps()
        if saved != [step, step + PRE_TRAIN_STEPS]:
            raise AssertionError(f"checkpoints {saved}")
        want = {k: 0 for k in train_counts}
        want["gaussian_upsample_banded"] = PRE_TRAIN_STEPS
        if train_counts != want:
            raise AssertionError(f"train launches {train_counts}, expected "
                                 f"{want}")
        f.update(launches=train_counts, checkpoints=saved,
                 wall_seconds=train_wall,
                 losses=[{k: float(v) for k, v in lo._asdict().items()}
                         for lo in losses])
    return counts, train_counts


# the import phases (build/import_smoke/): the cli phase's checkpoint of the
# committed 8-speaker flagship written as a reference <step>.pth.tar (with
# the reference-only entries), imported by cli.import_checkpoint, served by
# cli.synthesize; then evaluated and trained on the preprocess phase's card
# store with intended/first extraction (configs/scaled/'s soft/mean runs no
# alignment kernel), beside the directly saved checkpoint
IMPORT_DIR = os.path.join(REPO, "build", "import_smoke")
IMPORT_TRAIN_STEPS = 2
IMPORT_RUNS = ("text", "long")     # the cli phase's runs served again


def noam(step, d_model, warm_up):
    """The Noam rate of 1-based update ``step`` without annealing
    (reference ``model/optimizer.py``), written out apart from the port's
    schedule."""
    return d_model ** -0.5 * min(step ** -0.5, step * warm_up ** -1.5)


def reference_file(torch, cfg, state_path, out_path):
    """The model of the port checkpoint ``state_path`` in the reference's
    layout, ``{"model": state_dict, "optimizer": ...}`` as reference
    ``train.py`` saves it, the ``position_enc`` tables, quantization bins
    and ``num_batches_tracked`` counters included.  Returns (the port's
    state dict, the number of reference-only entries)."""
    from smart_nar_fast_tts_tpu_torch.models.convert import (
        port_state_dict_to_reference, reference_buffers)
    saved = torch.load(state_path, map_location="cpu", weights_only=True)
    extra = reference_buffers(cfg.model, cfg.preprocess)
    sd = {**port_state_dict_to_reference(saved["model"], cfg.model),
          **extra}
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "optimizer": saved["optimizer"]}, out_path)
    return saved["model"], len(extra)


def import_phase(torch, np, kernels, cli):
    """``cli.import_checkpoint`` on a reference-layout ``<step>.pth.tar`` of
    the cli phase's checkpoint (the same weights and step), on the card:
    the imported model bit-equal to the saved one, ``data.json``; then
    ``cli.synthesize --restore_step <step>`` from it on the cli phase's runs
    (a) and (b) (cap 4096: 4 flash and 2 upsampling launches), each with the
    launch counts set to 0 just before and read just after, durations and
    mel lengths exact, postnet mel within MEL_TOL and waveform within
    WAV_TOL of the cli phase's run (the same weights and kernels: 0
    expected).  Returns (the launches of each run, the reference file)."""
    import contextlib
    import io
    import shutil

    from smart_nar_fast_tts_tpu_torch.cli import import_checkpoint
    from smart_nar_fast_tts_tpu_torch.cli import synthesize
    from smart_nar_fast_tts_tpu_torch.config import Config
    from smart_nar_fast_tts_tpu_torch.training.checkpoint import (DATA_FILE,
                                                                  STATE_FILE)
    step = cli["step"]
    with Phase("import setup") as f:
        shutil.rmtree(IMPORT_DIR, ignore_errors=True)
        os.makedirs(IMPORT_DIR)
        paths = scaled_configs(IMPORT_DIR, {
            "preprocessed_path": os.path.join(CLI_DIR, "preprocessed"),
            **{key: os.path.join(IMPORT_DIR, key.split("_")[0])
               for key in ("ckpt_path", "log_path", "result_path")}})
        cfg = Config.from_yaml_triplet(*paths)
        ref_path = os.path.join(IMPORT_DIR, f"{step}.pth.tar")
        direct, n_extra = reference_file(
            torch, cfg, os.path.join(CLI_DIR, "ckpt", str(step), STATE_FILE),
            ref_path)
        f.update(reference_file=os.path.relpath(ref_path, REPO),
                 bytes=os.path.getsize(ref_path), reference_only=n_extra)
    with Phase("import checkpoint") as f:
        printed = io.StringIO()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            got = import_checkpoint.main(["--torch_ckpt", ref_path, "-p",
                                          paths[0], "-m", paths[1], "-t",
                                          paths[2]])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts(kernels)
        line = printed.getvalue().strip()
        if got != step or line != (f"imported step {step} -> "
                                   f"{cfg.train.ckpt_path}"):
            raise AssertionError(f"cli.import_checkpoint: {got}, {line!r}")
        if any(counts.values()):
            raise AssertionError(f"the import launched {counts}")
        out_dir = os.path.join(cfg.train.ckpt_path, str(step))
        saved = torch.load(os.path.join(out_dir, STATE_FILE),
                           map_location="cpu", weights_only=True)
        if saved["step"] != step or saved["optimizer"]["state"]:
            raise AssertionError("the imported step or optimizer state")
        if saved["model"].keys() != direct.keys() or not all(
                torch.equal(saved["model"][k], direct[k]) for k in direct):
            raise AssertionError("the imported model differs from the "
                                 "saved one")
        with open(os.path.join(out_dir, DATA_FILE)) as fh:
            data = json.load(fh)
        if data != {"epoch": 0, "in_epoch": 0, "imported": True}:
            raise AssertionError(f"data.json {data}")
        f.update(step=step, wall_seconds=wall, launches=counts,
                 tensors=len(direct), data_json=data,
                 nvidia_smi=nvidia_smi())
    base = ["-p", paths[0], "-m", paths[1], "-t", paths[2],
            "--restore_step", str(step), "--vocoder_ckpt", cli["vocoder"]]
    texts = {"text": ["--text", CLI_TEXT], "long": ["--text", CLI_LONG]}
    entry = {}
    for name in IMPORT_RUNS:
        with Phase(f"import synthesize {name}") as f:
            utts, counts, wall, seconds = cli_run(
                torch, np, kernels, synthesize,
                base + texts[name] + ["--speaker_id", str(CLI_SPEAKER)])
            want = cli["utts"][name]
            long = name == "long"
            if counts["flash_attention"] != 4 * long or counts[
                    "gaussian_upsample_banded"] != 1 + long or counts[
                    "hifigan_resblock_conv"] != RB_V1_LAUNCHES:
                raise AssertionError(f"import {name}: launches {counts}")
            mel_err = wav_err = 0.0
            for u, w in zip(utts, want, strict=True):
                if (u.cap, u.mel_len) != (w.cap, w.mel_len) or \
                        not np.array_equal(u.duration, w.duration):
                    raise AssertionError(f"import {name} {u.name}: "
                                         "capacity, mel_len or durations")
                mel_err = max(mel_err, float(np.abs(u.postnet_mel
                                                    - w.postnet_mel).max()))
                wav_err = max(wav_err, float(np.abs(u.wav - w.wav).max()))
            if not (mel_err <= MEL_TOL and wav_err <= WAV_TOL):
                raise AssertionError(f"import {name}: postnet mel {mel_err}"
                                     f", wav {wav_err} from the cli phase")
            f.update(launches=counts, caps=sorted({u.cap for u in utts}),
                     mel_lens=[u.mel_len for u in utts],
                     postnet_mel_max_abs_err=mel_err, mel_tol=MEL_TOL,
                     wav_max_abs_err=wav_err, wav_tol=WAV_TOL,
                     wall_seconds=wall, rtf=wall / seconds)
            entry[f"synthesize ({name})"] = counts
    return entry, ref_path


def import_resume_phase(torch, np, kernels, cli, ref_path):
    """The imported checkpoint through the training CLIs on the preprocess
    phase's card store, with ``intended``/``first`` extraction:
    ``cli.evaluate --restore_step <step>`` from it and from the directly
    saved checkpoint (the same val losses, exactly); ``cli.train
    --restore_step <step> --total_step <step + 2>`` from it (updates
    step + 1 and + 2 at the Noam rates of those steps, finite losses,
    step + 2 saved); each with the launch counts set to 0 just before and
    read just after.  Then ``python -m ...cli.import_checkpoint`` on the
    file with one key removed exits non-zero, naming it, and writes
    nothing.  Returns the launches of each run."""
    import shutil
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.cli import evaluate as evaluate_cli
    from smart_nar_fast_tts_tpu_torch.cli import train as train_cli
    from smart_nar_fast_tts_tpu_torch.config import Config
    from smart_nar_fast_tts_tpu_torch.training import (CheckpointManager,
                                                       TrainState)
    from smart_nar_fast_tts_tpu_torch.training import trainer as trainer_mod
    step = cli["step"]
    store = os.path.join(PRE_DIR, "card", "preprocessed")
    sources = {"imported": os.path.join(IMPORT_DIR, "ckpt", str(step)),
               "direct": os.path.join(CLI_DIR, "ckpt", str(step))}
    with Phase("import resume setup") as f:
        argv = {}
        for run, source in sources.items():
            root = os.path.join(IMPORT_DIR, run)
            os.makedirs(root)
            paths = scaled_configs(root, {
                "preprocessed_path": store, "duration_extraction": "intended",
                "duration_head_reduce": "first",
                **{key: os.path.join(root, key.split("_")[0])
                   for key in ("ckpt_path", "log_path", "result_path")}})
            cfg = Config.from_yaml_triplet(*paths)
            if (cfg.model.duration_extraction, cfg.model.duration_head_reduce
                    ) != ("intended", "first"):
                raise AssertionError(f"model config {cfg.model}")
            shutil.copytree(source, os.path.join(cfg.train.ckpt_path,
                                                 str(step)))
            argv[run] = ["-p", paths[0], "-m", paths[1], "-t", paths[2]]
        f.update(store=os.path.relpath(store, REPO), configs=argv)
    runs = {}
    with Phase("import resume") as f:
        losses = {}
        for run in sources:
            kernels.reset_launches()
            losses[run] = evaluate_cli.main(argv[run] + [
                "--restore_step", str(step)])
            torch.cuda.synchronize()
            runs[f"evaluate ({run})"] = launch_counts(kernels)
        if losses["imported"] != losses["direct"] or not all(
                math.isfinite(v) for v in losses["imported"]):
            raise AssertionError(f"val losses {losses}")
        ev = runs["evaluate (imported)"]
        if not ev["alignment_attention"] or ev["alignment_attention"] != \
                4 * ev["gaussian_upsample_banded"] or ev[
                "hifigan_resblock_conv"]:
            raise AssertionError(f"evaluate launches {ev}")

        apply, updates, train_losses = TrainState.apply_gradients, [], []

        def recording_apply(self):
            norm = apply(self)
            updates.append((self.step,
                            self.optimizer.param_groups[0]["lr"]))
            return norm

        make = trainer_mod.make_train_step

        def recording_make(*args, **kwargs):
            train_step = make(*args, **kwargs)

            def spy(*a, **k):
                out = train_step(*a, **k)
                train_losses.append(out)
                return out
            return spy

        total = step + IMPORT_TRAIN_STEPS
        kernels.reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(TrainState, "apply_gradients",
                               recording_apply), \
                mock.patch.object(trainer_mod, "make_train_step",
                                  recording_make):
            trainer = train_cli.main(argv["imported"] + [
                "--restore_step", str(step), "--total_step", str(total)])
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        runs["train resume"] = counts = launch_counts(kernels)
        cfg = trainer.cfg
        opt = cfg.train.optimizer
        d_model = cfg.model.transformer.encoder_hidden
        if opt.anneal_steps or [s for s, _ in updates] != list(
                range(step + 1, total + 1)):
            raise AssertionError(f"updates {updates}")
        for s, lr in updates:
            if not math.isclose(lr, noam(s, d_model, opt.warm_up_step),
                                rel_tol=1e-12):
                raise AssertionError(f"step {s}: lr {lr}")
        for s, lo in zip(range(step + 1, total + 1), train_losses,
                         strict=True):
            check_finite_losses(torch, lo, f"resumed step {s}")
        saved = CheckpointManager(cfg.train.ckpt_path).all_steps()
        if saved != [step, total]:
            raise AssertionError(f"checkpoints {saved}")
        want = {k: 0 for k in counts}
        want.update({k: v * IMPORT_TRAIN_STEPS
                     for k, v in PER_TRAIN_STEP.items()})
        if counts != want:
            raise AssertionError(f"resumed launches {counts}, expected "
                                 f"{want}")

        bad_path = os.path.join(IMPORT_DIR, f"{step}_missing.pth.tar")
        raw = torch.load(ref_path, map_location="cpu", weights_only=True)
        removed = "mel_linear.bias"
        del raw["model"][removed]
        torch.save(raw, bad_path)
        bad_ckpt = os.path.join(IMPORT_DIR, "refused")
        os.makedirs(bad_ckpt)
        bad_paths = scaled_configs(bad_ckpt, {
            "preprocessed_path": os.path.join(CLI_DIR, "preprocessed"),
            "ckpt_path": os.path.join(bad_ckpt, "ckpt")})
        res = subprocess.run(
            [sys.executable, "-m",
             "smart_nar_fast_tts_tpu_torch.cli.import_checkpoint",
             "--torch_ckpt", bad_path, "--step", str(step), "-p",
             bad_paths[0], "-m", bad_paths[1], "-t", bad_paths[2]],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        message = res.stderr.strip().splitlines()[-1] if res.stderr else ""
        if res.returncode == 0 or message != (
                f"param tree mismatch: missing=['{removed}'] extra=[]") \
                or os.path.exists(os.path.join(bad_ckpt, "ckpt")):
            raise AssertionError(f"the mismatched file: rc {res.returncode}"
                                 f"\n{res.stderr[-2000:]}")
        f.update(launches=runs, val_losses=dict(losses["imported"]._asdict()),
                 val_losses_equal=True,
                 updates=[{"step": s, "lr": lr} for s, lr in updates],
                 train_losses=[{k: float(v) for k, v in lo._asdict().items()}
                               for lo in train_losses],
                 train_wall_seconds=train_wall, checkpoints=saved,
                 mismatched_exit_code=res.returncode,
                 mismatched_message=message, nvidia_smi=nvidia_smi())
    return runs


# cli.train_g2p (build/g2p_smoke/) on the card and on the CPU from the same
# seed: on the committed seed lexicon for 2 epochs, and on every 13th word
# of it (150 words, batch 16, 2 epochs; tests/test_torch_train_g2p.py's
# slice).  The full run's second epoch is reported, not held: the training
# amplifies rounding, and past its first epoch two runs whose products
# round apart (another device, or the CPU at another thread count) no
# longer agree to 1e-4; so the gates hold its first epoch and the slice
G2P_DIR = os.path.join(REPO, "build", "g2p_smoke")
G2P_EPOCHS = 2
G2P_SLICE_STEP, G2P_SLICE_BATCH = 13, 16
G2P_LOSS_RTOL = 1e-4   # an epoch's loss, card against CPU
G2P_ATOL = 1e-4        # the slice's saved arrays, card against CPU


class TimedLines(io.TextIOBase):
    """A stdout that keeps each printed line with the ``perf_counter`` time
    it was completed at."""

    def __init__(self):
        self.lines, self._part = [], ""

    def write(self, s):
        *done, self._part = (self._part + s).split("\n")
        now = time.perf_counter()
        self.lines += [(now, line) for line in done]
        return len(s)


def run_train_g2p(argv):
    """``cli.train_g2p.main(argv)`` with its printed lines timed.  Returns
    (the report, [(seconds since the call, line)], wall seconds)."""
    import contextlib

    from smart_nar_fast_tts_tpu_torch.cli import train_g2p
    out = TimedLines()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        report = train_g2p.main(argv)
    wall = time.perf_counter() - t0
    return report, [(t - t0, line) for t, line in out.lines], wall


def epoch_lines(lines):
    """{epoch: (seconds, loss)} of the trainer's ``epoch N  loss L``
    lines."""
    return {int(line.split()[1]): (t, float(line.split()[-1]))
            for t, line in lines if line.startswith("epoch")}


def g2p_runs(np, name, argv):
    """``argv`` through :func:`run_train_g2p` on the card and with
    ``--device cpu``, each into its own file: {device: run}, and the
    largest difference of the saved arrays."""
    runs = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(G2P_DIR, f"{name}_{device}.npz")
        report, lines, wall = run_train_g2p(
            argv + ["--out", out]
            + (["--device", "cpu"] if device == "cpu" else []))
        epochs = epoch_lines(lines)
        if sorted(epochs) != list(range(G2P_EPOCHS)):
            raise AssertionError(f"{name} {device}: printed {lines}")
        runs[device] = dict(
            report=report, out=out, wall_seconds=wall,
            first_epoch_seconds=epochs[0][0],
            seconds_per_epoch=(epochs[G2P_EPOCHS - 1][0] - epochs[0][0])
            / (G2P_EPOCHS - 1),
            losses=[epochs[e][1] for e in range(G2P_EPOCHS)],
            other_lines=[line for _, line in lines
                         if not line.startswith(("epoch", "{"))])
    card, cpu = runs["cuda"], runs["cpu"]
    if card["other_lines"] != cpu["other_lines"]:
        raise AssertionError(f"{name}: the augmentation lines differ")
    with np.load(card["out"]) as a, np.load(cpu["out"]) as b:
        if sorted(a.files) != sorted(b.files):
            raise AssertionError(f"{name}: the saved arrays' names differ")
        err = max(float(np.abs(a[k] - b[k]).max()) for k in a.files)
    return runs, err


def loss_rel(runs):
    """Each epoch's printed loss, card against CPU, relative."""
    return [abs(a - b) / abs(b) for a, b in zip(runs["cuda"]["losses"],
                                               runs["cpu"]["losses"])]


def train_g2p_phase(torch, np):
    """``cli.train_g2p --epochs 2`` on the card and with ``--device cpu``
    from the same seed: on the committed seed lexicon, the same
    augmentation line, epoch 0's loss within G2P_LOSS_RTOL (epoch 1's and
    the arrays' distance reported), the card's file through the port's
    ``G2PModel``, its held-out PER (the report's), seconds per epoch
    (between the epochs' lines) and the first epoch's; on the 150-word
    slice, both epochs' losses within G2P_LOSS_RTOL and every saved array
    within G2P_ATOL."""
    import shutil

    from smart_nar_fast_tts_tpu_torch.cli.train_g2p import load_pairs
    from smart_nar_fast_tts_tpu_torch.text import g2p_model
    shutil.rmtree(G2P_DIR, ignore_errors=True)
    os.makedirs(G2P_DIR)
    with Phase("train g2p") as f:
        runs, arr_err = g2p_runs(np, "seed", ["--epochs", str(G2P_EPOCHS)])
        rel = loss_rel(runs)
        if not rel[0] <= G2P_LOSS_RTOL:
            raise AssertionError(f"train_g2p epoch 0 loss, card against "
                                 f"CPU: {rel[0]}")
        model = g2p_model.G2PModel(runs["cuda"]["out"])
        words = ("hello", "zorblax", "quixotic")
        if not all(model.predict(w) for w in words):
            raise AssertionError("the card's model predicts nothing")
        f.update(runs=runs, loss_rel_err=rel, loss_rtol=G2P_LOSS_RTOL,
                 arrays_max_abs_err=arr_err,
                 card_heldout_per=runs["cuda"]["report"]["per"],
                 card_predictions={w: model.predict(w) for w in words},
                 nvidia_smi=nvidia_smi())
    with Phase("train g2p slice") as f:
        pairs = load_pairs(g2p_model.DEFAULT_SEED_LEXICON)
        words = sorted(pairs)[::G2P_SLICE_STEP]
        lexicon = os.path.join(G2P_DIR, "slice.txt")
        with open(lexicon, "w") as fh:
            fh.writelines(f"{w.upper()}  {' '.join(pairs[w])}\n"
                          for w in words)
        runs, arr_err = g2p_runs(np, "slice", [
            "--lexicon", lexicon, "--epochs", str(G2P_EPOCHS),
            "--batch_size", str(G2P_SLICE_BATCH)])
        rel = loss_rel(runs)
        if not (max(rel) <= G2P_LOSS_RTOL and arr_err <= G2P_ATOL):
            raise AssertionError(f"train_g2p slice, card against CPU: loss "
                                 f"{rel}, arrays {arr_err}")
        f.update(words=len(words), runs=runs, loss_rel_err=rel,
                 loss_rtol=G2P_LOSS_RTOL, arrays_max_abs_err=arr_err,
                 arrays_atol=G2P_ATOL)


# the trainer CLI's corpus and run (build/trainer_smoke/): 96 train
# utterances (2 batches of TRAIN_B an epoch) and 40 val ones (one batch,
# mask-padded), texts of TRAIN_L - 32 to TRAIN_L phones as train_batch draws
# them; 6 steps over 3 epochs, then a resume to 8
TRAINER_DIR = os.path.join(REPO, "build", "trainer_smoke")
TRAINER_UTTS = {"train": 96, "val": 40}
TRAINER_STEP = dict(total_step=6, log_step=2, synth_step=6, val_step=3,
                    save_step=3)
TRAINER_RESUME_TOTAL = 8
TRAINER_PROFILE = (3, 2)    # the profiler traces steps 4 and 5
# launches of one forward of the flagship with intended/first extraction:
# train, eval and sample forwards alike (teacher-forced, MelEncoder on)
PER_FORWARD = {"flash_attention": 0, "alignment_attention": 4,
               "gaussian_upsample_banded": 1, "fused_log_mel": 0,
               "hifigan_resblock_conv": 0}
VOC_CLI_DIR = os.path.join(REPO, "build", "train_vocoder_smoke")
VOC_CLI_STEPS = 4


def yaml_text(d, indent=0):
    """A nested dict of numbers, strings and lists as block YAML (the
    subset ``yaml_subset`` reads; no PyYAML on the card's machine)."""
    lines = []
    for k, v in d.items():
        pad = " " * indent
        if isinstance(v, dict):
            lines.append(f"{pad}{k}:")
            lines.append(yaml_text(v, indent + 2))
        else:
            lines.append(f"{pad}{k}: {json.dumps(v)}")
    return "\n".join(lines)


def trainer_workspace(torch, np, synth, inv, vocoder):
    """``build/trainer_smoke/``: a preprocessed corpus whose targets are
    the port's stage-A output (postnet mel, pitch, energy, each cut to its
    item's mel_len) for seeded texts from the trained phone inventory,
    written as ``{P1 P2 …}`` phone strings; ``speakers.json``;
    ``stats.json`` holding ``flagship_meta.json``'s stats; the YAML
    triplet (``vocoder`` for the samples' audio); and a port checkpoint of
    the committed flagship at step 0.  Returns the triplet's paths."""
    import shutil

    from smart_nar_fast_tts_tpu_torch.config import Config, ModelConfig
    from smart_nar_fast_tts_tpu_torch.data import AcousticDataset
    from smart_nar_fast_tts_tpu_torch.serving import committed_flagship
    from smart_nar_fast_tts_tpu_torch.text.symbols import ID_TO_SYMBOL
    from smart_nar_fast_tts_tpu_torch.training import (CheckpointManager,
                                                       create_train_state)
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    pre = os.path.join(TRAINER_DIR, "preprocessed")
    for kind in ("mel", "pitch", "energy"):
        os.makedirs(os.path.join(pre, kind))
    n = sum(TRAINER_UTTS.values())
    rng = np.random.default_rng(3)
    ids = rng.choice(inv, size=(n, TRAIN_L))
    lens = rng.integers(TRAIN_L - 32, TRAIN_L + 1, size=n)
    lines = []
    for lo in range(0, n, TRAIN_B):
        with torch.inference_mode():
            out = synth.stage_a(torch.from_numpy(ids[lo:lo + TRAIN_B]),
                                torch.from_numpy(lens[lo:lo + TRAIN_B]))
        for j in range(out.mel_lens.shape[0]):
            i, m = lo + j, int(out.mel_lens[j])
            name = f"utt{i:03d}"
            for kind, value in (("mel", out.postnet_mel[j, :m]),
                                ("pitch", out.pitch_prediction[j, :m]),
                                ("energy", out.energy_prediction[j, :m])):
                np.save(os.path.join(pre, kind, f"spk-{kind}-{name}.npy"),
                        value.float().cpu().numpy())
            phones = " ".join(ID_TO_SYMBOL[int(k)].lstrip("@")
                              for k in ids[i, :lens[i]])
            lines.append(f"{name}|spk|{{{phones}}}|{name}")
    n_train = TRAINER_UTTS["train"]
    for split, rows in (("train", lines[:n_train]), ("val", lines[n_train:])):
        with open(os.path.join(pre, f"{split}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(pre, "speakers.json"), "w") as f:
        json.dump({"spk": 0}, f)
    with open(os.path.join(REPO, "benchmarks", "results",
                           "flagship_meta.json")) as f:
        st = json.load(f)["stats"]
    with open(os.path.join(pre, "stats.json"), "w") as f:
        json.dump({kind: [st[f"{kind}_{k}"] for k in ("min", "max", "mean",
                                                      "std")]
                   for kind in ("pitch", "energy")}, f)
    out_dir = os.path.join(TRAINER_DIR, "output")
    triplet = {
        "preprocess": {"dataset": "TrainerSmoke",
                       "path": {"data_path": "", "lexicon_path": "",
                                "preprocessed_path": pre},
                       "preprocessing": {"val_size": TRAINER_UTTS["val"]}},
        "model": {"max_seq_len": 1000,
                  "tpu": {"duration_extraction": "intended",
                          "duration_head_reduce": "first"}},
        "train": {"path": {k: os.path.join(out_dir, k.split("_")[0])
                           for k in ("ckpt_path", "log_path",
                                     "result_path")},
                  "optimizer": {"batch_size": TRAIN_B},
                  "step": TRAINER_STEP,
                  "tpu": {"text_buckets": [TRAIN_L],
                          "mel_buckets": [TRAIN_T],
                          "profile_start_step": TRAINER_PROFILE[0],
                          "profile_num_steps": TRAINER_PROFILE[1],
                          "vocoder_ckpt": vocoder}}}
    paths = []
    for name, d in triplet.items():
        paths.append(os.path.join(TRAINER_DIR, f"{name}.yaml"))
        with open(paths[-1], "w") as f:
            f.write(yaml_text(d) + "\n")
    cfg = Config.from_yaml_triplet(*paths)
    if cfg.model != ModelConfig(duration_extraction="intended",
                                duration_head_reduce="first"):
        raise AssertionError(f"model config {cfg.model}")
    ds = AcousticDataset("train.txt", cfg.preprocess)
    for i in range(len(ds)):
        if not np.array_equal(ds.text_ids(i), ids[i, :lens[i]]):
            raise AssertionError(f"{ds.rows[i][0]}: phone string does not "
                                 "map back to its ids")
    state = create_train_state(committed_flagship(cfg.model),
                               cfg.train.optimizer, "cpu")
    if not CheckpointManager(cfg.train.ckpt_path).save(state):
        raise AssertionError("the step-0 checkpoint was not written")
    return paths


def forwards_in(first, last, val_batches):
    """The flagship forwards of the fit loop from step ``first`` to
    ``last``: one a train step, each validation's batches and its sample,
    each train sample."""
    steps = range(first + 1, last + 1)
    evals = sum(s % TRAINER_STEP["val_step"] == 0 for s in steps)
    samples = sum(s % TRAINER_STEP["synth_step"] == 0 for s in steps)
    return len(steps) + evals * (val_batches + 1) + samples


def vocoded_in(first, last):
    """HiFi-GAN V1 forwards of the fit loop from step ``first`` to
    ``last``: each sample (of every validation and every train sample)
    vocodes the reconstruction and the ground truth."""
    steps = range(first + 1, last + 1)
    return 2 * sum((s % TRAINER_STEP["val_step"] == 0)
                   + (s % TRAINER_STEP["synth_step"] == 0) for s in steps)


def read_events(log_dir):
    """Every record of the event files under ``log_dir``, both CRCs
    checked, decoded to (step, tag, kind) for each summary value (kind
    "scalar", "image" or "audio")."""
    import struct

    from smart_nar_fast_tts_tpu_torch.training.logging import masked_crc32c

    def fields(buf):
        pos = 0
        while pos < len(buf):
            key, pos = varint(buf, pos)
            field, wire = key >> 3, key & 7
            if wire == 0:
                value, pos = varint(buf, pos)
            elif wire == 1:
                value, pos = buf[pos:pos + 8], pos + 8
            elif wire == 5:
                value, pos = buf[pos:pos + 4], pos + 4
            elif wire == 2:
                n, pos = varint(buf, pos)
                value, pos = buf[pos:pos + n], pos + n
            else:
                raise AssertionError(f"wire type {wire}")
            yield field, value

    def varint(buf, pos):
        out = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return out, pos

    kinds = {2: "scalar", 4: "image", 6: "audio"}
    values, n_records = [], 0
    for name in sorted(os.listdir(log_dir)):
        if not name.startswith("events.out.tfevents."):
            continue
        with open(os.path.join(log_dir, name), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            header = data[pos:pos + 8]
            (n,) = struct.unpack("<Q", header)
            body = data[pos + 12:pos + 12 + n]
            crcs = struct.unpack("<II", data[pos + 8:pos + 12]
                                 + data[pos + 12 + n:pos + 16 + n])
            if crcs != (masked_crc32c(header), masked_crc32c(body)):
                raise AssertionError(f"{name}: a record's CRC fails")
            pos += 16 + n
            n_records += 1
            event = dict(fields(body))
            for _, value_bytes in fields(event.get(5, b"")):
                value = dict(fields(value_bytes))
                kind = next(kinds[k] for k in kinds if k in value)
                values.append((event.get(2, 0), value[1].decode(), kind))
    return values, n_records


def trainer_cli_phase(torch, np, kernels, synth, inv, step_ms, cli):
    """The training CLIs on the flagship training shape: ``cli.train``
    for TRAINER_STEP's 6 steps over 3 epochs from a step-0 checkpoint of
    the committed flagship, then resumed to step 8, then ``cli.evaluate``
    of step 8; each with the launch counts set to 0 just before and read
    just after.  The samples' audio is the cli phase's HiFi-GAN V1.
    Returns (the launches of each run, the evaluation's losses, the
    triplet's arguments)."""
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.cli import evaluate as evaluate_cli
    from smart_nar_fast_tts_tpu_torch.cli import train as train_cli
    from smart_nar_fast_tts_tpu_torch.training import (CheckpointManager,
                                                       Trainer)
    with Phase("trainer setup") as f:
        paths = trainer_workspace(torch, np, synth, inv, cli["vocoder"])
        f.update(configs=paths, utterances=TRAINER_UTTS)
    argv = ["-p", paths[0], "-m", paths[1], "-t", paths[2]]
    total = TRAINER_STEP["total_step"]
    with Phase("trainer cli") as f:
        fit = Trainer.fit
        fit_seconds = []

        def timed_fit(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = fit(self, *args, **kwargs)
            torch.cuda.synchronize()
            fit_seconds.append(time.perf_counter() - t0)
            return out

        runs = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(Trainer, "fit", timed_fit):
            for name, extra in (("fit", []), ("resume", [
                    "--total_step", str(TRAINER_RESUME_TOTAL)])):
                kernels.reset_launches()
                t0 = time.perf_counter()
                trainer = train_cli.main(argv + extra)
                torch.cuda.synchronize()
                runs[name] = dict(launches={**kernels.launches(),
                                            **kernels.route_launches()},
                                  wall_seconds=time.perf_counter() - t0,
                                  fit_seconds=fit_seconds[-1])
        peak = torch.cuda.max_memory_allocated() / 2**30
        kernels.reset_launches()
        losses = evaluate_cli.main(argv + ["--restore_step",
                                           str(TRAINER_RESUME_TOTAL)])
        torch.cuda.synchronize()
        runs["evaluate"] = dict(launches={**kernels.launches(),
                                          **kernels.route_launches()})
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"val losses {losses}")

        cfg = trainer.cfg
        val = trainer.make_batcher("val.txt", pad_short="mask")
        val_batches = len(list(val.batches(0)))
        train = trainer.make_batcher("train.txt")
        per_epoch = train.steps_per_epoch()
        frames = sum(int(b.mel_lens.sum()) for e in range(total // per_epoch)
                     for b, _, _ in train.batches(e))
        plan = {"fit": (forwards_in(0, total, val_batches),
                        vocoded_in(0, total)),
                "resume": (forwards_in(total, TRAINER_RESUME_TOTAL,
                                       val_batches),
                           vocoded_in(total, TRAINER_RESUME_TOTAL)),
                "evaluate": (val_batches, 0)}
        for name, (n_forwards, n_vocoded) in plan.items():
            want = {k: 0 for k in kernels.route_launches()}
            want.update({k: v * n_forwards for k, v in PER_FORWARD.items()})
            want["hifigan_resblock_conv"] = RB_V1_LAUNCHES * n_vocoded
            if runs[name]["launches"] != want:
                raise AssertionError(f"trainer {name} launches "
                                     f"{runs[name]['launches']}, expected "
                                     f"{want}")
        mngr = CheckpointManager(cfg.train.ckpt_path)
        saved = mngr.all_steps()
        if saved != [0, 3, 6, 8]:
            raise AssertionError(f"checkpoints {saved}")
        positions = {}
        for step in (6, 8):
            with open(os.path.join(cfg.train.ckpt_path, str(step),
                                   "data.json")) as fh:
                positions[step] = json.load(fh)
        # step 6 ends epoch 2; the resumed run trains epoch 3 from its start
        if positions != {6: {"epoch": 2, "in_epoch": 2},
                         8: {"epoch": 3, "in_epoch": 2}}:
            raise AssertionError(f"data positions {positions}")
        logs = {}
        for writer in ("train", "val"):
            with open(os.path.join(cfg.train.log_path, writer,
                                   "log.txt")) as fh:
                logs[writer] = [line.split(",")[0] for line in fh]
        if logs != {"train": ["Step 2/6", "Step 4/6", "Step 6/6",
                              "Step 8/8"],
                    "val": ["Validation Step 3", "Validation Step 6"]}:
            raise AssertionError(f"log.txt {logs}")
        counts, records = {}, {}
        for writer in ("train", "val"):
            values, records[writer] = read_events(
                os.path.join(cfg.train.log_path, writer))
            for step, tag, kind in values:
                key = f"{writer} {tag.split('/')[0]} {kind}"
                counts[key] = counts.get(key, 0) + 1
        # losses at every log step (2, 4, 6, 8) and validation (3, 6); the
        # rates from the second update of each run on; a figure and two
        # clips for each sample: the train one at 6, the val ones at 3, 6
        want = {"train Loss scalar": 7 * 4, "train Perf scalar": 2 * 4,
                "train Training image": 1, "train Training audio": 2,
                "val Loss scalar": 7 * 2, "val Training image": 2,
                "val Training audio": 4}
        if counts != want:
            raise AssertionError(f"event values {counts}, expected {want}")
        start, n = TRAINER_PROFILE
        trace = os.path.join(cfg.train.log_path, "profile",
                             f"trace_steps_{start + 1}-{start + n}.json")
        if not (os.path.isfile(trace) and os.path.getsize(trace) > 0):
            raise AssertionError(f"no profiler trace {trace}")
        with open(trace) as fh:
            kernel_events = sum(e.get("cat") == "kernel"
                                for e in json.load(fh)["traceEvents"])
        fit_s = runs["fit"]["fit_seconds"]
        f.update(runs=runs, checkpoints=saved, data_positions=positions,
                 log_txt=logs, event_values=counts, event_records=records,
                 profile_trace=os.path.relpath(trace, REPO),
                 profile_kernel_events=kernel_events,
                 val_losses=dict(losses._asdict()),
                 fit_ms_per_step=fit_s / total * 1e3,
                 cli_wall_ms_per_step=runs["fit"]["wall_seconds"] / total
                 * 1e3,
                 mel_frames_trained=frames,
                 mel_frames_per_second=frames / fit_s,
                 train_phase_step_ms=step_ms,
                 host_share=1.0 - total * step_ms / 1e3 / fit_s,
                 peak_mem_gib=peak, nvidia_smi=nvidia_smi())
    return runs, losses, argv


def trainer_reference_phase(torch, kernels, losses, argv):
    """``cli.evaluate`` of the same step-8 checkpoint on the card and on the
    CPU (the plain versions): each of the 7 val loss terms within
    TRAIN_RTOL of the card's.  The duration targets are the last alignment
    layer's head-0 argmax, which the card's 3xTF32 kernel and the CPU's f32
    plain version may settle apart at a float64 near-tie; each frame moved
    moves the duration, pitch and energy terms by ~2e-5.  So the card's run
    records each alignment launch, the plain version on the launch's own
    inputs must pick the kernel's key at every frame but near-ties
    (:func:`argmax_ties`), and the CPU's run takes the card's argmax in
    place of its own (its out and guided numerator its own).  The frames
    where the CPU's own argmax differs are reported."""
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.cli import evaluate as evaluate_cli
    from smart_nar_fast_tts_tpu_torch.models import layers
    wrapper = layers.alignment_attention
    restore = argv + ["--restore_step", str(TRAINER_RESUME_TOTAL)]
    with Phase("trainer reference") as f:
        launches = []

        def record(*args):
            res = wrapper(*args)
            launches.append(([a.cpu() if torch.is_tensor(a) else a
                              for a in args], res[1].cpu()))
            return res
        with mock.patch.object(layers, "alignment_attention", record):
            card = evaluate_cli.main(restore)
        torch.cuda.synchronize()
        ties = []
        for args, idx in launches:
            ties += argmax_ties(torch, args,
                                idx, kernels.alignment_reference(*args)[1])
        card_idx = iter(idx for _, idx in launches)
        own_differ = []

        def substitute(*args):
            out, idx, gnum = wrapper(*args)
            given = next(card_idx)
            own_differ.append(int((idx != given).sum()))
            return out, given, gnum
        with mock.patch.object(layers, "alignment_attention", substitute):
            cpu = evaluate_cli.main(restore + ["--device", "cpu"])
        if len(own_differ) != len(launches):
            raise AssertionError(f"{len(launches)} alignment launches on "
                                 f"the card, {len(own_differ)} on the CPU")
        rel = {k: abs(getattr(card, k) - v) / abs(v)
               for k, v in cpu._asdict().items()}
        f.update(card=dict(card._asdict()), cpu=dict(cpu._asdict()),
                 card_equals_trainer_cli_run=card == losses,
                 relative_err=rel, rtol=TRAIN_RTOL,
                 alignment_launches=len(launches),
                 kernel_vs_plain_argmax_differing=len(ties),
                 argmax_ties=ties[:8],
                 cpu_own_argmax_differing=own_differ)
        far = [t for t in ties if not t["near_tie"]]
        if far:
            raise AssertionError(f"{len(far)} argmax picks of the alignment "
                                 f"kernel are no float64 near-tie: {far[:3]}")
        bad = {k: e for k, e in rel.items() if not e <= TRAIN_RTOL}
        if bad:
            raise AssertionError(f"val losses card vs CPU beyond rtol "
                                 f"{TRAIN_RTOL}: {bad}")


def train_vocoder_cli_phase(torch, np, kernels, synth, short, wav, mel_lens,
                            cli, gan_step_ms):
    """``cli.train_vocoder`` on the e2e phase's 8 waveforms (22,050 Hz
    wavs), warm-started from the cli phase's HiFi-GAN V1 torch checkpoint:
    4 GAN steps of B 16 × 8192 samples, with the launch counts set to 0
    just before and read just after; its checkpoint then vocodes the e2e
    mel through ``load_vocoder`` and through the synthesize CLI's
    ``--vocoder_ckpt``."""
    import contextlib
    import io
    import re
    import shutil

    from smart_nar_fast_tts_tpu_torch.cli import synthesize
    from smart_nar_fast_tts_tpu_torch.cli import train_vocoder
    from smart_nar_fast_tts_tpu_torch.data import save_wav
    from smart_nar_fast_tts_tpu_torch.vocoder import load_vocoder
    with Phase("train_vocoder cli") as f:
        shutil.rmtree(VOC_CLI_DIR, ignore_errors=True)
        wav_dir = os.path.join(VOC_CLI_DIR, "wavs")
        out_dir = os.path.join(VOC_CLI_DIR, "out")
        os.makedirs(wav_dir)
        for i in range(wav.shape[0]):
            n = int(mel_lens[i]) * synth.hop_length
            save_wav(os.path.join(wav_dir, f"e2e{i}.wav"),
                     wav[i, :n].float().cpu().numpy(), synth.sampling_rate)
        argv = ["--wav_dir", wav_dir, "--steps", str(VOC_CLI_STEPS),
                "--batch_size", str(VOC_B), "--segment_size", str(VOC_SEG),
                "--restore_generator", cli["vocoder"], "--save_every", "2",
                "--log_every", "2", "--out_dir", out_dir]
        printed = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            train_vocoder.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**kernels.launches(), **kernels.route_launches()}
        want = {k: 0 for k in counts}
        for k in ("fused_log_mel", "hifigan_resblock_conv"):
            want[k] = PER_GAN_STEP[k] * VOC_CLI_STEPS
        if counts != want:
            raise AssertionError(f"train_vocoder launches {counts}, "
                                 f"expected {want}")
        files = sorted(os.listdir(out_dir))
        if files != ["config.json", "generator_2.pth.tar",
                     "generator_4.pth.tar", "meta.json"]:
            raise AssertionError(f"train_vocoder wrote {files}")
        with open(os.path.join(out_dir, "meta.json")) as fh:
            meta = json.load(fh)
        if meta["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"meta.json device {meta['device']}")
        ckpt = os.path.join(out_dir, "generator_4.pth.tar")
        gen = load_vocoder(ckpt).cuda()
        n = int(mel_lens[0])
        with torch.inference_mode():
            voiced = gen(short.postnet_mel[:1, :n].float())
        if voiced.shape != (1, n * synth.hop_length) or not torch.isfinite(
                voiced).all():
            raise AssertionError("the trained generator's waveform is not "
                                 "finite or has the wrong shape")
        paths, step = cli["configs"], cli["step"]
        utts = synthesize.main(["-p", paths[0], "-m", paths[1], "-t",
                                paths[2], "--restore_step", str(step),
                                "--text", CLI_TEXT, "--vocoder_ckpt", ckpt])
        if not (os.path.getsize(utts[0].base + ".wav") > 44
                and np.isfinite(utts[0].wav).all()):
            raise AssertionError("synthesize --vocoder_ckpt wrote no audio")
        lines = printed.getvalue().splitlines()
        rates = [float(r) for r in re.findall(r"\(([\d.]+) steps/s\)",
                                              printed.getvalue())]
        f.update(launches=counts, wall_seconds=wall,
                 gan_steps_per_second_cli=VOC_CLI_STEPS / wall,
                 printed_steps_per_second=rates,
                 gan_step_ms_vocoder_train_phase=gan_step_ms,
                 printed=lines, meta=meta,
                 waveform_samples=int(voiced.shape[1]),
                 synthesize_wav=os.path.relpath(utts[0].base + ".wav", REPO),
                 nvidia_smi=nvidia_smi())
    return counts


# the streaming vocoder (vocoder/streaming.py): windows of STREAM_CHUNK + 2
# halo frames over item 0 of the e2e mel; the online mode fed in pieces of
# STREAM_PIECE frames; the synthesize CLI's --stream_chunk on sentence (a)
STREAM_CHUNK, STREAM_PIECE = 64, 37
STREAM_TOL = 1e-4   # chunks against the full forward on the card: f32, no
                    # TF32, but cuDNN may pick another algorithm per shape
# the bf16 compute policy (ModelConfig.compute_dtype, HiFiGANConfig's):
# stage A of bench.py's inputs at caps 1000 and 4096 against the f32 run
# The postnet mel under bf16 is reported, not held: the JAX package's bar
# (0.25 against f32, tests/test_properties.py::TestBF16ComputePath) is set
# on a random init, whose attention logits are small; the committed
# flagship's reach 1e3 (tests/test_torch_model.py::
# test_flagship_attention_logits_outrun_bf16), where bf16 q and k move them
# by units and reorder the softmax, so any two bf16 runs (JAX's too) part
# by units of mel.  Held: durations within one frame, the bf16 vocoder,
# the flash kernel's outputs on their own inputs.
BF16_DURATION_TOL = 1
BF16_WAV_REL = 0.08  # vocoder mean relative error, bf16 against f32 on one
                     # mel (tests/test_vocoder.py::test_bfloat16_compute_path)
# HiFi-GAN V3 (upstream config_v3.json): ResBlock2, rates 8, 8, 4
V3_CONFIG = dict(resblock="2", upsample_rates=(8, 8, 4),
                 upsample_kernel_sizes=(16, 16, 8),
                 upsample_initial_channel=256,
                 resblock_kernel_sizes=(3, 5, 7),
                 resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))
V3_SEED = 0
V3_TOL = 1e-4       # the V3 generator on the card against the CPU, f32
# exported serving artifacts (cli.export, serving.ExportedTTS) of the cli
# phase's checkpoint: text buckets that hold sentence (a) and passage (b)
EXPORT_DIR = os.path.join(REPO, "build", "export_smoke")
EXPORT_TEXT_BUCKETS = (64, 384)
EXPORT_MEL_CAPS = (1000, 4096)
EXPORT_MEL_TOL = 1e-3     # the exported programs against the live model
EXPORT_STREAM_TOL = 1e-4  # stream against synthesize (two window shapes)
EXPORT_SHARE = 0.05       # program files against params.npz: weights as data


def launch_counts(kernels):
    """Every kernel's launch count, the further kernels' included."""
    return {**kernels.launches(), **kernels.route_launches()}


def main_counts(counts):
    """The five wrappers' counts of :func:`launch_counts`."""
    return {k: counts[k] for k in PER_SERVING_BATCH}


def first_chunk_ms(torch, chunks):
    """Milliseconds to the first chunk of the iterator ``chunks()``: CUDA
    events around it and a synchronise (the chunk is on the host by
    then)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    first = next(iter(chunks()))
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), first


def streaming_phase(torch, np, kernels, synth, short, cli):
    """The streaming vocoder on the committed HiFi-GAN V1 over item 0 of the
    e2e mel: the chunks against the full forward, the online mode in pieces
    of 37 frames, time to first audio; then ``cli.synthesize
    --stream_chunk 64`` on sentence (a) against run (a)'s waveform."""
    from smart_nar_fast_tts_tpu_torch.cli import synthesize
    from smart_nar_fast_tts_tpu_torch.vocoder import StreamingVocoder
    with Phase("streaming") as f:
        n = int(short.mel_lens[0])
        mel = short.postnet_mel[0, :n].float().cpu().numpy()
        sv = StreamingVocoder(synth.vocoder, chunk_frames=STREAM_CHUNK)
        kernels.reset_launches()
        chunks = list(sv.synthesize_chunks(mel))
        torch.cuda.synchronize()
        counts = launch_counts(kernels)
        if counts["hifigan_resblock_conv"] != RB_V1_LAUNCHES * len(chunks):
            raise AssertionError(f"streaming: launches {counts} for "
                                 f"{len(chunks)} windows")
        with torch.inference_mode():
            full = synth.vocoder(torch.from_numpy(mel[None]).to(
                synth.device))[0].cpu().numpy()
        got = np.concatenate(chunks)
        if got.shape != full.shape or len(chunks) != -(-n // STREAM_CHUNK):
            raise AssertionError(f"streaming: {len(chunks)} chunks, "
                                 f"{got.shape} against {full.shape}")
        err = float(np.abs(got - full).max())
        if not err <= STREAM_TOL:
            raise AssertionError(f"streaming: chunks {err} from the full "
                                 f"forward, over {STREAM_TOL}")
        online = np.concatenate(list(sv.stream(
            mel[i:i + STREAM_PIECE] for i in range(0, n, STREAM_PIECE))))
        online_err = float(np.abs(online - full).max())
        if online.shape != full.shape or not online_err <= STREAM_TOL:
            raise AssertionError(f"online stream: {online_err} from the "
                                 "full forward")
        # both f32 runs against a float64 one: the window shapes' own
        # rounding (the halo itself is exact in float64)
        with torch.inference_mode():
            f64 = copy.deepcopy(synth.vocoder).double()(
                torch.from_numpy(mel[None]).double().to(synth.device))[0]
        f64 = f64.cpu().numpy()
        ttfa = [first_chunk_ms(torch, lambda: sv.synthesize_chunks(mel))[0]
                for _ in range(5)]
        window = torch.from_numpy(mel[None, :sv.window_frames]).to(
            synth.device)
        with torch.inference_mode():
            window_ms = device_ms(lambda: synth.vocoder(window), torch)
            full_ms = wall_ms(lambda: synth.vocoder(
                torch.from_numpy(mel[None]).to(synth.device)), torch)
        f.update(launches=counts, frames=n, chunk_frames=STREAM_CHUNK,
                 halo_frames=sv.halo, window_frames=sv.window_frames,
                 chunks=len(chunks), max_abs_err=err,
                 online_piece_frames=STREAM_PIECE,
                 online_max_abs_err=online_err,
                 online_vs_chunks_max=float(np.abs(online - got).max()),
                 full_vs_float64_max=float(np.abs(full - f64).max()),
                 chunks_vs_float64_max=float(np.abs(got - f64).max()),
                 buffered_frames_high_water=sv.buffered_frames_high_water,
                 time_to_first_audio_ms=statistics.median(ttfa),
                 time_to_first_audio_ms_runs=ttfa,
                 window_device_ms=window_ms, full_forward_ms=full_ms,
                 nvidia_smi=nvidia_smi())
    with Phase("streaming cli") as f:
        argv = ["-p", cli["configs"][0], "-m", cli["configs"][1],
                "-t", cli["configs"][2], "--restore_step", str(cli["step"]),
                "--vocoder_ckpt", cli["vocoder"], "--text", CLI_TEXT,
                "--speaker_id", str(CLI_SPEAKER),
                "--stream_chunk", str(STREAM_CHUNK)]
        utts, cli_counts, wall, seconds = cli_run(torch, np, kernels,
                                                  synthesize, argv)
        wav, ref = utts[0].wav, cli["text_wav"]
        # both scaled by max_wav_value (32768): compared at full scale 1
        cli_err = float(np.abs(wav - ref).max()) / 32768.0 \
            if wav.shape == ref.shape else float("inf")
        if not cli_err <= STREAM_TOL:
            raise AssertionError(f"--stream_chunk: wav {cli_err} from run "
                                 f"(a)'s, over {STREAM_TOL}")
        windows = -(-utts[0].mel_len // STREAM_CHUNK)
        if cli_counts["flash_attention"] or cli_counts[
                "gaussian_upsample_banded"] != 1 or cli_counts[
                "hifigan_resblock_conv"] != RB_V1_LAUNCHES * windows:
            raise AssertionError(f"--stream_chunk launches {cli_counts} for "
                                 f"{windows} windows")
        f.update(launches=cli_counts, wall_seconds=wall,
                 audio_seconds=seconds, max_abs_err_vs_run_a=cli_err)
    return counts, {"cli": cli_counts}


def bf16_serving_phase(torch, np, kernels, synth, short, wav, texts,
                       src_lens):
    """The committed flagship and HiFi-GAN V1 under
    ``compute_dtype="bfloat16"`` on bench.py's inputs: stage A at cap 1000
    and at cap 4096 (the decoder's four flash launches on bf16 operands,
    each held to ``attention_bf16_reference`` of its own inputs), each with
    the launch counts set to 0 just before and read just after; against
    the f32 run: durations within one frame, the bf16 vocoder on the f32
    mel within 0.08 mean relative error, the postnet mel's distance over
    the frames both hold reported; the card's bf16 stage A against the
    CPU's on two items; stage times in turns with the f32 ones."""
    import dataclasses
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.config import ModelConfig
    from smart_nar_fast_tts_tpu_torch.models import layers
    from smart_nar_fast_tts_tpu_torch.serving import (Synthesizer, bucket,
                                                      committed_flagship)
    from smart_nar_fast_tts_tpu_torch.vocoder import HiFiGANGenerator
    bf16 = torch.bfloat16

    def bf16_models():
        model = committed_flagship(ModelConfig(compute_dtype="bfloat16"))
        vocoder = HiFiGANGenerator(dataclasses.replace(
            synth.vocoder.config, compute_dtype="bfloat16"))
        vocoder.load_state_dict(synth.vocoder.state_dict())
        return model, vocoder

    def common_mel_err(a, b):
        n = torch.minimum(a.mel_lens.cpu(), b.mel_lens.cpu())
        return max(float((a.postnet_mel[j, :n[j]].float().cpu()
                          - b.postnet_mel[j, :n[j]].float().cpu()).abs()
                         .max()) for j in range(len(n)))

    tx, sl = torch.from_numpy(texts), torch.from_numpy(src_lens)
    with Phase("bf16 serving") as f:
        model, vocoder = bf16_models()
        synth16 = Synthesizer(model, vocoder)
        kernels.reset_launches()
        wav16, lens16 = synth16.synthesize(texts, src_lens)
        torch.cuda.synchronize()
        counts = launch_counts(kernels)
        # the bf16 generator runs the module chain
        if main_counts(counts) != dict(PER_SERVING_BATCH,
                                       hifigan_resblock_conv=0):
            raise AssertionError(f"bf16 serving launches {counts}")
        out = synth16.stage_a(tx, sl)
        if out.postnet_mel.dtype != torch.float32 or not torch.isfinite(
                out.postnet_mel).all() or not torch.isfinite(wav16).all():
            raise AssertionError("bf16 serving: not f32 or non-finite")
        d_err = int((out.duration_rounded - short.duration_rounded).abs()
                    .max())
        mel_err = common_mel_err(out, short)
        mel_mean = float((out.postnet_mel - short.postnet_mel).abs().mean())
        cap = bucket(int(short.mel_lens.max()))
        mel32 = short.postnet_mel[:, :cap].contiguous()
        with torch.inference_mode():
            w16 = synth16.stage_b(mel32)
            w32 = synth.stage_b(mel32)
        wav_rel = float((w16 - w32).abs().mean() / w32.abs().mean())
        e2e_rel = (float((wav16 - wav).abs().mean() / wav.abs().mean())
                   if wav16.shape == wav.shape else None)
        f.update(launches=counts, mel_lens=out.mel_lens.tolist(),
                 mel_lens_f32=short.mel_lens.tolist(),
                 duration_max_diff=d_err, postnet_mel_vs_f32_max=mel_err,
                 postnet_mel_vs_f32_mean=mel_mean,
                 vocoder_vs_f32_mean_rel=wav_rel,
                 e2e_wav_vs_f32_mean_rel=e2e_rel)
        if d_err > BF16_DURATION_TOL:
            raise AssertionError(f"bf16 stage A against f32: durations "
                                 f"{d_err} frames apart")
        if wav16.dtype != torch.float32 or not wav_rel < BF16_WAV_REL:
            raise AssertionError(f"bf16 vocoder: mean relative {wav_rel}")
        # the card against the CPU, both bf16, on two items
        cpu = Synthesizer(*bf16_models(), device="cpu")
        got = synth16.stage_a(tx[:2], sl[:2])
        expect = cpu.stage_a(tx[:2], sl[:2])
        cpu_err = common_mel_err(got, expect)
        cpu_d = int((got.duration_rounded.cpu() - expect.duration_rounded)
                    .abs().max())
        f.update(card_vs_cpu_postnet_mel_max=cpu_err,
                 card_vs_cpu_duration_max_diff=cpu_d)
        if cpu_d > BF16_DURATION_TOL or not torch.isfinite(
                got.postnet_mel).all():
            raise AssertionError(f"bf16 card against CPU: durations "
                                 f"{cpu_d} frames apart")
        mel16 = out.postnet_mel[:, :cap].contiguous()
        times = {}
        for name, s, m in (("f32", synth, mel32), ("bf16", synth16, mel16),
                           ("bf16 again", synth16, mel16),
                           ("f32 again", synth, mel32)):
            times[name] = dict(
                stage_a_ms=wall_ms(lambda s=s: s.stage_a(tx, sl), torch),
                stage_b_ms=wall_ms(lambda s=s, m=m: s.stage_b(m), torch))
        f.update(times=times, nvidia_smi=nvidia_smi())
    with Phase("bf16 serving cap 4096") as f:
        long16 = Synthesizer(model, vocoder, t_cap=T_CAP_LONG)
        calls, flash = [], layers.flash_attention

        def spy(q, k, v, key_valid):
            o = flash(q, k, v, key_valid)
            calls.append((q, k, v, key_valid, o))
            return o

        kernels.reset_launches()
        with mock.patch.object(layers, "flash_attention", spy):
            lout = long16.stage_a(tx, sl)
        torch.cuda.synchronize()
        long_counts = launch_counts(kernels)
        if main_counts(long_counts) != PER_SERVING_BATCH_LONG or any(
                c[0].dtype != bf16 for c in calls):
            raise AssertionError(f"bf16 cap-4096 launches {long_counts}, "
                                 f"dtypes {[c[0].dtype for c in calls]}")
        if not torch.equal(lout.duration_rounded, out.duration_rounded):
            raise AssertionError("bf16 cap-4096 durations differ from cap "
                                 "1000")
        shares = []
        for q, k, v, valid, o in calls:
            ref = kernels.attention_bf16_reference(q, k, v, valid)
            tol = kernels.attention_bf16_tolerance(q, k, v, valid, ref)
            shares.append(((o.float() - ref.float()).abs() / tol).max()
                          .item())
        if not max(shares) <= 1.0:
            raise AssertionError(f"bf16 cap-4096 flash outputs beyond "
                                 f"attention_bf16_tolerance: {shares}")
        f32_long = Synthesizer(synth.model, synth.vocoder, t_cap=T_CAP_LONG)
        f.update(launches=long_counts,
                 flash_shapes=[list(c[0].shape) for c in calls],
                 flash_dtype=str(calls[0][0].dtype),
                 flash_bf16_tolerance_share=shares,
                 mel_lens=lout.mel_lens.tolist(),
                 stage_a_ms=wall_ms(lambda: long16.stage_a(tx, sl), torch),
                 stage_a_ms_f32=wall_ms(lambda: f32_long.stage_a(tx, sl),
                                        torch))
    return counts, long_counts


def v3_phase(torch, np, kernels, short):
    """A seeded HiFi-GAN V3 generator (ResBlock2, upstream V3 widths) on
    item 0 of the e2e mel, the card against the CPU."""
    from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                      HiFiGANGenerator)
    with Phase("hifigan v3") as f:
        torch.manual_seed(V3_SEED)
        gen = HiFiGANGenerator(HiFiGANConfig(**V3_CONFIG)).eval()
        n = int(short.mel_lens[0])
        mel = short.postnet_mel[:1, :n].float().cpu()
        with torch.inference_mode():
            expect = gen(mel)
            gen.cuda()
            kernels.reset_launches()
            got = gen(mel.cuda())
            torch.cuda.synchronize()
            counts = launch_counts(kernels)
            ms = wall_ms(lambda: gen(mel.cuda()), torch)
        if got.shape != (1, n * gen.config.hop_length):
            raise AssertionError(f"V3 wav shape {tuple(got.shape)}")
        if counts["hifigan_resblock_conv"] != RB_V3_LAUNCHES:
            raise AssertionError(f"V3 launches {counts}")
        err = check_close("HiFi-GAN V3", got.cpu(), expect, V3_TOL, torch)
        f.update(launches=counts, frames=n, hop=gen.config.hop_length,
                 parameters=sum(p.numel() for p in gen.parameters()),
                 max_abs_err=err, card_ms=ms,
                 max_abs_wav=float(got.abs().max()))
    return counts


def program_op_counts(tts):
    """{program: {kernel: calls in its graph}} of a loaded ExportedTTS."""
    ops = {"smart_tts.flash_attention": "flash_attention",
           "smart_tts.gaussian_upsample_banded": "gaussian_upsample_banded",
           "smart_tts.hifigan_resblock_conv": "hifigan_resblock_conv"}

    def count(module):
        out = dict.fromkeys(ops.values(), 0)
        for node in module.graph.nodes:
            for op, name in ops.items():
                out[name] += str(node.target).startswith(op)
        return out
    return {"probe": {p.bucket: count(p.call) for p in tts._probe},
            "acoustic": {(p.bucket, p.mel_cap): count(p.call)
                         for p in tts._acoustic},
            "vocoder": {p.bucket: count(p.call) for p in tts._vocoder}}


def export_phase(torch, np, kernels, cli):
    """``cli.export`` of the cli phase's checkpoint (the 8-speaker
    flagship) and HiFi-GAN V1 with text buckets 64 and 384 and frame
    capacities 1000 and 4096; then ``ExportedTTS`` on the card serves
    sentence (a) and passage (b) (336 phonemes: cap 4096, flash) with
    ``synthesize`` and ``stream``, the launch counts set to 0 just before
    and read just after each served call and held to the registered
    operators' calls in the programs run; durations exact and postnet mel
    within 1e-3 of the live model at the same capacity; ``stream`` equal
    to ``synthesize``; the program files under 5 % of ``params.npz``."""
    import argparse
    import shutil

    from smart_nar_fast_tts_tpu_torch.cli import export, synthesize
    from smart_nar_fast_tts_tpu_torch.cli._args import load_config
    from smart_nar_fast_tts_tpu_torch.serving import ExportedTTS
    from smart_nar_fast_tts_tpu_torch.text import text_to_sequence
    from smart_nar_fast_tts_tpu_torch.text.g2p import G2P
    with Phase("export cli") as f:
        shutil.rmtree(EXPORT_DIR, ignore_errors=True)
        os.makedirs(EXPORT_DIR)
        with open(cli["configs"][2]) as fh:
            text = fh.read()
        text = text.replace(
            "  text_buckets: [24]\n",
            f"  text_buckets: {list(EXPORT_TEXT_BUCKETS)}\n"
            f"  serving_mel_caps: {list(EXPORT_MEL_CAPS)}\n")
        train_yaml = os.path.join(EXPORT_DIR, "train.yaml")
        with open(train_yaml, "w") as fh:
            fh.write(text)
        paths = [cli["configs"][0], cli["configs"][1], train_yaml]
        cfg = load_config(argparse.Namespace(
            preprocess_config=paths[0], model_config=paths[1],
            train_config=paths[2]))
        if (tuple(cfg.train.text_buckets) != EXPORT_TEXT_BUCKETS
                or tuple(cfg.train.serving_mel_caps) != EXPORT_MEL_CAPS):
            raise AssertionError(f"export config: {cfg.train}")
        out_dir = os.path.join(EXPORT_DIR, "artifact")
        t0 = time.perf_counter()
        manifest = export.main(
            ["-p", paths[0], "-m", paths[1], "-t", paths[2],
             "--restore_step", str(cli["step"]), "--out_dir", out_dir,
             "--vocoder_ckpt", cli["vocoder"],
             "--stream_chunk", str(STREAM_CHUNK)])
        export_s = time.perf_counter() - t0
        sizes = {name: os.path.getsize(os.path.join(out_dir, name))
                 for name in os.listdir(out_dir)}
        params = sizes["params.npz"]
        programs = sum(v for k, v in sizes.items() if k.endswith(".pt2"))
        f.update(export_seconds=export_s, device=manifest["device"],
                 programs=sum(k.endswith(".pt2") for k in sizes),
                 artifact_mb=sum(sizes.values()) / 2**20,
                 params_mb=params / 2**20, programs_mb=programs / 2**20,
                 programs_share=programs / params, files=sizes)
        if not programs < EXPORT_SHARE * params:
            raise AssertionError(f"export: programs {programs} B against "
                                 f"params {params} B")
    with Phase("export serve") as f:
        t0 = time.perf_counter()
        tts = ExportedTTS(out_dir)           # on the card, as exported
        load_s = time.perf_counter() - t0
        if tts.device.type != manifest["device"]:
            raise AssertionError(f"served on {tts.device}, exported for "
                                 f"{manifest['device']}")
        ops = program_op_counts(tts)
        model, restored = synthesize.load_model(cfg, cli["step"],
                                                tts.device)
        g2p = G2P(cfg.preprocess.lexicon_path)
        served, counts_by_text = {}, {}
        for name, sentence in (("a", CLI_TEXT), ("b", CLI_LONG)):
            ids = np.asarray(text_to_sequence(
                g2p(sentence), list(cfg.preprocess.text_cleaners)), np.int64)
            kernels.reset_launches()
            wav = tts.synthesize(ids, speaker=CLI_SPEAKER)
            torch.cuda.synchronize()
            counts = launch_counts(kernels)
            out = tts.acoustic(ids, speaker=CLI_SPEAKER)
            L = next(b for b in EXPORT_TEXT_BUCKETS if len(ids) <= b)
            cap = out["postnet_mel"].shape[1]
            # the vocoder program of the first mel bucket past mel_len
            voc = next(b for b in sorted(ops["vocoder"])
                       if max(int(out["mel_lens"][0]), 1) <= b)
            expect = {k: ops["probe"][L][k] + ops["acoustic"][(L, cap)][k]
                      + ops["vocoder"][voc][k] for k in ops["probe"][L]}
            others = {k: v for k, v in counts.items() if k not in expect}
            if {k: counts[k] for k in expect} != expect or any(
                    others.values()):
                raise AssertionError(f"({name}) exported launches {counts}, "
                                     f"expected {expect}")
            texts = np.zeros((1, L), np.int64)
            texts[0, :len(ids)] = ids
            with torch.inference_mode():
                live = model(torch.from_numpy(texts).to(tts.device),
                             torch.tensor([len(ids)], device=tts.device),
                             max_mel_len=cap,
                             speakers=torch.tensor([CLI_SPEAKER],
                                                   device=tts.device))
            if not np.array_equal(out["duration_rounded"],
                                  live.duration_rounded.cpu().numpy()):
                raise AssertionError(f"({name}) exported durations differ "
                                     "from the live model")
            mel_err = float(np.abs(out["postnet_mel"]
                                   - live.postnet_mel.cpu().numpy()).max())
            if not mel_err <= EXPORT_MEL_TOL:
                raise AssertionError(f"({name}) exported postnet mel "
                                     f"{mel_err} from the live model")
            stream_ms, _ = first_chunk_ms(
                torch, lambda: tts.stream(ids, speaker=CLI_SPEAKER))
            chunks = list(tts.stream(ids, speaker=CLI_SPEAKER))
            streamed = np.concatenate(chunks)
            stream_err = float(np.abs(streamed - wav).max()) \
                if streamed.shape == wav.shape else float("inf")
            if not stream_err <= EXPORT_STREAM_TOL:
                raise AssertionError(f"({name}) stream {stream_err} from "
                                     "synthesize")
            if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
                    and wav.shape[0] == int(out["mel_lens"][0]) * tts.hop):
                raise AssertionError(f"({name}) exported wav: bad")
            served[name] = dict(
                phonemes=len(ids), text_bucket=L, cap=cap,
                mel_len=int(out["mel_lens"][0]), launches=counts,
                postnet_mel_vs_live_max=mel_err,
                stream_vs_synthesize_max=stream_err, chunks=len(chunks),
                time_to_first_audio_ms=stream_ms,
                synthesize_ms=wall_ms(lambda i=ids: tts.synthesize(
                    i, speaker=CLI_SPEAKER), torch, reps=3))
            counts_by_text[name] = counts
        if served["b"]["cap"] != EXPORT_MEL_CAPS[-1] or not counts_by_text[
                "b"]["flash_attention"]:
            raise AssertionError(f"(b) did not escalate to flash: {served}")
        f.update(load_seconds=load_s, restored=restored, served=served,
                 program_ops={k: {str(b): c for b, c in v.items()}
                              for k, v in ops.items()},
                 nvidia_smi=nvidia_smi())
    return counts_by_text


# the other vocoder families (vocoder/vocos.py, vocoder/melgan.py): the
# committed Vocos (13.46 M) and MelGAN (4.26 M) behind the committed
# flagship on bench.py's inputs; their streaming, GAN CLI runs and a Vocos
# export of the cli phase's checkpoint at one text bucket and cap 1000
FAMILIES = ("vocos", "melgan")
FAMILY_TOL = 1e-4       # item 0's waveform on the card against the CPU, f32
                        # both, no TF32
VOCOS_BF16_REL = 0.1    # bf16 Vocos against f32 on one mel, mean relative
                        # error (tests/test_vocos.py::test_bf16_close_to_f32)
VOCOS_EXPORT_DIR = os.path.join(REPO, "build", "export_vocos_smoke")
VOCOS_EXPORT_TOL = 1e-3   # the exported programs against the live models


def families_serving_phase(torch, np, kernels, texts, src_lens):
    """``Synthesizer.from_committed(family=...)`` for Vocos and MelGAN on
    bench.py's inputs (cap 1000), the launch counts set to 0 just before
    and read just after; stage A / B and RTF; item 0's waveform on the card
    against the port's CPU run on the same mel; for Vocos a bf16 stage B
    against the f32 one, timed in turns.  Returns ({family: counts},
    {family: (synthesizer, mel_lens, mel of the bucket)})."""
    import dataclasses

    from smart_nar_fast_tts_tpu_torch.serving import (Synthesizer, bucket,
                                                      committed_vocoder)
    from smart_nar_fast_tts_tpu_torch.vocoder import VocosGenerator
    counts_by, served = {}, {}
    tx, sl = torch.from_numpy(texts), torch.from_numpy(src_lens)
    for family in FAMILIES:
        with Phase(f"{family} serving") as f:
            t0 = time.perf_counter()
            synth = Synthesizer.from_committed(family=family)
            load_s = time.perf_counter() - t0
            kernels.reset_launches()
            wav, mel_lens = synth.synthesize(texts, src_lens)
            torch.cuda.synchronize()
            counts = launch_counts(kernels)
            if main_counts(counts) != dict(
                    PER_SERVING_BATCH, hifigan_resblock_conv=0) or any(
                    v for k, v in counts.items()
                    if k not in PER_SERVING_BATCH):
                raise AssertionError(f"{family} serving launches {counts}")
            cap = bucket(int(mel_lens.max()))
            hop = synth.hop_length
            if wav.shape != (B, cap * hop) or not torch.isfinite(wav).all():
                raise AssertionError(f"{family} wav {tuple(wav.shape)}, or "
                                     "non-finite")
            out = synth.stage_a(tx, sl)
            mel = out.postnet_mel[:, :cap].contiguous()
            stage_a_ms = wall_ms(lambda: synth.stage_a(tx, sl), torch)
            stage_b_ms = wall_ms(lambda: synth.stage_b(mel), torch)
            seconds = synth.audio_seconds(mel_lens)
            cpu = committed_vocoder(family=family).eval()
            with torch.inference_mode():
                expect = cpu(mel[:1].cpu())
                got = synth.stage_b(mel[:1])
            err = check_close(f"{family} item 0, card against CPU",
                              got.cpu(), expect, FAMILY_TOL, torch)
            f.update(launches=counts, load_seconds=load_s, bucket=cap,
                     hop=hop, mel_frames=int(mel_lens.sum()),
                     audio_seconds=seconds, stage_a_ms=stage_a_ms,
                     stage_b_ms=stage_b_ms,
                     rtf=(stage_a_ms + stage_b_ms) / 1e3 / seconds,
                     parameters=sum(p.numel()
                                    for p in synth.vocoder.parameters()),
                     card_vs_cpu_max_abs_err=err,
                     max_abs_wav=float(wav.abs().max()))
            if family == "vocos":
                v16 = VocosGenerator(dataclasses.replace(
                    synth.vocoder.config, compute_dtype="bfloat16"))
                v16.load_state_dict(synth.vocoder.state_dict())
                v16 = v16.to(synth.device).eval()
                with torch.inference_mode():
                    w32, w16 = synth.stage_b(mel), v16(mel)
                rel = float((w16 - w32).abs().mean() / w32.abs().mean())
                rel_l2 = float((w16 - w32).norm() / w32.norm())
                if w16.dtype != torch.float32 or not rel < VOCOS_BF16_REL:
                    raise AssertionError(f"bf16 Vocos: mean relative {rel}")
                times = {}
                with torch.inference_mode():
                    for name, gen in (("f32", synth.vocoder), ("bf16", v16),
                                      ("bf16 again", v16),
                                      ("f32 again", synth.vocoder)):
                        times[name] = wall_ms(lambda g=gen: g(mel), torch)
                f.update(bf16_vs_f32_mean_rel=rel, bf16_vs_f32_rel_l2=rel_l2,
                         stage_b_ms_in_turns=times)
            f.update(nvidia_smi=nvidia_smi())
        counts_by[family] = counts
        served[family] = (synth, mel_lens, mel)
    return counts_by, served


def families_streaming_phase(torch, np, kernels, served):
    """``StreamingVocoder`` (chunk 64) on the committed Vocos and MelGAN
    over item 0 of their serving mel: the chunks against the full forward,
    the time to first audio by CUDA events, the launch counts."""
    from smart_nar_fast_tts_tpu_torch.vocoder import StreamingVocoder
    out = {}
    with Phase("vocoder families streaming") as f:
        for family in FAMILIES:
            synth, mel_lens, bucket_mel = served[family]
            n = int(mel_lens[0])
            mel = bucket_mel[0, :n].float().cpu().numpy()
            sv = StreamingVocoder(synth.vocoder, chunk_frames=STREAM_CHUNK)
            kernels.reset_launches()
            chunks = list(sv.synthesize_chunks(mel))
            torch.cuda.synchronize()
            counts = launch_counts(kernels)
            if any(counts.values()):
                raise AssertionError(f"{family} streaming launches {counts}")
            with torch.inference_mode():
                full = synth.vocoder(torch.from_numpy(mel[None]).to(
                    synth.device))[0].cpu().numpy()
            got = np.concatenate(chunks)
            err = float(np.abs(got - full).max()) \
                if got.shape == full.shape else float("inf")
            if not err <= STREAM_TOL:
                raise AssertionError(f"{family} streaming: chunks {err} "
                                     "from the full forward")
            ttfa = [first_chunk_ms(torch,
                                   lambda: sv.synthesize_chunks(mel))[0]
                    for _ in range(5)]
            f[family] = dict(launches=counts, frames=n, halo_frames=sv.halo,
                             window_frames=sv.window_frames,
                             chunks=len(chunks), max_abs_err=err,
                             time_to_first_audio_ms=statistics.median(ttfa),
                             time_to_first_audio_ms_runs=ttfa)
            out[family] = counts
    return out


def train_vocoder_families_phase(torch, np, kernels, served, cli, segments):
    """``cli.train_vocoder --generator vocos|melgan`` at full width from
    the seed on the train_vocoder cli phase's wavs: 4 GAN steps of B 16 ×
    8192 samples each, with the launch counts set to 0 just before and
    read just after (``fused_log_mel`` 2 a step); the files written;
    ``load_vocoder`` of step 4 vocodes item 0 of the family's serving mel;
    ``cli.synthesize --vocoder_ckpt`` on it writes a wav.  Then 3 more GAN
    steps of the CLI's state on the GAN phase's segments, each timed by
    CUDA events and a synchronise (the CLI's own rate includes its saves
    and logs)."""
    import contextlib
    import io
    import re

    from smart_nar_fast_tts_tpu_torch.audio import MelSpectrogramConfig
    from smart_nar_fast_tts_tpu_torch.cli import synthesize
    from smart_nar_fast_tts_tpu_torch.cli import train_vocoder
    from smart_nar_fast_tts_tpu_torch.training import make_vocoder_train_step
    from smart_nar_fast_tts_tpu_torch.vocoder import load_vocoder
    out = {}
    for family in FAMILIES:
        with Phase(f"train_vocoder cli {family}") as f:
            out_dir = os.path.join(VOC_CLI_DIR, f"out_{family}")
            argv = ["--wav_dir", os.path.join(VOC_CLI_DIR, "wavs"),
                    "--generator", family, "--steps", str(VOC_CLI_STEPS),
                    "--batch_size", str(VOC_B), "--segment_size",
                    str(VOC_SEG), "--save_every", "2", "--log_every", "2",
                    "--out_dir", out_dir]
            printed = io.StringIO()
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                res = train_vocoder.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts(kernels)
            want = {k: 0 for k in counts}
            want["fused_log_mel"] = (PER_GAN_STEP["fused_log_mel"]
                                     * VOC_CLI_STEPS)
            if counts != want:
                raise AssertionError(f"train_vocoder {family} launches "
                                     f"{counts}, expected {want}")
            step = make_vocoder_train_step(MelSpectrogramConfig())
            step_ms = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step(res["state"], segments)
                end.record()
                torch.cuda.synchronize()
                step_ms.append(start.elapsed_time(end))
            files = sorted(os.listdir(out_dir))
            if files != ["config.json", "generator_2.pth.tar",
                         "generator_4.pth.tar", "meta.json"]:
                raise AssertionError(f"train_vocoder {family} wrote {files}")
            with open(os.path.join(out_dir, "config.json")) as fh:
                config = json.load(fh)
            if config.get("family") != family:
                raise AssertionError(f"config.json {config}")
            ckpt = os.path.join(out_dir, "generator_4.pth.tar")
            synth, mel_lens, mel = served[family]
            gen = load_vocoder(ckpt).to(synth.device)
            n = int(mel_lens[0])
            with torch.inference_mode():
                voiced = gen(mel[:1, :n].float())
            if voiced.shape != (1, n * gen.config.hop_length) or not \
                    torch.isfinite(voiced).all():
                raise AssertionError(f"the trained {family} generator's "
                                     "waveform is not finite or has the "
                                     "wrong shape")
            paths = cli["configs"]
            utts = synthesize.main(["-p", paths[0], "-m", paths[1], "-t",
                                    paths[2], "--restore_step",
                                    str(cli["step"]), "--text", CLI_TEXT,
                                    "--vocoder_ckpt", ckpt])
            if not (os.path.getsize(utts[0].base + ".wav") > 44
                    and np.isfinite(utts[0].wav).all()):
                raise AssertionError("synthesize --vocoder_ckpt wrote no "
                                     "audio")
            rates = [float(r) for r in re.findall(
                r"\(([\d.]+) steps/s\)", printed.getvalue())]
            f.update(launches=counts, wall_seconds=wall,
                     gan_steps_per_second_cli=VOC_CLI_STEPS / wall,
                     printed_steps_per_second=rates, gan_step_ms=step_ms,
                     gan_step_ms_median=statistics.median(step_ms),
                     printed=printed.getvalue().splitlines(),
                     parameters=sum(p.numel() for p in gen.parameters()),
                     waveform_samples=int(voiced.shape[1]),
                     synthesize_wav=os.path.relpath(utts[0].base + ".wav",
                                                    REPO),
                     nvidia_smi=nvidia_smi())
        out[family] = counts
    return out


def export_vocos_phase(torch, np, kernels, served, cli):
    """``export_serving_artifacts`` of the cli phase's checkpoint with the
    committed Vocos at text bucket 64 and cap 1000; ``ExportedTTS`` on the
    card serves sentence (a), the launch counts set to 0 just before and
    read just after and held to the registered operators' calls in the
    programs it ran; within 1e-3 of the live ``Synthesizer`` with Vocos
    (stage A at cap 1000, stage B on the zero-padded bucket mel)."""
    import argparse
    import shutil

    from smart_nar_fast_tts_tpu_torch.cli import synthesize
    from smart_nar_fast_tts_tpu_torch.cli._args import load_config
    from smart_nar_fast_tts_tpu_torch.serving import (
        ExportedTTS, Synthesizer, export_serving_artifacts)
    from smart_nar_fast_tts_tpu_torch.text import text_to_sequence
    from smart_nar_fast_tts_tpu_torch.text.g2p import G2P
    with Phase("export vocos") as f:
        shutil.rmtree(VOCOS_EXPORT_DIR, ignore_errors=True)
        paths = cli["configs"]
        cfg = load_config(argparse.Namespace(
            preprocess_config=paths[0], model_config=paths[1],
            train_config=paths[2]))
        device = served["vocos"][0].device
        model, _ = synthesize.load_model(cfg, cli["step"], device)
        vocos = served["vocos"][0].vocoder
        t0 = time.perf_counter()
        manifest = export_serving_artifacts(
            VOCOS_EXPORT_DIR, model, text_buckets=[64], mel_buckets=[T_CAP],
            mel_caps=[T_CAP], generator=vocos, stream_chunk=STREAM_CHUNK)
        export_s = time.perf_counter() - t0
        sizes = {name: os.path.getsize(os.path.join(VOCOS_EXPORT_DIR, name))
                 for name in os.listdir(VOCOS_EXPORT_DIR)}
        t0 = time.perf_counter()
        tts = ExportedTTS(VOCOS_EXPORT_DIR)
        load_s = time.perf_counter() - t0
        ops = program_op_counts(tts)
        g2p = G2P(cfg.preprocess.lexicon_path)
        ids = np.asarray(text_to_sequence(
            g2p(CLI_TEXT), list(cfg.preprocess.text_cleaners)), np.int64)
        kernels.reset_launches()
        wav = tts.synthesize(ids, speaker=CLI_SPEAKER)
        torch.cuda.synchronize()
        counts = launch_counts(kernels)
        expect = {k: ops["probe"][64][k] + ops["acoustic"][(64, T_CAP)][k]
                  for k in ops["probe"][64]}
        if {k: counts[k] for k in expect} != expect or any(
                v for k, v in counts.items() if k not in expect):
            raise AssertionError(f"exported Vocos launches {counts}, "
                                 f"expected {expect}")
        live = Synthesizer(model, vocos)
        texts = np.zeros((1, 64), np.int64)
        texts[0, :len(ids)] = ids
        with torch.inference_mode():
            out = live.model(torch.from_numpy(texts).to(device),
                             torch.tensor([len(ids)], device=device),
                             max_mel_len=T_CAP,
                             speakers=torch.tensor([CLI_SPEAKER],
                                                   device=device))
            t = int(out.mel_lens[0])
            mel = torch.zeros((1, T_CAP, out.postnet_mel.shape[-1]),
                              device=device)
            mel[0, :t] = out.postnet_mel[0, :t]
            ref = live.stage_b(mel)[0, :t * live.hop_length].cpu().numpy()
        err = float(np.abs(wav - ref).max()) if wav.shape == ref.shape \
            else float("inf")
        if not (err <= VOCOS_EXPORT_TOL and np.isfinite(wav).all()):
            raise AssertionError(f"exported Vocos {err} from the live "
                                 "Synthesizer")
        stream_ms, _ = first_chunk_ms(
            torch, lambda: tts.stream(ids, speaker=CLI_SPEAKER))
        streamed = np.concatenate(list(tts.stream(ids, speaker=CLI_SPEAKER)))
        stream_err = float(np.abs(streamed - wav).max()) \
            if streamed.shape == wav.shape else float("inf")
        if not stream_err <= EXPORT_STREAM_TOL:
            raise AssertionError(f"exported Vocos stream {stream_err} from "
                                 "synthesize")
        params = sizes["params.npz"]
        programs = sum(v for k, v in sizes.items() if k.endswith(".pt2"))
        f.update(launches=counts, export_seconds=export_s,
                 load_seconds=load_s, files=sizes,
                 programs_share=programs / params,
                 halo_frames=manifest["streaming"]["halo_frames"],
                 mel_len=t, max_abs_err_vs_live=err,
                 stream_vs_synthesize_max=stream_err,
                 time_to_first_audio_ms=stream_ms,
                 synthesize_ms=wall_ms(lambda: tts.synthesize(
                     ids, speaker=CLI_SPEAKER), torch, reps=3),
                 nvidia_smi=nvidia_smi())
    shutil.rmtree(VOCOS_EXPORT_DIR, ignore_errors=True)
    return counts


# the multi-device phases (smart_nar_fast_tts_tpu_torch/parallel/): WORLD
# ranks, one per card, over NCCL; WORLD is the largest power of two up to
# min(4, cards), so 1 on a one-card machine (a one-rank communicator: NCCL
# refuses two ranks on one card)
MD_DIR = os.path.join(REPO, "build", "multi_device_smoke")
MD_WORLD_MAX = 4
MD_TRAIN_STEPS = 3
MD_DEADLINE_S = 300
# the SP step (decoder self-attention ringed over the world): T 2048, where
# the dense step takes the f32 einsum (layers.FLASH_MIN_LEN), then T 8192
SP_B, SP_L, SP_T, SP_T_LONG = 8, 128, 2048, 8192
# JAX's SP gradient bar (tests/test_sequence_parallel.py:209-211)
SP_GRAD_ATOL, SP_GRAD_RTOL = 2e-5, 2e-3
# the ring's largest distance from float64 over the dense f32 path's, at
# most (md_ring_witness): the ring runs the dense branch on its query rows,
# so the two part by the order of the key blocks' gradient sums alone
RING_WITNESS_FACTOR = 1.5
# the channel-sharded HiFi-GAN against one card (tests/test_vocoder.py:
# 226-246)
TP_TOL = 2e-4
MD_GAN_STEPS = 2
MD_GAN_RTOL = 1e-3
MD_CLI_STEPS = (2, 3)       # cli.train --distributed to step 2, resumed to 3
# the torchrun launch of the CLIs: each rank dumps its Python stacks past
# MD_CLI_STACKS_S, its collectives time out past MD_CLI_COLLECTIVE_S (NCCL's
# watchdog then names the one that hung), the launch is stopped past
# MD_CLI_DEADLINE_S
MD_CLI_STACKS_S, MD_CLI_COLLECTIVE_S, MD_CLI_DEADLINE_S = 110, 140, 180


def md_world(torch):
    n = min(MD_WORLD_MAX, torch.cuda.device_count())
    return 1 << (n.bit_length() - 1)


def md_counts(kernels):
    return {**kernels.launches(), **kernels.route_launches()}


def md_expect(kernels, per, n):
    want = {k: 0 for k in md_counts(kernels)}
    want.update({k: v * n for k, v in per.items()})
    return want


def md_check_counts(kernels, what, per, n):
    counts = md_counts(kernels)
    want = md_expect(kernels, per, n)
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    return counts


def md_timed(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def md_grads(state):
    return [p.grad.detach().clone() if p.grad is not None else
            p.detach().new_zeros(p.shape) for p in state.params]


def md_same_on_every_rank(torch, tensors):
    """Whether ``tensors`` equal rank 0's, bit for bit, on this rank."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    torch.distributed.broadcast(ref, 0)
    return bool(torch.equal(flat, ref))


def md_grad_check(torch, name, got, want, names, gate=True):
    """JAX's SP bar: atol SP_GRAD_ATOL·max(scale, 1), rtol SP_GRAD_RTOL.
    Returns the largest |got − want| and each gradient's worst share of
    its bar (the five largest, by name); raises past it with ``gate``."""
    scale = max(float(g.abs().max()) for g in want)
    atol = SP_GRAD_ATOL * max(scale, 1.0)
    worst, share = 0.0, {}
    for n, g, w in zip(names, got, want):
        err = (g - w).abs()
        worst = max(worst, float(err.max()))
        share[n] = float((err / (atol + SP_GRAD_RTOL * w.abs())).max())
    top = dict(sorted(share.items(), key=lambda kv: -kv[1])[:5])
    bad = {n: v for n, v in top.items() if not v <= 1.0}
    if bad and gate:
        raise AssertionError(f"{name}: gradients beyond atol {SP_GRAD_ATOL}"
                             f"·max(scale, 1) rtol {SP_GRAD_RTOL} (share "
                             f"of the bar): {bad}, scale {scale}")
    return worst, scale, top


def md_losses(torch, name, got, want):
    rel = {k: abs(got[k] - v) / max(abs(v), 1e-30) for k, v in want.items()}
    bad = {k: e for k, e in rel.items() if not e <= TRAIN_RTOL}
    if bad:
        raise AssertionError(f"{name}: losses beyond rtol {TRAIN_RTOL}: "
                             f"{bad}")
    return max(rel.values())


def md_floats(losses):
    return {k: float(v) for k, v in losses._asdict().items()}


_MD_FLAGSHIP = {}


def md_flagship(cfg):
    """The committed flagship built with ``cfg`` (any duration extraction,
    sequence parallel or not), its weights read once a process."""
    from smart_nar_fast_tts_tpu_torch.config import (FeatureStats,
                                                     PreprocessConfig)
    from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
    from smart_nar_fast_tts_tpu_torch.serving import committed_flagship
    if not _MD_FLAGSHIP:
        _MD_FLAGSHIP["state"] = committed_flagship(cfg).state_dict()
        with open(os.path.join(REPO, "benchmarks", "results",
                               "flagship_meta.json")) as f:
            _MD_FLAGSHIP["stats"] = FeatureStats(**json.load(f)["stats"])
    model = FastSpeech2Align(cfg,
                             PreprocessConfig(stats=_MD_FLAGSHIP["stats"]))
    model.load_state_dict(_MD_FLAGSHIP["state"])
    return model


def md_dp(torch, kernels, inputs, world, rank):
    """DP: the committed flagship (intended/first) on train_phase's batch,
    mesh (world,), MD_TRAIN_STEPS steps.  Before each step every rank
    copies the state and takes the single-card step of the whole batch on
    its own card from the same parameters and Adam moments: its losses and
    gradient norm within TRAIN_RTOL, its parameters after step 1 within
    2·lr(1) (two runs of one step part by rounding; Adam's first update
    moves an element whose gradient is rounding noise by ±lr(1)).  From
    one update on the argmax durations settle near-ties their own way, so
    a run is never held to a second run of several steps."""
    import copy

    from smart_nar_fast_tts_tpu_torch.config import ModelConfig
    from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Loss
    from smart_nar_fast_tts_tpu_torch.parallel import make_mesh
    from smart_nar_fast_tts_tpu_torch.training import (compute_gradients,
                                                       create_train_state)
    cfg = ModelConfig(duration_extraction="intended",
                      duration_head_reduce="first")
    batch, loss_fn = inputs["train_batch"], FastSpeech2Loss()
    mesh = make_mesh((world,), ("data",))
    state = create_train_state(md_flagship(cfg))

    def step(st, m):
        lb, _ = compute_gradients(st, loss_fn, batch, mesh=m)
        return md_floats(lb), float(st.apply_gradients())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = {k: 0 for k in md_counts(kernels)}
    res = dict(mesh=mesh.shape, rows_per_rank=TRAIN_B // world, step_ms=[],
               losses=[], grad_norms=[], single_card_step_ms=[],
               losses_max_relative_err=[], grad_norm_relative_err=[])
    for i in range(MD_TRAIN_STEPS):
        ref = copy.deepcopy(state)
        (ref_losses, ref_norm), ref_ms = md_timed(
            torch, lambda: step(ref, None))
        # the main path's launches: the DP steps only
        kernels.reset_launches()
        (losses, norm), ms = md_timed(torch, lambda: step(state, mesh))
        counts = {k: counts[k] + v for k, v in md_counts(kernels).items()}
        res["step_ms"].append(ms)
        res["losses"].append(losses)
        res["grad_norms"].append(norm)
        res["single_card_step_ms"].append(ref_ms)
        res["losses_max_relative_err"].append(
            md_losses(torch, f"DP step {i + 1}", losses, ref_losses))
        rel = abs(norm - ref_norm) / ref_norm
        res["grad_norm_relative_err"].append(rel)
        if not rel <= TRAIN_RTOL:
            raise AssertionError(f"DP step {i + 1}: gradient norm off by "
                                 f"{rel}")
        if i == 0:
            diff = max(float((a - b).detach().abs().max())
                       for a, b in zip(state.params, ref.params))
            res.update(params_step1_max_abs_diff=diff,
                       params_step1_bound=2 * state.lr(1),
                       params_same_on_every_rank=md_same_on_every_rank(
                           torch, state.params))
            if not diff <= 2 * state.lr(1):
                raise AssertionError(f"DP: parameters after step 1 differ "
                                     f"by {diff} > 2·lr(1)")
            if not res["params_same_on_every_rank"]:
                raise AssertionError("DP: the ranks' parameters differ")
        del ref
    want = md_expect(kernels, PER_TRAIN_STEP, MD_TRAIN_STEPS)
    if counts != want:
        raise AssertionError(f"DP train steps: launches {counts}, expected "
                             f"{want}")
    res.update(launches=counts,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    return res


def md_dense_attention(torch, q, k, v, valid):
    """The dense decoder self-attention's einsum branch
    (``kernels.einsum_attention``), in the inputs' dtype."""
    from smart_nar_fast_tts_tpu_torch.kernels import masked_softmax
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / q.shape[-1] ** 0.5
    return torch.einsum("bhqk,bhkd->bhqd",
                        masked_softmax(s, valid[:, None, None, :]), v)


def md_ring_witness(torch, model, batch, mesh, rank):
    """The ring against float64 at the committed weights' own logits: the
    q, k, v and key mask of every decoder self-attention of a forward of
    the SP batch (eval mode) go through the ring (f32, every rank), the
    dense einsum branch (f32, rank 0) and the same in float64 (rank 0),
    with one seeded cotangent.  For the output and its q, k, v gradients,
    the ring's largest distance from float64 is held within
    RING_WITNESS_FACTOR times the dense f32 path's, and both relative L2
    distances are reported.  At logits of ~1e3 the gradient of a near-
    one-hot softmax is a difference of nearly equal f32 terms, so either
    f32 path's error is set by how it rounds; the ring runs the dense
    branch on its query rows and shares that rounding (an online-softmax
    ring of a pre-scaled q read up to 3.42× here)."""
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.models import layers
    from smart_nar_fast_tts_tpu_torch.parallel import (
        sequence_parallel_self_attention)
    seen = []

    def record(m, q, k, v, key_valid, axis):
        seen.append(tuple(t.detach().clone() for t in (q, k, v, key_valid)))
        return sequence_parallel_self_attention(m, q, k, v, key_valid, axis)
    b = batch.to("cuda")
    with mock.patch.object(layers, "sequence_parallel_self_attention",
                           record), torch.no_grad():
        model.cuda().eval()(b.texts, b.src_lens, mels=b.mels,
                            mel_lens=b.mel_lens, p_targets=b.pitch,
                            e_targets=b.energy, sp_mesh=mesh)
    del model
    res = []
    for i, (q, k, v, valid) in enumerate(seen):
        gen = torch.Generator().manual_seed(11 + i)
        cot = torch.randn(q.shape, generator=gen).cuda()

        def run(fn, dtype):
            x = [t.to(dtype).clone().requires_grad_() for t in (q, k, v)]
            out = fn(*x, valid)
            (out * cot.to(dtype)).sum().backward()
            return [out.detach()] + [t.grad for t in x]
        ring = run(lambda a, c, d, m: sequence_parallel_self_attention(
            mesh, a, c, d, m, "data"), torch.float32)
        if rank != 0:
            continue
        f64 = run(lambda *x: md_dense_attention(torch, *x), torch.float64)
        dense = run(lambda *x: md_dense_attention(torch, *x), torch.float32)
        layer = dict(layer=i, logit_abs_max=float((torch.einsum(
            "bhqd,bhkd->bhqk", q.double(), k.double()).abs().amax()
            / q.shape[-1] ** 0.5)))
        for name, r, d, w in zip(("out", "dq", "dk", "dv"), ring, dense,
                                 f64):
            r, d = r.double() - w, d.double() - w
            r_err, d_err = float(r.abs().max()), float(d.abs().max())
            layer[name] = dict(ring_vs_f64=r_err, dense_f32_vs_f64=d_err,
                               ratio=r_err / d_err,
                               ring_rel_l2=float(r.norm() / w.norm()),
                               dense_f32_rel_l2=float(d.norm() / w.norm()))
            if not r_err <= RING_WITNESS_FACTOR * d_err:
                raise AssertionError(
                    f"ring witness, decoder layer {i} {name}: the ring is "
                    f"{r_err} from float64, the dense f32 path {d_err} "
                    f"(> {RING_WITNESS_FACTOR}×)")
        res.append(layer)
        del f64, dense, ring
    return res


def md_sp(torch, kernels, inputs, world, rank):
    """SP: the flagship with its decoder self-attention ringed over the
    world, mesh (world,), at T SP_T against the dense single-card step of
    the same weights (rank 0), on the committed weights and on seeded-init
    weights of the same widths (JAX's own SP test: fresh weights, hidden
    256, T 2048): losses within TRAIN_RTOL and gradients at JAX's bar.
    The committed weights' attention logits run to ~2.5e3, where any
    rounding of the attention but the dense branch's moves the gradients by
    several times that bar (an online-softmax ring: 9.52–10.49× with a
    pre-scaled q, 1.15× with the dense branch's scores), so the ring runs
    that branch on its query rows; :func:`md_ring_witness` holds the ring
    to float64 at those logits within RING_WITNESS_FACTOR times the
    einsum's own distance.  With world ≥ 4 the hybrid (2, world/2) step on
    the seeded weights; then one SP step at SP_T_LONG beside the dense
    single-card one."""
    from smart_nar_fast_tts_tpu_torch.config import ModelConfig
    from smart_nar_fast_tts_tpu_torch.models import (FastSpeech2Align,
                                                     FastSpeech2Loss)
    from smart_nar_fast_tts_tpu_torch.parallel import make_mesh
    from smart_nar_fast_tts_tpu_torch.training import (compute_gradients,
                                                       create_train_state)
    loss_fn = FastSpeech2Loss()

    def cfg(**sp):
        return ModelConfig(duration_extraction="intended",
                           duration_head_reduce="first", **sp)

    def seeded(config):
        torch.manual_seed(0)
        return FastSpeech2Align(config)

    def grads_of(model, batch, **meshes):
        state = create_train_state(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        (lb, _), ms = md_timed(torch, lambda: compute_gradients(
            state, loss_fn, batch, **meshes))
        kind = "SP" if model.cfg.sequence_parallel else "dense"
        counts = md_check_counts(kernels, f"{kind} T {batch.mels.shape[1]}",
                                 PER_TRAIN_STEP, 1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        return md_grads(state), md_floats(lb), ms, counts, peak

    flat = make_mesh((world,), ("data",))
    names = [n for n, _ in seeded(cfg()).named_parameters()]
    batch = inputs["sp_batch"]
    res = {}
    for weights, make in (("committed", md_flagship), ("seeded", seeded)):
        grads, losses, ms, counts, peak = grads_of(
            make(cfg(sequence_parallel=True)), batch, sp_mesh=flat)
        entry = dict(mesh=flat.shape, T=SP_T, weights=weights,
                     losses=losses, forward_backward_ms=ms, launches=counts,
                     peak_mem_gib=peak, frames_per_rank=SP_T // world,
                     grads_same_on_every_rank=md_same_on_every_rank(
                         torch, grads))
        if not entry["grads_same_on_every_rank"]:
            raise AssertionError(f"SP ({weights}): the ranks' gradients "
                                 "differ")
        if rank == 0:
            dense, dense_losses, dense_ms, _, dense_peak = grads_of(
                make(cfg()), batch)
            # two dense runs part by the card's own rounding (cuDNN's and
            # the embedding's backward sum in no fixed order)
            _, _, noise = md_grad_check(torch, "dense",
                                        grads_of(make(cfg()), batch)[0],
                                        dense, names, gate=False)
            worst, scale, top = md_grad_check(
                torch, f"SP ({weights})", grads, dense, names)
            entry.update(
                dense_losses=dense_losses, dense_forward_backward_ms=dense_ms,
                dense_peak_mem_gib=dense_peak,
                losses_max_relative_err=md_losses(
                    torch, f"SP ({weights})", losses, dense_losses),
                grad_max_abs_err=worst, grad_scale=scale,
                grad_bar_share_top5=top, dense_vs_dense_bar_share_top5=noise)
            if weights == "seeded":
                seeded_dense = (dense_losses, dense)
        res[f"sp {weights}"] = entry
        del grads
    # the committed weights' ring held to float64 beside the dense f32 path
    res["sp committed"]["ring_witness"] = md_ring_witness(
        torch, md_flagship(cfg(sequence_parallel=True)), batch, flat, rank)
    if world >= 4:
        grid = make_mesh((2, world // 2), ("data", "seq"))
        grads, losses, ms, counts, peak = grads_of(
            seeded(cfg(sequence_parallel=True, sp_axis="seq")), batch,
            mesh=grid, sp_mesh=grid)
        res["hybrid"] = dict(mesh=grid.shape, weights="seeded",
                             losses=losses, forward_backward_ms=ms,
                             launches=counts, peak_mem_gib=peak,
                             grads_same_on_every_rank=md_same_on_every_rank(
                                 torch, grads))
        if rank == 0:
            worst, _, top = md_grad_check(torch, "hybrid", grads,
                                          seeded_dense[1], names)
            res["hybrid"].update(
                losses_max_relative_err=md_losses(
                    torch, "hybrid", losses, seeded_dense[0]),
                grad_max_abs_err=worst, grad_bar_share_top5=top)
        del grads
        if not res["hybrid"]["grads_same_on_every_rank"]:
            raise AssertionError("hybrid: the ranks' gradients differ")
    if rank == 0:
        del seeded_dense

    # one SP step at SP_T_LONG, and the dense single-card one (flash past
    # 2048 frames: its 4 decoder self-attentions)
    def long_step(config, per, **meshes):
        state = create_train_state(md_flagship(config))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()

        def step():
            lb, _ = compute_gradients(state, loss_fn, inputs["sp_long"],
                                      **meshes)
            state.apply_gradients()
            return lb
        lb, ms = md_timed(torch, step)
        counts = md_check_counts(kernels, f"T {SP_T_LONG} step", per, 1)
        del state
        return dict(step_ms=ms, launches=counts, losses=md_floats(lb),
                    peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    res["sp_long"] = dict(T=SP_T_LONG, **long_step(
        cfg(sequence_parallel=True), PER_TRAIN_STEP, sp_mesh=flat))
    if rank == 0:
        from smart_nar_fast_tts_tpu_torch.models.layers import FLASH_MIN_LEN
        flash = cfg().transformer.decoder_layer * (SP_T_LONG > FLASH_MIN_LEN)
        res["sp_long"]["dense_single_card"] = long_step(
            cfg(), dict(PER_TRAIN_STEP, flash_attention=flash))
    torch.cuda.empty_cache()
    return res


def md_tp(torch, kernels, inputs, world):
    """The committed HiFi-GAN V1 channel-sharded over the world on the
    serving batch's mel: mesh (1, world), and (2, world/2) with world ≥ 4,
    against the single-card generator; the single card's forward takes the
    resblock kernel, the sharded one (its convs ``_Gathered``) the module
    chain."""
    from smart_nar_fast_tts_tpu_torch.parallel import make_mesh
    from smart_nar_fast_tts_tpu_torch.serving import committed_vocoder
    from smart_nar_fast_tts_tpu_torch.vocoder import shard_hifigan
    gen = committed_vocoder().cuda().eval()
    mel = inputs["serving_mel"].cuda()

    def resblock_launches(fn):
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, kernels.launches()["hifigan_resblock_conv"]
    with torch.inference_mode():
        ref, n = resblock_launches(lambda: gen(mel))
        res = dict(single_card_stage_b_ms=wall_ms(lambda: gen(mel), torch))
    if n != RB_V1_LAUNCHES:
        raise AssertionError(f"single-card HiFi-GAN: {n} resblock launches")
    shapes = [(1, world)] + ([(2, world // 2)] if world >= 4 else [])
    for shape in shapes:
        fwd = shard_hifigan(gen, make_mesh(shape, ("data", "model")))
        out, n = resblock_launches(lambda: fwd(mel))
        if n:
            raise AssertionError(f"TP HiFi-GAN {shape}: {n} resblock "
                                 "launches")
        err = check_close(f"TP HiFi-GAN {shape}", out, ref, TP_TOL,
                          torch)
        res[f"mesh {shape}"] = dict(max_abs_err=err,
                                    stage_b_ms=wall_ms(lambda: fwd(mel),
                                                       torch))
    return res


def md_gan(torch, kernels, inputs, world, rank):
    """DP GAN: the committed HiFi-GAN V1 against the seeded full
    discriminator, B 16 × 8192, mesh (world, 1), MD_GAN_STEPS steps; before
    each, every rank takes the single-card step of the whole batch from a
    copy of the state: metrics within MD_GAN_RTOL."""
    import copy

    from smart_nar_fast_tts_tpu_torch.audio import MelSpectrogramConfig
    from smart_nar_fast_tts_tpu_torch.parallel import make_mesh
    from smart_nar_fast_tts_tpu_torch.serving import committed_vocoder
    from smart_nar_fast_tts_tpu_torch.training import (
        VocoderOptimizer, create_vocoder_state, make_vocoder_train_step)
    from smart_nar_fast_tts_tpu_torch.vocoder import HiFiGANDiscriminator
    segments = inputs["segments"]
    mesh = make_mesh((world, 1))
    tx = VocoderOptimizer()
    state = create_vocoder_state(committed_vocoder(),
                                 HiFiGANDiscriminator(seed=0), tx, tx)
    step = make_vocoder_train_step(MelSpectrogramConfig(), mesh=mesh)
    single = make_vocoder_train_step(MelSpectrogramConfig())

    def floats(m):
        return {k: float(v) for k, v in m._asdict().items()}
    counts = {k: 0 for k in md_counts(kernels)}
    res = dict(mesh=mesh.shape, segments_per_rank=VOC_B // world,
               step_ms=[], metrics=[], single_card_step_ms=[],
               metrics_max_relative_err=[])
    for i in range(MD_GAN_STEPS):
        ref = copy.deepcopy(state)
        want, ref_ms = md_timed(torch, lambda: floats(single(ref,
                                                             segments)))
        del ref
        kernels.reset_launches()
        got, ms = md_timed(torch, lambda: floats(step(state, segments)))
        counts = {k: counts[k] + v for k, v in md_counts(kernels).items()}
        rel = max(abs(got[k] - v) / max(abs(v), 1e-30)
                  for k, v in want.items())
        res["step_ms"].append(ms)
        res["metrics"].append(got)
        res["single_card_step_ms"].append(ref_ms)
        res["metrics_max_relative_err"].append(rel)
        if not rel <= MD_GAN_RTOL:
            raise AssertionError(f"DP GAN step {i + 1}: metrics off by "
                                 f"{rel} > {MD_GAN_RTOL}")
    want = md_expect(kernels, PER_GAN_STEP, MD_GAN_STEPS)
    if counts != want:
        raise AssertionError(f"DP GAN steps: launches {counts}, expected "
                             f"{want}")
    res["launches"] = counts
    return res


def multi_device_rank(rank, world, port, work):
    """One rank of the multi-device phases, spawned one per card: joins the
    NCCL group, runs each path with its launch counts set to 0 just before
    and read just after, holds it to the single card (rank 0), and writes
    its numbers to ``work/rank<r>.pt``.  A failure writes its traceback to
    ``work/rank<r>.err`` and ends the process with code 1."""
    import traceback

    import torch
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        sys.path.insert(0, REPO)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from smart_nar_fast_tts_tpu_torch import kernels
        from smart_nar_fast_tts_tpu_torch.parallel import init_distributed
        init_distributed(require=True)
        inputs = torch.load(os.path.join(work, "inputs.pt"),
                            weights_only=False)
        out = dict(rank=rank, card=torch.cuda.get_device_name(),
                   device_index=torch.cuda.current_device(),
                   backend=torch.distributed.get_backend())
        t0 = time.perf_counter()
        out["dp"] = md_dp(torch, kernels, inputs, world, rank)
        out.update(md_sp(torch, kernels, inputs, world, rank))
        out["tp"] = md_tp(torch, kernels, inputs, world)
        out["gan"] = md_gan(torch, kernels, inputs, world, rank)
        out["seconds"] = time.perf_counter() - t0
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sp_batch(torch, np, inv, t, seed):
    """A seeded SP batch of SP_B items at T ``t``: texts from the trained
    phone inventory, normal mels and prosody, frame lengths from 3/4·t to
    t (item 0 full)."""
    from smart_nar_fast_tts_tpu_torch.data import Batch
    rng = np.random.default_rng(seed)
    mel_lens = rng.integers(3 * t // 4, t + 1, size=SP_B)
    mel_lens[0] = t

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    return Batch(texts=torch.from_numpy(rng.choice(inv, size=(SP_B, SP_L))),
                 src_lens=torch.from_numpy(rng.integers(SP_L - 32, SP_L + 1,
                                                        size=SP_B)),
                 mels=normal(SP_B, t, 80), mel_lens=torch.from_numpy(mel_lens),
                 pitch=normal(SP_B, t), energy=normal(SP_B, t))


def multi_device_phase(torch, np, kernels, synth, inv, short, segments,
                       world=None):
    """The multi-device phases: ``world`` (by default md_world()) NCCL
    ranks spawned one per card (``multi_device_rank``); prints the world
    and the cards on lines of their own.  Returns (world, each rank's
    numbers)."""
    import shutil

    import torch.multiprocessing as mp
    world = world or md_world(torch)
    with Phase("multi_device") as f:
        shutil.rmtree(MD_DIR, ignore_errors=True)
        work = os.path.join(MD_DIR, "ranks")
        os.makedirs(work)
        batch = train_batch(torch, np, synth, inv)
        torch.save(dict(
            train_batch=type(batch)(*(None if t is None else t.cpu()
                                      for t in batch)),
            sp_batch=sp_batch(torch, np, inv, SP_T, 5),
            sp_long=sp_batch(torch, np, inv, SP_T_LONG, 6),
            serving_mel=short.postnet_mel.float().cpu(),
            segments=segments.cpu()), os.path.join(work, "inputs.pt"))
        ctx = mp.start_processes(multi_device_rank,
                                 args=(world, free_port(), work),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + MD_DEADLINE_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise AssertionError(f"multi_device ranks still running "
                                         f"after {MD_DEADLINE_S} s")
        except BaseException as e:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            errs = [open(os.path.join(work, n)).read()
                    for n in sorted(os.listdir(work)) if n.endswith(".err")]
            raise AssertionError("multi_device rank failed:\n"
                                 + "\n".join(errs)) from e
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]
        cards = [r["card"] for r in ranks]
        print(f"multi_device world {world}", flush=True)
        print(f"multi_device cards {cards}", flush=True)
        f.update(world=world, cards=cards, ranks=ranks,
                 nvidia_smi=nvidia_smi())
    return world, ranks


def rank_cli(argv):
    """``chip_smoke.py --rank-cli <plan.json>`` (one rank of a torchrun
    launch): each run of the plan, ``{"cli", "out", "argv"}``, in order:
    ``smart_nar_fast_tts_tpu_torch.cli.<cli>.main(argv)`` with the launch
    counts set to 0 just before and read just after, written with its
    result to ``<out>.<rank>.json``.  The process group joined by the
    first run that joins one serves the rest.  A rank still running after
    MD_CLI_STACKS_S writes its Python stacks to
    ``<plan>.stacks.<rank>.txt``."""
    import faulthandler
    import importlib

    import torch
    sys.path.insert(0, REPO)
    from smart_nar_fast_tts_tpu_torch import kernels
    from smart_nar_fast_tts_tpu_torch.parallel import mesh
    dist = torch.distributed
    stacks = open(f"{argv[0]}.stacks.{os.environ['RANK']}.txt", "w")
    faulthandler.dump_traceback_later(MD_CLI_STACKS_S, file=stacks)
    mesh.COLLECTIVE_TIMEOUT_S = MD_CLI_COLLECTIVE_S
    with open(argv[0]) as f:
        plan = json.load(f)
    for run in plan:
        cli = importlib.import_module(
            f"smart_nar_fast_tts_tpu_torch.cli.{run['cli']}")
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = cli.main(run["argv"])
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rank = dist.get_rank() if dist.is_initialized() else 0
        if hasattr(result, "_asdict"):
            result = {k: float(v) for k, v in result._asdict().items()}
        elif isinstance(result, dict):
            result = result.get("saved")
        else:
            result = None
        with open(f"{run['out']}.{rank}.json", "w") as f:
            json.dump(dict(rank=rank, world=int(os.environ["WORLD_SIZE"]),
                           group=dist.is_initialized(),
                           launches={**kernels.launches(),
                                     **kernels.route_launches()},
                           seconds=seconds, result=result), f)
    if dist.is_initialized():
        dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()
    return 0


def torchrun(world, plan_path, plan):
    """The plan's CLI runs in one torchrun launch (``--standalone
    --nproc_per_node world``) through :func:`rank_cli`; each run's
    records, by rank."""
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={world}", os.path.join(REPO, "chip_smoke.py"),
           "--rank-cli", plan_path]
    log_path = plan_path + ".log"
    t0 = time.perf_counter()
    # the ranks' output to a file; past the deadline the launcher is
    # stopped (it stops its ranks, which run in sessions of their own),
    # then killed with its session
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=MD_CLI_DEADLINE_S)
        except subprocess.TimeoutExpired:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)
                proc.wait()
            rc = f"stopped after {MD_CLI_DEADLINE_S} s"
    if rc != 0:
        with open(log_path) as log:
            text = log.read()[-4000:]
        for r in range(world):
            path = f"{plan_path}.stacks.{r}.txt"
            if os.path.exists(path):
                with open(path) as fh:
                    text += f"\n-- rank {r} stacks --\n{fh.read()[-3000:]}"
        raise AssertionError(f"torchrun: {rc}\n{text}")
    records = []
    for run in plan:
        ranks = []
        for r in range(world):
            with open(f"{run['out']}.{r}.json") as f:
                ranks.append(json.load(f))
        records.append(ranks)
    return records, time.perf_counter() - t0


def multi_device_cli_phase(torch, kernels, world, trainer_argv, cli):
    """The training CLIs under torchrun on the trainer phase's corpus and
    step-0 flagship checkpoint (a copy, with its own output paths):
    ``cli.train --distributed`` to step 2 (only rank 0 writes), resumed to
    step 3 (a validation), ``cli.evaluate`` of step 3 against the same CLI
    in this process, and ``cli.train_vocoder`` for 2 GAN steps."""
    import shutil

    from smart_nar_fast_tts_tpu_torch.cli import evaluate as evaluate_cli
    from smart_nar_fast_tts_tpu_torch.training import CheckpointManager
    out_dir = os.path.join(MD_DIR, "output")
    with Phase("multi_device cli") as f:
        shutil.rmtree(os.path.join(MD_DIR, "cli"), ignore_errors=True)
        os.makedirs(os.path.join(MD_DIR, "cli"))
        rec = os.path.join(MD_DIR, "cli", "rank")
        src_out = os.path.join(TRAINER_DIR, "output")
        train_yaml = os.path.join(MD_DIR, "train.yaml")
        with open(trainer_argv[5]) as fh:
            text = fh.read().replace(src_out, out_dir)
        with open(train_yaml, "w") as fh:
            fh.write(text)
        ckpt = os.path.join(out_dir, "ckpt")
        shutil.copytree(os.path.join(src_out, "ckpt", "0"),
                        os.path.join(ckpt, "0"))
        argv = trainer_argv[:4] + ["-t", train_yaml]
        step3 = argv + ["--restore_step", str(MD_CLI_STEPS[1])]
        voc_out = os.path.join(MD_DIR, "vocoder")
        plan = [dict(cli="train", argv=argv + [
                        "--distributed", "--total_step", str(total)])
                for total in MD_CLI_STEPS]
        plan += [dict(cli="evaluate", argv=step3),
                 dict(cli="train_vocoder", argv=[
                     "--wav_dir", os.path.join(VOC_CLI_DIR, "wavs"),
                     "--steps", str(MD_GAN_STEPS), "--batch_size",
                     str(VOC_B), "--segment_size", str(VOC_SEG),
                     "--restore_generator", cli["vocoder"],
                     "--save_every", str(MD_GAN_STEPS), "--log_every",
                     str(MD_GAN_STEPS), "--out_dir", voc_out])]
        names = ("train", "resume", "evaluate", "train_vocoder")
        for name, run in zip(names, plan):
            run["out"] = f"{rec}-{name}"
        records, wall = torchrun(world, f"{rec}-plan.json", plan)
        runs = {name: dict(ranks=r) for name, r in zip(names, records)}
        saved = CheckpointManager(ckpt).all_steps()
        if saved != [0, *MD_CLI_STEPS]:
            raise AssertionError(f"cli.train --distributed saved {saved}")
        events = {w: sorted(n for n in os.listdir(os.path.join(
            out_dir, "log", w)) if n.startswith("events."))
                  for w in ("train", "val")}
        # one writer: each run opens one event file per split
        if any(len(v) != 2 for v in events.values()):
            raise AssertionError(f"event files {events}")
        logs = {}
        for w in ("train", "val"):
            with open(os.path.join(out_dir, "log", w, "log.txt")) as fh:
                logs[w] = [line.split(",")[0] for line in fh]
        if logs != {"train": ["Step 2/2"], "val": ["Validation Step 3"]}:
            raise AssertionError(f"log.txt {logs}")
        ranks = runs["evaluate"]["ranks"]
        single = evaluate_cli.main(step3)._asdict()
        rel = {k: abs(ranks[0]["result"][k] - v) / max(abs(v), 1e-30)
               for k, v in single.items()}
        bad = {k: e for k, e in rel.items() if not e <= TRAIN_RTOL}
        if bad:
            raise AssertionError(f"torchrun cli.evaluate against one "
                                 f"process beyond rtol {TRAIN_RTOL}: {bad}")
        val_batches = ranks[0]["launches"]["alignment_attention"] // 4
        want_forwards = {"train": [MD_CLI_STEPS[0]] * world,
                         "resume": [1 + val_batches + (r == 0)
                                    for r in range(world)],
                         "evaluate": [val_batches] * world}
        for name, forwards in want_forwards.items():
            for r, n in enumerate(forwards):
                want = md_expect(kernels, PER_FORWARD, n)
                # rank 0 vocodes the resumed run's validation sample twice
                want["hifigan_resblock_conv"] = 2 * RB_V1_LAUNCHES * (
                    name == "resume" and r == 0)
                if runs[name]["ranks"][r]["launches"] != want:
                    raise AssertionError(
                        f"torchrun {name} rank {r}: launches "
                        f"{runs[name]['ranks'][r]['launches']}, expected "
                        f"{want}")
        files = sorted(os.listdir(voc_out))
        if files != ["config.json", f"generator_{MD_GAN_STEPS}.pth.tar",
                     "meta.json"]:
            raise AssertionError(f"torchrun cli.train_vocoder wrote {files}")
        for r in runs["train_vocoder"]["ranks"]:
            want = md_expect(kernels, PER_GAN_STEP, MD_GAN_STEPS)
            if r["launches"] != want:
                raise AssertionError(f"torchrun train_vocoder rank "
                                     f"{r['rank']}: launches {r['launches']}")
        f.update(world=world, torchrun_wall_seconds=wall, runs=runs,
                 checkpoints=saved, event_files=events,
                 log_txt=logs, evaluate_single_process=single,
                 evaluate_relative_err=rel, val_batches=val_batches,
                 nvidia_smi=nvidia_smi())
    return runs


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


def multi_device_only(phases) -> int:
    """``chip_smoke.py --multi-device PHASE [PHASE ...]`` on a node of
    several cards: the multi-device phases alone, in the order given, each
    ``cli:W`` (``multi_device_cli_phase``) or ``md:W``
    (``multi_device_phase``) at world W, on the inputs they read in a
    whole run (the e2e phase's serving batch and waveforms, untimed; the
    cli phase's HiFi-GAN V1; the trainer phase's corpus).  A ``cli`` phase
    after a failed one is skipped (it would wait out its deadline too).
    Exits 1 when a phase failed."""
    import shutil
    import traceback

    import torch
    sys.path.insert(0, REPO)
    import numpy as np

    from smart_nar_fast_tts_tpu_torch import kernels
    from smart_nar_fast_tts_tpu_torch.data import save_wav
    from smart_nar_fast_tts_tpu_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(nvidia_smi(), torch.__version__, torch.version.cuda,
          torch.cuda.device_count(), flush=True)
    with Phase("build") as f:
        f["compiled"] = _build.build_all()
    from smart_nar_fast_tts_tpu_torch.serving import Synthesizer
    texts, src_lens, inv = bench_inputs(np)
    with Phase("multi_device inputs"):
        # the e2e phase's serving run, without its timings
        synth = Synthesizer.from_committed()
        wav, mel_lens = synth.synthesize(texts, src_lens)
        short = synth.stage_a(torch.from_numpy(texts),
                              torch.from_numpy(src_lens))
        segments = vocoder_segments(torch, np, wav, mel_lens,
                                    synth.hop_length)
        voc = cli_workspace(torch, np)[2]
        paths = trainer_workspace(torch, np, synth, inv, voc)
        trainer_argv = ["-p", paths[0], "-m", paths[1], "-t", paths[2]]
        shutil.rmtree(VOC_CLI_DIR, ignore_errors=True)
        os.makedirs(os.path.join(VOC_CLI_DIR, "wavs"))
        for i in range(wav.shape[0]):
            n = int(mel_lens[i]) * synth.hop_length
            save_wav(os.path.join(VOC_CLI_DIR, "wavs", f"e2e{i}.wav"),
                     wav[i, :n].float().cpu().numpy(), synth.sampling_rate)
    failed = []
    for phase in phases:
        kind, world = phase.split(":")
        if kind == "cli" and any(p.startswith("cli") for p in failed):
            print(f"skipped {phase}", flush=True)
            continue
        try:
            if kind == "cli":
                shutil.rmtree(MD_DIR, ignore_errors=True)
                multi_device_cli_phase(torch, kernels, int(world),
                                       trainer_argv, {"vocoder": voc})
            else:
                multi_device_phase(torch, np, kernels, synth, inv, short,
                                   segments, world=int(world))
        except Exception:
            failed.append(phase)
            print(f"FAILED {phase}\n{traceback.format_exc()}", flush=True)
    emit({"multi_device_only": phases, "failed": failed})
    return 1 if failed else 0


# HiFi-GAN's resblock convolutions (csrc/hifigan_resblock.cu): V1's
# (channels per stage, kernels, dilations) and V3's, the batch cell's shape
# (B 16, 1000 mel frames) and online's (B 2, 500 frames)
RB_V1 = ((256, 128, 64, 32), (3, 7, 11), ((1, 3, 5),) * 3)
RB_V3 = ((128, 64, 32, 16), (3, 5, 7), ((1, 2), (2, 6), (3, 12)))
RB_HOPS = (8, 64, 128, 256)         # samples a mel frame after each stage
RB_TIMED = (("batch", 16, 1000), ("online", 2, 500))
# the shapes of the benchmark's HiFi-GAN cells (portbench/traffic): batch
# B 16 at bucket 1000, online B 1-16 at buckets 128-1000
RB_CELL_BATCHES = tuple(range(1, 17))
RB_CELL_BUCKETS = (128, 256, 384, 512, 640, 768, 1000)
# the kernel's largest |error| against float64 (over the float64 output's
# largest |value|): at most RB_ERR_MAX, and at most RB_ERR_RATIO times
# cuDNN float32's own unless below RB_ERR_FLOOR
RB_ERR_MAX, RB_ERR_RATIO, RB_ERR_FLOOR = 1e-5, 2.0, 1e-6


def rb_bound_ms(b, cin, cout, t, k, mode):
    """Least time of one resblock conv: x and out once (res and acc where
    read), the weights once; 3·2·B·T·Cin·Cout·k operations at the TF32
    rate (3xTF32)."""
    nbytes = 4 * (b * t * (cin + cout * (1 + mode)) + cout * cin * k + cout)
    return bound(nbytes, 3 * 2 * b * t * cin * cout * k, TF32_FLOPS)


def rb_errors(torch, got, x, w, bias, d, res, acc, div):
    """The kernel's output ``got`` and cuDNN float32's (the plain version,
    TF32 off) against float64 on the same inputs: each one's largest
    |error| over the float64 output's largest |value|."""
    from smart_nar_fast_tts_tpu_torch.kernels import resblock
    with torch.inference_mode():
        ref = resblock.resblock_conv_reference(x, w, bias, d, 0.1, res, acc,
                                               div)
        f64 = resblock.resblock_conv_reference(
            *(None if v is None else v.double()
              for v in (x, w, bias)), d, 0.1,
            *(None if v is None else v.double() for v in (res, acc)), div)
    scale = float(f64.abs().max())
    return (float((got.double() - f64).abs().max()) / scale,
            float((ref.double() - f64).abs().max()) / scale)


def rb_off(kerr, cerr):
    """The kernel's error is off its limits (see RB_ERR_MAX)."""
    return not (kerr <= RB_ERR_MAX and (kerr <= RB_ERR_RATIO * cerr
                                        or kerr <= RB_ERR_FLOOR))


def rb_case(torch, b, c, t, k, d, mode, tile=-1):
    """One conv on the kernel, on seeded inputs, against float64 and cuDNN
    float32 (:func:`rb_errors`)."""
    from smart_nar_fast_tts_tpu_torch.kernels import resblock
    x = torch.randn(b, c, t, device="cuda") * 2
    w = torch.randn(c, c, k, device="cuda") / (c * k) ** 0.5
    bias = torch.randn(c, device="cuda") * 0.1
    res = torch.randn(b, c, t, device="cuda") if mode >= 1 else None
    acc = torch.randn(b, c, t, device="cuda") if mode == 2 else None
    div = 3.0 if mode == 2 else 1.0
    with torch.inference_mode():
        got = resblock._launch(x, w, bias, res, acc, d, 0.1, div, tile)
    return rb_errors(torch, got, x, w, bias, d, res, acc, div)


def rb_v1_convs(frames):
    """(C, T samples, k, d) of each of V1's resblock convs on ``frames`` mel
    frames, in the order the generator runs them."""
    return [(c, frames * hop, k, dd)
            for c, hop in zip(RB_V1[0], RB_HOPS)
            for k, ds in zip(RB_V1[1], RB_V1[2])
            for d in ds for dd in (d, 1)]


def rb_tile_choices(lib):
    """The tile the kernel chooses (``tile_for``) for each of V1's 72
    convs at the timed shapes, and how often each tile is chosen over every
    shape of the benchmark's HiFi-GAN cells; raises when a tile is chosen
    by none of them."""
    per_conv = {label: [lib.hifigan_resblock_tile_for(b, c, c, t, k, d)
                        for c, t, k, d in rb_v1_convs(frames)]
                for label, b, frames in RB_TIMED}
    chosen = collections.Counter(
        lib.hifigan_resblock_tile_for(b, c, c, t, k, d)
        for b in RB_CELL_BATCHES for frames in RB_CELL_BUCKETS
        for c, t, k, d in rb_v1_convs(frames))
    unused = sorted(set(range(lib.hifigan_resblock_tiles())) - set(chosen))
    if unused or -1 in chosen:
        raise AssertionError(f"hifigan_resblock: tiles {unused} chosen by no "
                             f"cell shape (choices {dict(chosen)})")
    return dict(per_conv=per_conv,
                cells_B_1_16_buckets_128_1000={
                    str(t): n for t, n in sorted(chosen.items())})


def kernel_hifigan_resblock(torch, np, kernels, compiled):
    """The resblock conv kernel against float64 and cuDNN float32 at V1's
    and V3's convs (B 1 and 3, T past and below the halo, T not a multiple
    of 4, each epilogue, every tile); the tile it chooses at the cells'
    shapes; then, at the batch and online shapes, each timed conv held to
    the same limits, timed beside its plain version (LeakyReLU + cuDNN +
    adds) and cuDNN's convolution alone, and the whole V1 generator held to
    its launches and to float64 beside the module chain."""
    import torch.nn.functional as F

    from smart_nar_fast_tts_tpu_torch.kernels import _build, resblock
    torch.manual_seed(25)
    lib = _build.load("hifigan_resblock", resblock._SIGNATURES)
    worst = {"kernel": 0.0, "cudnn": 0.0, "ratio": 0.0}
    bad = []

    def held(case, kerr, cerr):
        worst.update(kernel=max(worst["kernel"], kerr),
                     cudnn=max(worst["cudnn"], cerr),
                     ratio=max(worst["ratio"], kerr / max(cerr, 1e-12)))
        if rb_off(kerr, cerr):
            bad.append(dict(case=case, kernel=kerr, cudnn=cerr))

    with Phase("kernel hifigan_resblock checks") as f:
        cases = []
        for chans, ks, dils in (RB_V1, RB_V3):
            for c in chans:
                for k, ds in zip(ks, dils):
                    for d in ds:
                        for b, t, mode in ((1, 997, (c + k + d) % 3),
                                           (3, 1024, 2), (2, 7, 1)):
                            cases.append((b, c, t, k, d, mode, -1))
        for tile in range(lib.hifigan_resblock_tiles()):
            for c in (16, 40, 256):
                cases.append((2, c, 2052, 11, 5, tile % 3, tile))
        for case in cases:
            held(list(case), *rb_case(torch, *case))
        f.update(cases=len(cases), worst=dict(worst), bad=bad[:20],
                 tiles=rb_tile_choices(lib))
    timings = []
    for label, b, frames in RB_TIMED:
        for (c, hop), (k, ds) in itertools.product(
                zip(RB_V1[0], RB_HOPS), zip(RB_V1[1], RB_V1[2])):
            d, t = ds[-1], frames * hop
            x = torch.randn(b, c, t, device="cuda")
            w = torch.randn(c, c, k, device="cuda") / (c * k) ** 0.5
            bias = torch.randn(c, device="cuda") * 0.1
            res = torch.randn(b, c, t, device="cuda")
            with torch.inference_mode(), Phase(
                    "kernel hifigan_resblock timing") as f:
                got = kernels.hifigan_resblock_conv(x, w, bias, d, 0.1,
                                                    res=res)
                kerr, cerr = rb_errors(torch, got, x, w, bias, d, res, None,
                                       1.0)
                held([label, b, c, t, k, d, 1, -1], kerr, cerr)
                del got
                ms = device_ms(lambda: kernels.hifigan_resblock_conv(
                    x, w, bias, d, 0.1, res=res), torch, reps=10)
                plain_ms = device_ms(lambda: resblock.resblock_conv_reference(
                    x, w, bias, d, 0.1, res=res), torch, reps=10)
                lib_ms = device_ms(lambda: F.conv1d(
                    x, w, bias, dilation=d, padding=(k - 1) * d // 2),
                    torch, reps=10)
                tiles = {}
                for tile in range(lib.hifigan_resblock_tiles()):
                    if lib.hifigan_resblock_smem_bytes(tile, k, d) <= 232448:
                        tiles[tile] = device_ms(lambda: resblock._launch(
                            x, w, bias, res, None, d, 0.1, 1.0, tile), torch,
                            reps=5)
                bound_ms, by = rb_bound_ms(b, c, c, t, k, 1)
                row = dict(cell=label, B=b, C=c, T=t, k=k, d=d, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=by,
                           share=bound_ms / ms, kernel_vs_f64=kerr,
                           cudnn_vs_f64=cerr,
                           tile=lib.hifigan_resblock_tile_for(b, c, c, t, k,
                                                              d),
                           tile_ms=tiles)
                f.update(row)
                timings.append(row)
    with Phase("kernel hifigan_resblock generator") as f:
        from smart_nar_fast_tts_tpu_torch.serving import committed_vocoder
        gen = committed_vocoder().cuda().eval()
        for p in gen.parameters():
            p.requires_grad_(False)
        out = {}
        for label, b, frames in RB_TIMED:
            mel = torch.randn(b, frames, 80, device="cuda") - 5.0
            kernels.reset_launches()
            with torch.inference_mode():
                wav = gen(mel)
            torch.cuda.synchronize()
            n = kernels.launches()["hifigan_resblock_conv"]
            with torch.enable_grad():
                chain = gen(mel)
            with torch.inference_mode():
                f64 = copy.deepcopy(gen).double()(mel.double())
                ms = device_ms(lambda: gen(mel), torch, reps=5)
            with torch.enable_grad():
                chain_ms = device_ms(lambda: gen(mel), torch, reps=5)
            out[label] = dict(
                B=b, frames=frames, launches=n, ms=ms, chain_ms=chain_ms,
                kernel_vs_f64=float((wav.double() - f64).abs().max()),
                chain_vs_f64=float((chain.double() - f64).abs().max()),
                kernel_vs_chain=float((wav - chain).abs().max()))
            if n != RB_V1_LAUNCHES:
                bad.append(dict(generator=label, launches=n))
            if rb_off(out[label]["kernel_vs_f64"],
                      out[label]["chain_vs_f64"]):
                bad.append(dict(generator=label, **out[label]))
        f.update(out, nvidia_smi=nvidia_smi())
    if bad:
        raise AssertionError(f"hifigan_resblock: {len(bad)} cases off: "
                             f"{bad[:5]}")
    smem = {f"tile {i}, k {k}, d {d}": lib.hifigan_resblock_smem_bytes(i, k, d)
            for i in range(lib.hifigan_resblock_tiles())
            for k, d in ((3, 1), (11, 5))}
    ptxas = {"dynamic_smem_bytes": smem}
    if "hifigan_resblock" in compiled:
        ptxas.update(compiled["hifigan_resblock"]["kernels"])
        ptxas["build_seconds"] = compiled["hifigan_resblock"]["seconds"]
    else:
        ptxas["kernels"] = "not compiled in this run: the build directory had it"
    return dict(worst=worst, timings=timings, generator=out, ptxas=ptxas,
                launches_generator={k: v["launches"] for k, v in out.items()})


def resblock_only() -> int:
    """``chip_smoke.py --resblock``: build, then
    :func:`kernel_hifigan_resblock` alone."""
    import torch
    sys.path.insert(0, REPO)
    import numpy as np

    from smart_nar_fast_tts_tpu_torch import kernels
    from smart_nar_fast_tts_tpu_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with Phase("build") as f:
        compiled = _build.build_all()
        f.update(compiled={k: {"seconds": v["seconds"], "ptxas": v["ptxas"]}
                           for k, v in compiled.items()})
    emit({"hifigan_resblock": kernel_hifigan_resblock(torch, np, kernels,
                                                      compiled)})
    return 0


def ring_witness_only() -> int:
    """``chip_smoke.py --ring-witness``: :func:`md_ring_witness` alone on
    one card without a process group (the ring of one block that world 1
    runs), on the multi_device phase's SP batch."""
    import torch
    sys.path.insert(0, REPO)
    import numpy as np

    from smart_nar_fast_tts_tpu_torch.config import ModelConfig
    from smart_nar_fast_tts_tpu_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(nvidia_smi(), flush=True)
    inv = bench_inputs(np)[2]
    cfg = ModelConfig(duration_extraction="intended",
                      duration_head_reduce="first", sequence_parallel=True)
    with Phase("ring witness") as f:
        f["layers"] = md_ring_witness(
            torch, md_flagship(cfg), sp_batch(torch, np, inv, SP_T, 5),
            make_mesh((1,), ("data",)), 0)
    return 0


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
    second = kernel_widths(torch, np, kernels, compiled)

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
    cli_counts, cli_errs, cli = cli_phase(torch, np, kernels)
    stream_counts, stream_cli = streaming_phase(torch, np, kernels, synth,
                                                short, cli)
    bf16_counts, bf16_long_counts = bf16_serving_phase(
        torch, np, kernels, synth, short, wav, texts, src_lens)
    v3_counts = v3_phase(torch, np, kernels, short)
    exported_counts = export_phase(torch, np, kernels, cli)
    pre_counts, pre_train_counts = preprocess_phase(torch, np, kernels, cli)
    import_counts, ref_path = import_phase(torch, np, kernels, cli)
    import_counts.update(import_resume_phase(torch, np, kernels, cli,
                                             ref_path))
    train_g2p_phase(torch, np)

    train_counts, train_step_ms = train_phase(torch, np, kernels, synth, inv)
    train_reference_phase(torch, np, inv)
    trainer_runs, val_losses, trainer_argv = trainer_cli_phase(
        torch, np, kernels, synth, inv, train_step_ms, cli)
    trainer_reference_phase(torch, kernels, val_losses, trainer_argv)
    fs_serving, fs_train = fastspeech_phase(torch, np, kernels, synth, inv,
                                            texts, src_lens)
    gan_counts, gan_step_ms = vocoder_train_phase(torch, kernels, synth,
                                                  segments)
    vocoder_train_reference_phase(torch, np)
    voc_cli_counts = train_vocoder_cli_phase(
        torch, np, kernels, synth, short, wav, mel_lens, cli, gan_step_ms)
    fam_counts, served = families_serving_phase(torch, np, kernels, texts,
                                                src_lens)
    fam_stream_counts = families_streaming_phase(torch, np, kernels, served)
    fam_cli_counts = train_vocoder_families_phase(torch, np, kernels, served,
                                                  cli, segments)
    vocos_export_counts = export_vocos_phase(torch, np, kernels, served, cli)
    world, md_ranks = multi_device_phase(torch, np, kernels, synth, inv,
                                         short, segments)
    md_cli = multi_device_cli_phase(torch, kernels, world, trainer_argv, cli)

    def later_launches(name):
        """A kernel's launches on the streaming vocoder's path (its
        windows and the CLI's --stream_chunk run), bf16 serving (cap 1000
        / cap 4096), the HiFi-GAN V3 forward, one served call of the
        exported artifacts per text, the Vocos and MelGAN paths (a
        serving batch, the streaming windows, 4 steps of cli.train_vocoder
        and one served call of the Vocos export), and the imported
        checkpoint's runs: cli.synthesize (a) and (b), cli.evaluate (from
        it and from the directly saved one) and the resumed cli.train."""
        def get(counts):
            return counts.get(name, 0)

        def per_rank(path):
            return [get(path(r)) for r in md_ranks]
        multi_device = {
            "world": world,
            f"DP {MD_TRAIN_STEPS} train steps": per_rank(
                lambda r: r["dp"]["launches"]),
            f"SP step T {SP_T} (committed, seeded)": per_rank(
                lambda r: {k: r["sp committed"]["launches"][k]
                           + r["sp seeded"]["launches"][k]
                           for k in r["sp seeded"]["launches"]}),
            f"SP step T {SP_T_LONG}": per_rank(
                lambda r: r["sp_long"]["launches"]),
            f"DP {MD_GAN_STEPS} GAN steps": per_rank(
                lambda r: r["gan"]["launches"]),
            **{f"torchrun cli.{run}": [get(r["launches"])
                                       for r in md_cli[run]["ranks"]]
               for run in md_cli}}
        if world >= 4:
            multi_device[f"hybrid step T {SP_T}"] = per_rank(
                lambda r: r["hybrid"]["launches"])
        return dict(
            launches_multi_device=multi_device,
            launches_per_serving_batch_family={
                k: get(c) for k, c in fam_counts.items()},
            launches_streaming_family={
                k: get(c) for k, c in fam_stream_counts.items()},
            launches_cli_train_vocoder_family={
                k: get(c) for k, c in fam_cli_counts.items()},
            launches_exported_vocos=get(vocos_export_counts),
            launches_cli_import={k: get(c) for k, c in import_counts.items()},
            launches_streaming={"windows": get(stream_counts),
                                "cli": get(stream_cli["cli"])},
            launches_bf16_serving={"cap1000": get(bf16_counts),
                                   "cap4096": get(bf16_long_counts)},
            launches_hifigan_v3=get(v3_counts),
            launches_exported={f"synthesize ({k})": get(c)
                               for k, c in exported_counts.items()})

    entries["hifigan_resblock_conv"] = dict(
        route="cuda",
        source="smart_nar_fast_tts_tpu_torch/csrc/hifigan_resblock.cu",
        replaces="none: the JAX package's HiFi-GAN convolutions are XLA's",
        **kernel_hifigan_resblock(torch, np, kernels, compiled))

    # each kernel's launches on its path's run: flash attention on the
    # cap-4096 serving batch, upsampling and alignment attention over the
    # training steps, the log-mel kernel over the GAN steps, the resblock
    # kernel on the cap-1000 serving batch (its V1 forward)
    paths = {"flash_attention": ("serving stage A at cap 4096", long_counts),
             "gaussian_upsample_banded": (f"{TRAIN_STEPS} train steps",
                                          train_counts),
             "alignment_attention": (f"{TRAIN_STEPS} train steps",
                                     train_counts),
             "fused_log_mel": (f"{VOC_STEPS} GAN steps", gan_counts),
             "hifigan_resblock_conv": ("serving batch at cap 1000",
                                       serving)}
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
                          for run, c in cli_counts.items()},
            launches_fastspeech_width=fs_serving[name] + fs_train[name],
            launches_fastspeech_width_runs={
                "serving stage A at cap 4096": fs_serving[name],
                f"{FS_TRAIN_STEPS} train steps": fs_train[name]},
            launches_cli_train={run: r["launches"][name]
                                for run, r in trainer_runs.items()},
            launches_cli_train_vocoder=voc_cli_counts[name],
            launches_cli_preprocess=pre_counts[name],
            launches_cli_preprocess_train=pre_train_counts[name],
            **later_launches(name))
    entries["flash_attention"]["fastspeech_width_path"] = (
        "FastSpeech widths (head dim 192), serving stage A at cap 4096")
    entries["alignment_attention"]["fastspeech_width_path"] = (
        f"FastSpeech widths (head dim 192), {FS_TRAIN_STEPS} train steps")
    # the further kernels: no driven path has a head dim past 256 or an
    # n_fft that is not a power of two, so each counts 0 on every path
    sources = {
        "flash_attention_wide": (
            "smart_nar_fast_tts_tpu_torch/csrc/flash_attention.cu",
            "smart_nar_fast_tts_tpu/ops/pallas/attention.py:52"),
        "alignment_attention_wide": (
            "smart_nar_fast_tts_tpu_torch/csrc/alignment_attention.cu",
            "smart_nar_fast_tts_tpu/ops/pallas/alignment.py:67"),
        "fused_log_mel_mixed": (
            "smart_nar_fast_tts_tpu_torch/csrc/log_mel.cu",
            "smart_nar_fast_tts_tpu/ops/pallas/stft.py:46"),
        "fused_log_mel_dft": (
            "smart_nar_fast_tts_tpu_torch/csrc/log_mel.cu",
            "smart_nar_fast_tts_tpu/ops/pallas/stft.py:46")}
    for name, entry in second.items():
        source, replaces = sources[name]
        launched = {run: c["launches"][name] for run, c in cli_counts.items()}
        entries[name] = dict(
            route="cuda", source=source, replaces=replaces,
            launches=launched["long"], launches_cli=launched,
            launches_cli_train={run: r["launches"][name]
                                for run, r in trainer_runs.items()},
            launches_cli_train_vocoder=voc_cli_counts[name],
            launches_cli_preprocess=pre_counts[name],
            launches_cli_preprocess_train=pre_train_counts[name],
            launches_fastspeech_width=fs_serving[name] + fs_train[name],
            **later_launches(name),
            path="none: the driven paths have head dims 128 and 192 and "
                 "n_fft 1024", **entry)
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
    if sys.argv[1:2] == ["--rank-cli"]:
        sys.exit(rank_cli(sys.argv[2:]))
    if sys.argv[1:2] == ["--multi-device"]:
        sys.exit(multi_device_only(sys.argv[2:]))
    if sys.argv[1:2] == ["--ring-witness"]:
        sys.exit(ring_witness_only())
    if sys.argv[1:2] == ["--resblock"]:
        sys.exit(resblock_only())
    sys.exit(main())
