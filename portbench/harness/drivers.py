"""The measured windows: set-up, window and the check of what the window
produced, for each traffic mode.

- ``closed``: the mix's batches dispatched back to back, cycled, each
  through the entry the mix names (``synthesize``: ``Synthesizer.
  synthesize``; ``stages``: ``stage_a``, then ``stage_b`` on the mel cut
  at the batch's longest valid length), waveforms copied to the host.
  Set-up runs every batch of the mix once.  Batches start while the window
  lasts; the window closes when the last one is on the host, so the rate
  is all the work over all the time.
- ``open``: requests arrive at their scheduled times; whenever the program
  is free, every waiting request (up to ``max_batch``) goes into one
  ``synthesize`` call.  A request's latency runs from its scheduled arrival
  to its waveform on the host; every request scheduled in the window is
  served, after the window if need be.  Set-up runs each batch size at
  each vocoder bucket once.
- ``train``: set-up builds the train state and step and drives it through
  its first ``check_steps`` steps on distinct batches (kept for the
  check); the window goes on stepping the same state, cycling the mix's
  batches.
"""

from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..reference import fastspeech2 as ref_acoustic
from ..reference import train as ref_train
from . import check, program, traffic, weights

HOST = "cpu"


@dataclass
class Outcome:
    """What a run measured: end-to-end values, the per-layer record, and
    the comparison's numbers."""

    metrics: dict[str, float]
    attempted: int
    failed: int
    record: dict = field(default_factory=dict)
    numbers: dict[str, float] = field(default_factory=dict)
    # the control's numbers, by precision
    control: Optional[dict[str, dict[str, float]]] = None
    peak_bytes: int = 0


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Events:
    """Device time of calls by CUDA events (host clock around a synchronise
    on the CPU), summed per name."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.pending: list[tuple[str, object, object]] = []
        self.total: dict[str, float] = {}
        self.count: dict[str, int] = {}

    def wrap(self, name, fn):
        def timed(*a, **k):
            if self.cuda:
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = fn(*a, **k)
                e.record()
            else:
                s = time.perf_counter()
                out = fn(*a, **k)
                e = time.perf_counter()
            self.pending.append((name, s, e))
            return out
        return timed

    def settle(self) -> None:
        for name, s, e in self.pending:
            ms = s.elapsed_time(e) if self.cuda else (e - s) * 1e3
            self.total[name] = self.total.get(name, 0.0) + ms
            self.count[name] = self.count.get(name, 0) + 1
        self.pending.clear()


# ----------------------------------------------------------------- serving

class Serving:
    """The program's ``Synthesizer`` on the benchmark's weights, and the
    reference on the same weights."""

    def __init__(self, cfg, spec, seed, device, mix):
        self.cfg, self.spec, self.seed, self.device = cfg, spec, seed, device
        self.a, self.v = cfg["acoustic"], cfg["vocoder"]
        self.ref_v = importlib.import_module(
            f"portbench.reference.{cfg['reference']['vocoder']}")
        self.hop = self.v["hop_length"]
        self.sr = self.v["sampling_rate"]
        self.bias = self._calibrate(mix)

    def weights(self, calibrated: bool = True):
        """(acoustic, vocoder) weights of the seed; ``calibrated``: the
        duration head's bias set by ``_calibrate``."""
        a, v = self.a, self.v
        Wa = weights.make(ref_acoustic.shapes(a), self.seed, 1, self.device)
        name = "variance_adaptor.duration_predictor.linear_layer"
        Wa[name + ".weight"] = Wa[name + ".weight"] * \
            self.cfg["weights"]["duration_head_scale"]
        if calibrated:
            Wa[name + ".bias"] = torch.full_like(Wa[name + ".bias"],
                                                 self.bias)
        Wv = weights.make(self.ref_v.shapes(v), self.seed, 2, self.device,
                          layers=v.get("n_layers", 1))
        return Wa, Wv

    @torch.inference_mode()
    def _calibrate(self, mix) -> float:
        """The duration head's bias: the one at which the reference's own
        durations over the mix's phonemes total F frames a phoneme
        (bisection on the head's output before its bias), so that every
        seed's model speaks the same number of frames."""
        Wa, _ = self.weights(calibrated=False)
        ids, lens = traffic.pad(mix.sentences, [max(
            len(s) for s in mix.sentences)])
        ids, lens = torch.as_tensor(ids, device=self.device), \
            torch.as_tensor(lens, device=self.device)
        log_d, valid = ref_acoustic.log_durations(Wa, self.a, ids, lens)
        b = float(Wa["variance_adaptor.duration_predictor.linear_layer.bias"])
        pre = (log_d - b)[valid].double().cpu().numpy()
        target = self.cfg["weights"]["frames_per_phoneme"] * len(pre)
        lo, hi = -20.0, 20.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            frames = np.maximum(np.round(np.exp(pre + mid) - 1.0), 0).sum()
            lo, hi = (mid, hi) if frames < target else (lo, mid)
        return hi

    def build(self):
        from smart_nar_fast_tts_tpu_torch.serving import Synthesizer
        Wa, Wv = self.weights()
        synth = Synthesizer(program.acoustic(self.cfg, Wa),
                            program.vocoder(self.cfg, Wv), device=self.device,
                            t_cap=self.spec["t_cap"])
        return synth

    def bins(self, pitch, energy) -> np.ndarray:
        """(2, B, T) pitch and energy bin indices of the predictions, by the
        configuration's quantization."""
        st, n = self.a["stats"], self.a["variance_embedding"]["n_bins"]
        return np.stack([check.to_host(torch.bucketize(x, ref_acoustic.bins(
            st[f"{f}_min"], st[f"{f}_max"], n, x.device))).astype(np.int64)
            for f, x in (("pitch", pitch), ("energy", energy))])

    def cut(self, mel_lens: np.ndarray) -> int:
        """Frames the vocoder runs on: the bucket of the batch's longest
        (``synthesize``), or the longest itself (``stages``)."""
        n = int(mel_lens.max())
        if self.spec["entry"] == "stages":
            return n
        buckets = self.spec["vocoder_buckets"]
        return next((b for b in buckets if n <= b), buckets[-1])

    @torch.inference_mode()
    def reference(self, Wa, Wv, ids, lens, items, force=None, tf32=False,
                  low=None):
        """The reference's outputs for one batch, as ``check.ServingTally``
        takes them: ``force`` (durations (B, L), bins (2, B, T)) sets the
        discrete decisions to the judged side's, and each item carries the
        reference's own; ``tf32``/``low``: the control's precision."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        dev = self.device
        try:
            ro = ref_acoustic.forward(
                Wa, self.a, torch.as_tensor(ids, device=dev),
                torch.as_tensor(lens, device=dev), t_cap=self.spec["t_cap"],
                bf16_past=self.cfg["precision"]["attention_bf16_past"],
                low=low or torch.bfloat16,
                force_durations=None if force is None else
                torch.as_tensor(force[0], device=dev),
                force_bins=None if force is None else
                torch.as_tensor(force[1], device=dev))
            mel_lens = check.to_host(ro.mel_lens).astype(np.int64)
            cut = self.cut(mel_lens)
            wav = check.to_host(self.ref_v.forward(Wv, self.v,
                                                   ro.postnet_mel[:, :cut]))
            own = check.to_host(ro.own_duration)
            bins = check.to_host(ro.own_bins).astype(np.int64)
            mel = check.to_host(ro.postnet_mel)
            used = (check.to_host(ro.duration), bins if force is None
                    else np.asarray(force[1]))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev[0]
            torch.backends.cudnn.allow_tf32 = prev[1]
        return {"mel_lens": mel_lens, "cut": cut, "hop": self.hop,
                "force": used, "own_durations": own, "lens": np.asarray(lens),
                "items": {i: (own[i, :lens[i]], bins[:, i, :mel_lens[i]],
                              mel[i, :mel_lens[i]],
                              wav[i, :mel_lens[i] * self.hop])
                          for i in items}}


class _Capture:
    """The acoustic model's last output (a forward hook): what the timed
    path derived inside ``synthesize``, read for the check."""

    def __init__(self, model):
        self.out = None
        self.handle = model.register_forward_hook(self._hook)

    def _hook(self, module, args, out):
        self.out = out


def _run_entry(synth, spec, ids, lens, tracer):
    """One batch through the cell's entry; returns (wav on the device, the
    vocoder's frames, mel_lens on the host)."""
    if spec["entry"] == "synthesize":
        with tracer.span("synthesize"):
            wav, mel_lens = synth.synthesize(ids, lens)
    else:
        with tracer.span("stage_a"):
            out = synth.stage_a(torch.as_tensor(ids), torch.as_tensor(lens))
        with tracer.span("host_sync"):
            n = int(out.mel_lens.max())
        with tracer.span("stage_b"):
            wav = synth.stage_b(out.postnet_mel[:, :n])
        mel_lens = out.mel_lens
    with tracer.span("host_copy"):
        wav_h = wav.to(HOST)
        mel_lens_h = mel_lens.to(HOST).numpy().astype(np.int64)
    return wav_h, mel_lens_h


def _keep(capture, wav_h, mel_lens_h, lens, items, hop):
    out = capture.out
    return {"dur": out.duration_rounded.detach().clone(),
            "mel": out.postnet_mel.detach().clone(),
            "pitch": out.pitch_prediction.detach().clone(),
            "energy": out.energy_prediction.detach().clone(),
            "wav": wav_h, "mel_lens": mel_lens_h, "lens": lens,
            "items": items, "hop": hop}


def _settle_kept(k, srv):
    dur, mel = check.to_host(k["dur"]), check.to_host(k["mel"])
    bins = srv.bins(k["pitch"], k["energy"])
    wav = k["wav"].float().numpy()
    ml, lens = k["mel_lens"], k["lens"]
    return {"mel_lens": ml, "cut": wav.shape[1] // k["hop"], "hop": k["hop"],
            "force": (dur, bins),
            "items": {i: (dur[i, :lens[i]], bins[:, i, :ml[i]],
                          mel[i, :ml[i]], wav[i, :ml[i] * k["hop"]])
                      for i in k["items"]}}


def _instrument(synth, tracer, events):
    """In a traced run: CUDA events and spans around the stages."""
    if not tracer.on:
        return
    for name in ("stage_a", "stage_b"):
        fn = getattr(synth, name)

        def spanned(*a, _fn=fn, _name=name, **k):
            with tracer.span(_name):
                return _fn(*a, **k)
        setattr(synth, name, events.wrap(name, spanned))


def _upsample_record(capture, lens):
    out = capture.out
    return {"B": int(out.duration_rounded.shape[0]),
            "L": int(out.duration_rounded.shape[1]),
            "T": int(out.mel_valid.shape[1]),
            "durations": check.to_host(out.duration_rounded),
            "src_lens": np.asarray(lens)}


def serve_closed(ctx) -> Outcome:
    spec, cfg, dev = ctx.spec, ctx.cfg, ctx.device
    mix = traffic.generate(spec, ctx.seed, cfg["acoustic"]["vocab_size"])
    srv = Serving(cfg, spec, ctx.seed, dev, mix)
    synth = ctx.build(srv)
    capture = _Capture(synth.model)
    events = _Events(dev)
    pool = [traffic.pad([mix.sentences[i] for i in b], spec["text_buckets"])
            for b in mix.batches]
    with torch.inference_mode():
        for ids, lens in pool:
            _run_entry(synth, spec, ids, lens, ctx.tracer)
    _sync(dev)
    ctx.setup_done()

    # the cycle starts at the batch holding the longest sentence; it and the
    # next check_batches - 1 (the seed's batches) are compared
    longest = int(np.argmax([lens.max() for _, lens in pool]))
    pool = pool[longest:] + pool[:longest]
    sample = set(range(min(spec["check_batches"], len(pool))))
    _instrument(synth, ctx.tracer, events)
    kept, record, frames, items, k = {}, [], 0, 0, 0
    t0 = time.perf_counter()
    with torch.inference_mode(), ctx.tracer.window():
        while time.perf_counter() - t0 < ctx.seconds:
            p = k % len(pool)
            ids, lens = pool[p]
            wav_h, mel_lens_h = _run_entry(synth, spec, ids, lens,
                                           ctx.tracer)
            frames += int(mel_lens_h.sum())
            items += len(lens)
            if p in sample and p not in kept:
                kept[p] = _keep(capture, wav_h, mel_lens_h, lens,
                                range(len(lens)), srv.hop)
            if ctx.tracer.on:
                record.append(dict(_upsample_record(capture, lens),
                                   mel_lens=mel_lens_h))
            k += 1
        t1 = time.perf_counter()
    window = t1 - t0
    events.settle()
    audio = frames * srv.hop / srv.sr
    out = Outcome(metrics={"serve_audio_s_per_s": audio / window},
                  attempted=items, failed=0)
    out.record = {"batches": k, "window_s": window, "events": events,
                  "launches": record, "audio_s": audio}
    out.peak_bytes = ctx.peak_bytes()
    capture.handle.remove()
    got = {p: _settle_kept(v, srv) for p, v in kept.items()}
    del synth, capture, kept
    ctx.free()
    _serving_check(ctx, srv, out, {p: (pool[p], got[p]) for p in got})
    return out


def _controls(cfg, spec) -> dict[str, tuple[bool, torch.dtype]]:
    """The serving control's precisions, by name: (TF32 on, the attention's
    type past the configuration's bf16 length).  TF32 for the float32
    parts; where the cell's frames reach the bf16 attention, fp8 for it,
    alone and with TF32."""
    out = {"tf32": (True, torch.bfloat16)}
    if spec["t_cap"] > cfg["precision"]["attention_bf16_past"]:
        out.update(fp8=(False, torch.float8_e4m3fn),
                   tf32_fp8=(True, torch.float8_e4m3fn))
    return out


def _serving_check(ctx, srv, out, batches):
    Wa, Wv = srv.weights()
    tally = check.ServingTally()
    controls = _controls(ctx.cfg, ctx.spec) if ctx.control else {}
    tallies = {name: check.ServingTally() for name in controls}
    for (ids, lens), got in batches.values():
        tally.add(got, srv.reference(Wa, Wv, ids, lens, got["items"],
                                     force=got["force"]))
        for name, (tf32, low) in controls.items():
            ctl = srv.reference(Wa, Wv, ids, lens, got["items"], tf32=tf32,
                                low=low)
            tallies[name].add(ctl, srv.reference(
                Wa, Wv, ids, lens, got["items"], force=ctl["force"]))
    out.numbers = tally.numbers()
    out.record["compared_items"] = tally.compared
    if ctx.control:
        out.control = {name: t.numbers() for name, t in tallies.items()}


def serve_open(ctx) -> Outcome:
    spec, cfg, dev = ctx.spec, ctx.cfg, ctx.device
    mix = traffic.generate(spec, ctx.seed, cfg["acoustic"]["vocab_size"],
                           seconds=ctx.seconds, rate=ctx.rate)
    srv = Serving(cfg, spec, ctx.seed, dev, mix)
    synth = ctx.build(srv)
    capture = _Capture(synth.model)
    events = _Events(dev)
    n_mels = cfg["acoustic"]["n_mel_channels"]
    L = max(spec["text_buckets"])
    with torch.inference_mode():
        for b in range(1, spec["max_batch"] + 1):
            ids = np.ones((b, L), dtype=np.int64)
            synth.stage_a(torch.as_tensor(ids),
                          torch.full((b,), L, dtype=torch.long))
            for t in spec["vocoder_buckets"]:
                synth.stage_b(torch.zeros((b, t, n_mels), device=dev))
    _sync(dev)
    ctx.setup_done()

    arrivals = mix.arrivals
    n = len(arrivals)
    rng = np.random.default_rng(traffic.sub_seed(ctx.seed, 3))
    lengths = np.array([len(mix.sentences[s]) for s in mix.request_sentence])
    sample = set(rng.choice(n, size=min(spec["check_requests"], n),
                            replace=False).tolist())
    sample.add(int(np.argmax(lengths)))
    _instrument(synth, ctx.tracer, events)
    done = np.full(n, np.nan)
    fills, service, kept = [], [], {}
    nxt = 0
    t0 = time.perf_counter()
    with torch.inference_mode(), ctx.tracer.window():
        while nxt < n:
            now = time.perf_counter() - t0
            if arrivals[nxt] > now:
                with ctx.tracer.span("wait"):
                    time.sleep(arrivals[nxt] - now)
                continue
            take = [nxt]
            while (len(take) < spec["max_batch"] and nxt + len(take) < n
                   and arrivals[nxt + len(take)] <= now):
                take.append(nxt + len(take))
            nxt += len(take)
            ids, lens = traffic.pad(
                [mix.sentences[mix.request_sentence[r]] for r in take],
                spec["text_buckets"])
            s = time.perf_counter()
            wav_h, mel_lens_h = _run_entry(synth, spec, ids, lens,
                                           ctx.tracer)
            e = time.perf_counter()
            done[take] = e - t0
            fills.append(len(take))
            service.append(e - s)
            mine = [i for i, r in enumerate(take) if r in sample]
            if mine:
                kept[take[0]] = ((ids, lens), _keep(
                    capture, wav_h, mel_lens_h, lens, mine, srv.hop))
        t1 = time.perf_counter()
    events.settle()
    latency = done - arrivals
    failed = int(np.isnan(latency).sum())
    lat = np.where(np.isnan(latency), np.inf, latency)
    p95 = float(np.quantile(lat, 0.95, method="higher")) * 1e3
    out = Outcome(metrics={"serve_p95_ms": p95}, attempted=n, failed=failed)
    out.record = {"batches": len(fills), "window_s": t1 - t0,
                  "events": events, "fills": fills, "service_s": service,
                  "latency_ms_p50": float(np.median(lat)) * 1e3,
                  # a backlog that grows: the last quarter's mean latency
                  # over the first quarter's
                  "backlog_growth": float(np.mean(lat[-(n // 4 or 1):])
                                          / np.mean(lat[:n // 4 or 1]))}
    out.peak_bytes = ctx.peak_bytes()
    capture.handle.remove()
    got = {r: (b, _settle_kept(v, srv)) for r, (b, v) in kept.items()}
    del synth, capture, kept
    ctx.free()
    _serving_check(ctx, srv, out, got)
    return out


# ---------------------------------------------------------------- training

def _train_batches(spec, mix, seed, device, n_mels):
    """The mix's batches on the device: token ids padded to the text
    bucket, frames about ``frames_per_phoneme`` a phoneme (a fixed set of
    jitters in the seed's order) up to ``mel_pad``, and normal mel, pitch
    and energy targets drawn on the device."""
    g = torch.Generator(device=device).manual_seed(traffic.sub_seed(seed, 5))
    rng = np.random.default_rng(traffic.sub_seed(seed, 6))
    n = len(mix.sentences)
    jit = spec["frames_jitter"] * (2.0 * (np.arange(n) + 0.5) / n - 1.0)
    jit = jit[rng.permutation(n)]
    T = spec["mel_pad"]
    out = []
    for b in mix.batches:
        ids, lens = traffic.pad([mix.sentences[i] for i in b],
                                spec["text_buckets"])
        mel_lens = np.minimum(T, np.rint(lens * spec["frames_per_phoneme"]
                                         * (1.0 + jit[b])).astype(np.int64))
        B = len(b)
        out.append({
            "texts": torch.as_tensor(ids, device=device),
            "src_lens": torch.as_tensor(lens, device=device),
            "mels": torch.randn((B, T, n_mels), generator=g, device=device)
            * 2.0 - 5.0,
            "mel_lens": torch.as_tensor(mel_lens, device=device),
            "pitch": torch.randn((B, T), generator=g, device=device),
            "energy": torch.randn((B, T), generator=g, device=device),
            "src_np": lens, "mel_np": mel_lens})
    return out


def train(ctx) -> Outcome:
    from smart_nar_fast_tts_tpu_torch.config import OptimizerConfig
    from smart_nar_fast_tts_tpu_torch.data.batch import Batch
    from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Loss
    from smart_nar_fast_tts_tpu_torch.training import (create_train_state,
                                                       make_train_step)
    spec, cfg, dev = ctx.spec, ctx.cfg, ctx.device
    a, o = cfg["acoustic"], cfg["optimizer"]
    mix = traffic.generate(spec, ctx.seed, a["vocab_size"])
    batches = _train_batches(spec, mix, ctx.seed, dev, a["n_mel_channels"])
    feed = [Batch(b["texts"], b["src_lens"], b["mels"], b["mel_lens"],
                  b["pitch"], b["energy"]) for b in batches]
    shapes = ref_acoustic.shapes(a)
    gen_seed = traffic.sub_seed(ctx.seed, 7)

    def initial():
        return weights.make(shapes, ctx.seed, 1, dev)

    model = ctx.build_acoustic(initial())
    state = create_train_state(model, OptimizerConfig(
        betas=tuple(o["betas"]), eps=o["eps"],
        weight_decay=o["weight_decay"],
        grad_clip_thresh=o["grad_clip_thresh"],
        warm_up_step=o["warm_up_step"]), device=dev)
    step = ctx.make_step(make_train_step(FastSpeech2Loss(
        program.preprocess_config(cfg))))
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    names = [n for n, _ in model.named_parameters()]
    steps = spec["check_steps"]
    losses = []
    for s in range(steps):
        losses.append(torch.stack(list(step(state, feed[s], gen))))
        if s == 0:
            beta1 = o["betas"][0]
            first = torch.stack([
                torch.linalg.vector_norm(state.optimizer.state[p]["exp_avg"])
                if p in state.optimizer.state else torch.zeros((), device=dev)
                for p in state.params]) / (1.0 - beta1)
    W0 = initial()
    change = torch.stack([torch.linalg.vector_norm(p.detach() - W0[n])
                          for n, p in model.named_parameters()])
    del W0
    got = {"losses": check.to_host(torch.stack(losses)).tolist(),
           "grad": dict(zip(names, check.to_host(first).tolist())),
           "change": dict(zip(names, check.to_host(change).tolist()))}
    _sync(dev)
    ctx.setup_done()

    events = _Events(dev)
    timed = events.wrap("step", step) if ctx.tracer.on else step
    k, window_losses, frames, record = steps, [], 0, []
    t0 = time.perf_counter()
    with ctx.tracer.window():
        while time.perf_counter() - t0 < ctx.seconds:
            b = batches[k % len(batches)]
            with ctx.tracer.span("step"):
                lb = timed(state, feed[k % len(batches)], gen)
            window_losses.append(lb.total)
            frames += int(b["mel_np"].sum())
            if ctx.tracer.on:
                record.append({"src_lens": b["src_np"],
                               "mel_lens": b["mel_np"],
                               "B": len(b["src_np"]),
                               "L": int(b["texts"].shape[1]),
                               "T": int(b["mels"].shape[1])})
            k += 1
        _sync(dev)
        t1 = time.perf_counter()
    events.settle()
    window = t1 - t0
    n_steps = k - steps
    finite = check.to_host(torch.isfinite(torch.stack(window_losses)))
    audio = frames * cfg["vocoder"]["hop_length"] / \
        cfg["vocoder"]["sampling_rate"]
    out = Outcome(metrics={"train_audio_s_per_s": audio / window},
                  attempted=n_steps, failed=int((~finite.astype(bool)).sum()))
    out.record = {"steps": n_steps, "window_s": window, "events": events,
                  "launches": record, "audio_s": audio}
    out.peak_bytes = ctx.peak_bytes()
    del state, model, step, feed
    ctx.free()

    ref = ref_train.run(initial(), cfg, batches[:steps], gen_seed, steps)
    out.numbers = check.training_numbers(got, ref)
    if ctx.control:
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            ctl = ref_train.run(initial(), cfg, batches[:steps], gen_seed,
                                steps)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev[0]
            torch.backends.cudnn.allow_tf32 = prev[1]
        out.control = {"tf32": check.training_numbers(ctl, ref)}
    return out


MODES = {"closed": serve_closed, "open": serve_open, "train": train}
