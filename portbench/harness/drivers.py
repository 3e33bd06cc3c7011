"""The measured windows: set-up, window and the check of what the window
produced, for each traffic mode.  What belongs to a model family (its
weights, its program, its inputs and outputs, its reference) comes from
the configuration's family files (``families.py``).

- ``closed``: the mix's batches dispatched back to back, cycled, each
  through the entry the mix names (``synthesize``: the program's
  ``synthesize``; ``stages``: ``stage_a``, then ``stage_b`` on the mel cut
  at the batch's longest valid length), waveforms copied to the host.
  Set-up runs every batch of the mix once.  Batches start while the window
  lasts; the window closes when the last one is on the host, so the rate
  is all the work over all the time.
- ``open``: requests arrive at their scheduled times; whenever the program
  is free, every waiting request (up to ``max_batch``) goes into one
  ``synthesize`` call.  A request's latency runs from its scheduled arrival
  to its waveform on the host; every request scheduled in the window is
  served, after the window if need be.  Set-up is the acoustic family's
  ``warm``.
- ``train``: set-up builds the train state and step and drives it through
  its first ``check_steps`` steps on distinct batches (kept for the
  check); the window goes on stepping the same state, cycling the mix's
  batches.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import check, traffic

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


class _Precision:
    """TF32 on or off for matrix products and convolutions inside the
    block, as before it after."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.prev[0]
        torch.backends.cudnn.allow_tf32 = self.prev[1]


# ----------------------------------------------------------------- serving

@dataclass
class Batch:
    """Requests in one call: token ids (B, L) padded to the text bucket,
    their lengths (B,), and the mix's sentences they carry, by which a
    family finds inputs of its own that it drew for them."""

    ids: np.ndarray
    lens: np.ndarray
    index: list[int]


class Serving:
    """The program on the benchmark's weights, and the reference on the
    same weights: the acoustic family's ``Serving`` (``acoustic``) and the
    vocoder family (``vocoder``) put together."""

    def __init__(self, ctx, mix):
        cfg, spec = ctx.cfg, ctx.spec
        self.cfg, self.spec, self.seed, self.device = cfg, spec, ctx.seed, \
            ctx.device
        self.mix = mix
        self.acoustic = ctx.acoustic.Serving(cfg, spec, ctx.seed, ctx.device,
                                             mix)
        self.vocoder = ctx.vocoder
        self.decisions = getattr(ctx.acoustic, "Decisions", None)
        self.hop = cfg["vocoder"]["hop_length"]
        self.sr = cfg["vocoder"]["sampling_rate"]

    def weights(self):
        """(acoustic, vocoder) weights of the seed."""
        return self.acoustic.weights(), self.vocoder.draw(
            self.cfg["vocoder"], self.seed, self.device)

    def build(self):
        Wa, Wv = self.weights()
        return self.acoustic.build(Wa, self.vocoder.build(self.cfg["vocoder"],
                                                          Wv))

    def batch(self, index) -> Batch:
        ids, lens = traffic.pad([self.mix.sentences[i] for i in index],
                                self.spec["text_buckets"])
        return Batch(ids, lens, list(index))

    def tally(self) -> check.ServingTally:
        return check.ServingTally(None if self.decisions is None
                                  else self.decisions())

    def cut(self, mel_lens: np.ndarray) -> int:
        """Frames the vocoder runs on: the bucket of the batch's longest
        (``synthesize``), or the longest itself (``stages``)."""
        n = int(mel_lens.max())
        if self.spec["entry"] == "stages":
            return n
        buckets = self.spec["vocoder_buckets"]
        return next((b for b in buckets if n <= b), buckets[-1])

    @torch.inference_mode()
    def reference(self, Wa, Wv, batch, items, force=None, tf32=False,
                  low=None):
        """The reference's outputs for one batch, as ``check.ServingTally``
        takes them: ``force`` sets the discrete decisions to the judged
        side's, and ``own`` carries the reference's own; ``tf32``/``low``:
        the control's precision."""
        with _Precision(tf32):
            mel, mel_lens, own, used = self.acoustic.reference(
                Wa, batch, force=force, low=low)
            cut = self.cut(mel_lens)
            wav = check.to_host(self.vocoder.reference(
                Wv, self.cfg["vocoder"], mel[:, :cut]))
            mel = check.to_host(mel)
        return {"mel_lens": mel_lens, "cut": cut, "hop": self.hop,
                "lens": np.asarray(batch.lens), "own": own, "force": used,
                "items": {i: {"mel": mel[i, :mel_lens[i]],
                              "wav": wav[i, :mel_lens[i] * self.hop]}
                          for i in items}}


class _Capture:
    """The acoustic model's last output (a forward hook): what the timed
    path derived inside ``synthesize``, read for the check."""

    def __init__(self, model):
        self.out = None
        self.handle = model.register_forward_hook(self._hook)

    def _hook(self, module, args, out):
        self.out = out


def _run_entry(synth, srv, batch, tracer):
    """One batch through the cell's entry; returns (wav on the host,
    mel_lens on the host)."""
    if srv.spec["entry"] == "synthesize":
        with tracer.span("synthesize"):
            wav, mel_lens = srv.acoustic.synthesize(synth, batch)
    else:
        with tracer.span("stage_a"):
            mel, mel_lens = srv.acoustic.stage_a(synth, batch)
        with tracer.span("host_sync"):
            n = int(mel_lens.max())
        with tracer.span("stage_b"):
            wav = synth.stage_b(mel[:, :n])
    with tracer.span("host_copy"):
        wav_h = wav.to(HOST)
        mel_lens_h = mel_lens.to(HOST).numpy().astype(np.int64)
    return wav_h, mel_lens_h


def _keep(srv, capture, wav_h, mel_lens_h, items):
    return {"acoustic": srv.acoustic.keep(capture.out), "wav": wav_h,
            "mel_lens": mel_lens_h, "items": items}


def _settle_kept(k, srv, batch):
    mel, own = srv.acoustic.settle(k["acoustic"])
    wav = k["wav"].float().numpy()
    ml, hop = k["mel_lens"], srv.hop
    return {"mel_lens": ml, "cut": wav.shape[1] // hop, "hop": hop,
            "lens": np.asarray(batch.lens), "own": own, "force": own,
            "items": {i: {"mel": mel[i, :ml[i]], "wav": wav[i, :ml[i] * hop]}
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


def serve_closed(ctx) -> Outcome:
    spec, cfg, dev = ctx.spec, ctx.cfg, ctx.device
    mix = traffic.generate(spec, ctx.seed, cfg["acoustic"]["vocab_size"])
    srv = Serving(ctx, mix)
    synth = ctx.build(srv)
    capture = _Capture(srv.acoustic.captured(synth))
    events = _Events(dev)
    pool = [srv.batch(b) for b in mix.batches]
    with torch.inference_mode():
        for batch in pool:
            _run_entry(synth, srv, batch, ctx.tracer)
    _sync(dev)
    ctx.setup_done()

    # the cycle starts at the batch holding the longest sentence; it and the
    # next check_batches - 1 (the seed's batches) are compared
    longest = int(np.argmax([b.lens.max() for b in pool]))
    pool = pool[longest:] + pool[:longest]
    sample = set(range(min(spec["check_batches"], len(pool))))
    _instrument(synth, ctx.tracer, events)
    kept, record, frames, items, k = {}, [], 0, 0, 0
    t0 = time.perf_counter()
    with torch.inference_mode(), ctx.tracer.window():
        while time.perf_counter() - t0 < ctx.seconds:
            p = k % len(pool)
            batch = pool[p]
            wav_h, mel_lens_h = _run_entry(synth, srv, batch, ctx.tracer)
            frames += int(mel_lens_h.sum())
            items += len(batch.lens)
            if p in sample and p not in kept:
                kept[p] = _keep(srv, capture, wav_h, mel_lens_h,
                                range(len(batch.lens)))
            if ctx.tracer.on:
                record.append(dict(srv.acoustic.record(capture.out),
                                   B=len(batch.lens),
                                   src_lens=np.asarray(batch.lens),
                                   mel_lens=mel_lens_h,
                                   vocoder_frames=wav_h.shape[1] // srv.hop))
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
    got = {p: (pool[p], _settle_kept(v, srv, pool[p]))
           for p, v in kept.items()}
    del synth, capture, kept
    ctx.free()
    _serving_check(ctx, srv, out, got)
    return out


def _controls(cfg, spec) -> dict[str, tuple[bool, torch.dtype]]:
    """The serving control's precisions, by name: (TF32 on, the attention's
    type past the configuration's bf16 length).  TF32 for the float32
    parts; where the cell's frames reach the bf16 attention, fp8 for it,
    alone and with TF32."""
    out = {"tf32": (True, torch.bfloat16)}
    past = cfg["precision"].get("attention_bf16_past")
    if past is not None and spec["t_cap"] > past:
        out.update(fp8=(False, torch.float8_e4m3fn),
                   tf32_fp8=(True, torch.float8_e4m3fn))
    return out


def _serving_check(ctx, srv, out, batches):
    Wa, Wv = srv.weights()
    tally = srv.tally()
    controls = _controls(ctx.cfg, ctx.spec) if ctx.control else {}
    tallies = {name: srv.tally() for name in controls}
    for batch, got in batches.values():
        tally.add(got, srv.reference(Wa, Wv, batch, got["items"],
                                     force=got["force"]))
        for name, (tf32, low) in controls.items():
            ctl = srv.reference(Wa, Wv, batch, got["items"], tf32=tf32,
                                low=low)
            tallies[name].add(ctl, srv.reference(
                Wa, Wv, batch, got["items"], force=ctl["force"]))
    out.numbers = tally.numbers()
    out.record["compared_items"] = tally.compared
    if ctx.control:
        out.control = {name: t.numbers() for name, t in tallies.items()}


def serve_open(ctx) -> Outcome:
    spec, cfg, dev = ctx.spec, ctx.cfg, ctx.device
    mix = traffic.generate(spec, ctx.seed, cfg["acoustic"]["vocab_size"],
                           seconds=ctx.seconds, rate=ctx.rate)
    srv = Serving(ctx, mix)
    synth = ctx.build(srv)
    capture = _Capture(srv.acoustic.captured(synth))
    events = _Events(dev)
    with torch.inference_mode():
        srv.acoustic.warm(synth)
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
            batch = srv.batch([mix.request_sentence[r] for r in take])
            s = time.perf_counter()
            wav_h, mel_lens_h = _run_entry(synth, srv, batch, ctx.tracer)
            e = time.perf_counter()
            done[take] = e - t0
            fills.append(len(take))
            service.append(e - s)
            mine = [i for i, r in enumerate(take) if r in sample]
            if mine:
                kept[take[0]] = (batch, _keep(srv, capture, wav_h,
                                              mel_lens_h, mine))
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
    got = {r: (b, _settle_kept(v, srv, b)) for r, (b, v) in kept.items()}
    del synth, capture, kept
    ctx.free()
    _serving_check(ctx, srv, out, got)
    return out


# ---------------------------------------------------------------- training

def train(ctx) -> Outcome:
    """The acoustic family's ``Training`` gives the batches (``feed`` for
    the step, ``records`` of their shapes and valid lengths on the host),
    the weights (``initial``), the port's model, state and step
    (``build``), what the port decides in the first steps (``decisions``,
    a context over the model that fills a dict), the reference's first
    steps given those decisions (``reference``) and numbers of its own
    (``numbers``)."""
    spec, cfg, dev = ctx.spec, ctx.cfg, ctx.device
    o = cfg["optimizer"]
    mix = traffic.generate(spec, ctx.seed, cfg["acoustic"]["vocab_size"])
    fam = ctx.acoustic.Training(cfg, spec, ctx.seed, dev, mix)
    feed, n_batches = fam.feed, len(fam.feed)
    gen_seed = traffic.sub_seed(ctx.seed, 7)

    model, state, step = fam.build(fam.initial())
    step = ctx.make_step(step)
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    names = [n for n, _ in model.named_parameters()]
    steps = spec["check_steps"]
    losses = []
    with fam.decisions(model) as taken:
        for s in range(steps):
            losses.append(torch.stack(list(step(state, feed[s], gen))))
            if s == 0:
                beta1 = o["betas"][0]
                first = torch.stack([
                    torch.linalg.vector_norm(
                        state.optimizer.state[p]["exp_avg"])
                    if p in state.optimizer.state
                    else torch.zeros((), device=dev)
                    for p in state.params]) / (1.0 - beta1)
    W0 = fam.initial()
    change = torch.stack([torch.linalg.vector_norm(p.detach() - W0[n])
                          for n, p in model.named_parameters()])
    del W0
    got = {"losses": check.to_host(torch.stack(losses)).tolist(),
           "grad": dict(zip(names, check.to_host(first).tolist())),
           "change": dict(zip(names, check.to_host(change).tolist())),
           **taken}
    _sync(dev)
    ctx.setup_done()

    events = _Events(dev)
    timed = events.wrap("step", step) if ctx.tracer.on else step
    k, window_losses, frames, record = steps, [], 0, []
    t0 = time.perf_counter()
    with ctx.tracer.window():
        while time.perf_counter() - t0 < ctx.seconds:
            rec = fam.records[k % n_batches]
            with ctx.tracer.span("step"):
                lb = timed(state, feed[k % n_batches], gen)
            window_losses.append(lb[0])
            frames += int(rec["mel_lens"].sum())
            if ctx.tracer.on:
                record.append(rec)
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
    del state, model, step
    ctx.free()

    ref = fam.reference(fam.initial(), steps, gen_seed, got)
    out.numbers = check.training_numbers(got, ref, fam)
    if ctx.control:
        with _Precision(True):
            ctl = fam.reference(fam.initial(), steps, gen_seed)
        # the reference given the control's decisions, as the program's
        ref = fam.reference(fam.initial(), steps, gen_seed, ctl)
        out.control = {"tf32": check.training_numbers(ctl, ref, fam)}
    return out


MODES = {"closed": serve_closed, "open": serve_open, "train": train}
