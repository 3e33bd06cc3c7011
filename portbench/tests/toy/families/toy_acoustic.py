"""A toy acoustic family with no durations, for the test that a new
architecture is added with new files only: each token speaks the traffic
file's ``frames_per_token`` frames, one embedding and one linear layer
give each frame's mel, scaled by a style of each sentence drawn from the
seed (an input of the family's own, found through the batch's sentence
indices)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.harness import flops, traffic, weights


def shapes(a):
    return {"emb.weight": (a["vocab_size"], a["dim"]),
            "out.weight": (a["n_mels"], a["dim"]), "out.bias": (a["n_mels"],)}


def draw(a, seed, device):
    return weights.make(shapes(a), seed, weights.ACOUSTIC, device)


def tiny(a):
    pass


def forward_flops(a, L, T):
    return flops.lin(T, a["dim"], a["n_mels"])


class Model(torch.nn.Module):
    """The program's acoustic model: mel (B, L·F, n_mels) and mel_lens."""

    def __init__(self, a, frames):
        super().__init__()
        self.frames = frames
        self.emb = torch.nn.Embedding(a["vocab_size"], a["dim"])
        self.out = torch.nn.Linear(a["dim"], a["n_mels"])

    def forward(self, ids, lens, style):
        x = self.emb(ids).repeat_interleave(self.frames, dim=1)
        mel = self.out(x) * style[:, None, None]
        return {"mel": mel, "mel_lens": lens * self.frames}


class Program:
    """What the drivers time; ``synthesize`` goes through ``stage_a`` and
    ``stage_b``, and vocodes at the bucket of the batch's longest."""

    def __init__(self, model, vocoder, buckets, device):
        self.model, self.vocoder = model, vocoder
        self.buckets, self.device = buckets, device

    def stage_a(self, ids, lens, style):
        return self.model(ids.to(self.device), lens.to(self.device),
                          style.to(self.device))

    def stage_b(self, mel):
        return self.vocoder(mel)

    def synthesize(self, ids, lens, style):
        out = self.stage_a(torch.as_tensor(ids), torch.as_tensor(lens),
                           style)
        n = int(out["mel_lens"].max())
        n = next(b for b in self.buckets if n <= b)
        mel = F.pad(out["mel"], (0, 0, 0, max(0, n - out["mel"].shape[1])))
        return self.stage_b(mel[:, :n]), out["mel_lens"]


class Serving:
    def __init__(self, cfg, spec, seed, device, mix):
        self.cfg, self.spec, self.seed, self.device = cfg, spec, seed, device
        self.a = cfg["acoustic"]
        self.frames = spec["frames_per_token"]
        rng = np.random.default_rng(traffic.sub_seed(seed, 100))
        self.style = torch.as_tensor(
            rng.uniform(0.5, 1.5, len(mix.sentences)), dtype=torch.float32)

    def weights(self):
        return draw(self.a, self.seed, self.device)

    def build(self, W, vocoder):
        model = weights.module(lambda: Model(self.a, self.frames), W)
        return Program(model, vocoder, self.spec.get("vocoder_buckets"),
                       self.device)

    def _style(self, batch):
        return self.style[batch.index]

    def synthesize(self, synth, batch):
        return synth.synthesize(batch.ids, batch.lens, self._style(batch))

    def stage_a(self, synth, batch):
        out = synth.stage_a(torch.as_tensor(batch.ids),
                            torch.as_tensor(batch.lens), self._style(batch))
        return out["mel"], out["mel_lens"]

    @staticmethod
    def captured(synth):
        return synth.model

    def warm(self, synth):
        L = max(self.spec["text_buckets"])
        for b in range(1, self.spec["max_batch"] + 1):
            synth.stage_a(torch.ones((b, L), dtype=torch.long),
                          torch.full((b,), L), torch.ones(b))
            for t in self.spec["vocoder_buckets"]:
                synth.stage_b(torch.zeros((b, t, self.a["n_mels"]),
                                          device=self.device))

    @staticmethod
    def keep(out):
        return {"mel": out["mel"].detach().clone()}

    @staticmethod
    def settle(kept):
        return kept["mel"].float().cpu().numpy(), None

    @staticmethod
    def record(out):
        return {}

    def reference(self, W, batch, force=None, low=None):
        ids = torch.as_tensor(batch.ids, device=self.device)
        x = W["emb.weight"][ids].repeat_interleave(self.frames, dim=1)
        mel = F.linear(x, W["out.weight"], W["out.bias"]) * \
            self._style(batch).to(self.device)[:, None, None]
        return mel, np.asarray(batch.lens) * self.frames, None, None
