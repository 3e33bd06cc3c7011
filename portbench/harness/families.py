"""Model families: ``families/<name>.py``, one file each, named by the
configuration's ``reference`` (``{"acoustic": <name>, "vocoder": <name>}``)
and loaded by path, so that a new architecture comes as new files only.
Of a configuration the harness itself reads only ``reference``,
``acoustic.vocab_size`` (the mix's token ids), ``vocoder.hop_length`` and
``vocoder.sampling_rate`` (audio seconds), ``precision`` (the control's
precisions; ``attention_bf16_past`` where the family has it) and, to
train, ``optimizer.betas``.

A vocoder family's file holds ``draw(v, seed, device)`` (the seed's
weights of the configuration's ``vocoder`` part), ``build(v, W)`` (the
port's module on them), ``reference(W, v, mel)`` (the plain reference:
mel (B, T, n_mels) → waveform (B, T·hop)), ``forward_flops(v, T)`` and
``tiny(v)`` (the part cut to small widths in place, for the CPU tests).

An acoustic family's file holds ``forward_flops(a, L, T)``, ``tiny(a)``
and a ``Serving`` class, made from (cfg, spec, seed, device, mix):
``weights()``; ``build(W, vocoder)``, the object the drivers time, whose
``stage_b(mel)`` vocodes and whose own ``synthesize`` goes through its
``stage_a`` and ``stage_b`` attributes; ``synthesize(program, batch)`` →
(waveforms, mel_lens) and ``stage_a(program, batch)`` → (mel, mel_lens)
on ``drivers.Batch``; ``captured(program)``, the module whose output the
check reads; ``keep(out)`` and ``settle(kept)`` → (mel on the host, its
own decisions); ``record(out)``, a traced batch's record; ``warm(program)``,
open mode's set-up; ``reference(W, batch, force, low)`` → (mel, mel_lens,
own decisions, decisions taken).  A family whose program takes discrete
decisions that the reference follows has a ``Decisions`` tally of them
(see ``check.ServingTally``).  A family that trains has
``train_flops(a, L, T)`` and a ``Training`` class (see ``drivers.train``).

Family files, and nothing else of the benchmark, import the port, and only
inside the functions that build it.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType

FAMILY_DIR = Path(__file__).resolve().parent.parent / "families"


def load_file(path: Path, name: str) -> ModuleType:
    """The module of one file, imported as ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(name: str) -> ModuleType:
    """``families/<name>.py``."""
    return load_file(FAMILY_DIR / f"{name}.py",
                     "portbench_family_" + name.replace("-", "_"))


def of(cfg: dict) -> tuple[ModuleType, ModuleType]:
    """(acoustic, vocoder) families of a configuration."""
    return load(cfg["reference"]["acoustic"]), \
        load(cfg["reference"]["vocoder"])
