"""The acoustic model's first training steps in plain PyTorch: the forward
and loss of ``fastspeech2``, the gradient of the total, clipping by the
global norm at ``grad_clip_thresh`` (left alone below it, else scaled to
it), then AdamW at the Noam rate ``d^-½·min(s^-½, s·warmup^-1.5)`` of
1-based step s.  Dropout masks come from one generator seeded as the
program's.  ``force`` gives each step's aligned durations of the side
being judged, which the reference then follows (its own are returned).
"""

from __future__ import annotations

import torch

from . import fastspeech2 as fs2


def noam(step: int, d_model: int, warmup: int) -> float:
    step = max(float(step), 1.0)
    return d_model ** -0.5 * min(step ** -0.5, step * warmup ** -1.5)


def readings(params: dict, opt, beta1: float) -> dict[str, float]:
    """Each leaf's first gradient as Adam got it: ‖exp_avg‖ / (1 − β1)
    after one step."""
    return {n: float(torch.linalg.vector_norm(opt.state[p]["exp_avg"]))
            / (1.0 - beta1) if p in opt.state else 0.0
            for n, p in params.items()}


def run(W0: dict, cfg: dict, batches: list, gen_seed: int, steps: int,
        force: list | None = None) -> dict:
    """``steps`` updates from weights ``W0`` on ``batches`` (each a dict of
    texts, src_lens, mels, mel_lens, pitch, energy on the device).
    Returns the loss terms of each step, each leaf's first gradient norm,
    each leaf's change ‖p_steps − p_0‖, and each step's own aligned
    durations (``targets``, before any ``force``)."""
    a, o = cfg["acoustic"], cfg["optimizer"]
    dev = next(iter(W0.values())).device
    params = {n: t.detach().clone().requires_grad_()
              for n, t in W0.items() if not n.endswith(("running_mean",
                                                         "running_var"))}
    stats = {n: t for n, t in W0.items() if n not in params}
    opt = torch.optim.AdamW(list(params.values()), lr=0.0,
                            betas=tuple(o["betas"]), eps=o["eps"],
                            weight_decay=o["weight_decay"])
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    losses, first, targets = [], None, []
    for s in range(steps):
        b = batches[s]
        for p in params.values():
            p.grad = None
        out = fs2.forward({**params, **stats}, a, b["texts"], b["src_lens"],
                          mels=b["mels"], mel_lens=b["mel_lens"],
                          pitch=b["pitch"], energy=b["energy"], gen=gen,
                          train=True,
                          force_targets=None if force is None else force[s])
        targets.append(out.own_targets)
        terms = fs2.loss(out, b["src_lens"], b["mels"], b["pitch"],
                         b["energy"])
        terms[0].backward()
        losses.append([float(x) for x in terms.detach()])
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params.values()]
        for p, g in zip(params.values(), grads):
            p.grad = g
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        if norm >= o["grad_clip_thresh"]:
            for g in grads:
                g.mul_(o["grad_clip_thresh"] / norm)
        opt.param_groups[0]["lr"] = noam(
            s + 1, a["transformer"]["encoder_hidden"], o["warm_up_step"])
        opt.step()
        if s == 0:
            first = readings(params, opt, o["betas"][0])
    change = {n: float(torch.linalg.vector_norm(p.detach() - W0[n]))
              for n, p in params.items()}
    return {"losses": losses, "grad": first, "change": change,
            "targets": targets}
