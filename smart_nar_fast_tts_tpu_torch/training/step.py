"""Train and eval steps.

A train step is ``(state, batch, generator) → LossBreakdown``: forward and
backward over ``grad_acc_steps`` microbatches in turn, with the gradients
averaged, the BatchNorm running statistics carried from one microbatch to
the next and the loss terms averaged; then one clipped Noam-Adam update.
``generator`` (a ``torch.Generator`` on the state's device) draws the
dropout masks; ``None`` means no dropout.  PyTorch runs eagerly, so the JAX
package's ``make_multi_step`` (a ``lax.scan`` of steps in one dispatch) has
no counterpart here.

On a mesh (``parallel/``, one process per card) a step takes the global
batch, as JAX's jitted step does, and each rank computes its rows along
``data_axis``: microbatch i is rows [i·B/a, (i+1)·B/a) of the global batch,
then split over the data ranks.  The losses' denominators, the capacities
and the BatchNorm statistics are the global microbatch's, so the gradients
summed over the data group by one all-reduce of the flattened gradients
are the global batch's (DDP would average, and need the sum of
``1/data size`` back).  ``sp_mesh`` runs the decoder's ring attention; with
the same mesh as ``mesh`` (hybrid DP×SP) the batch rides the data axis and
the ring the model's ``sp_axis``.  When ``sp_axis`` is the data axis
itself, the ring takes that axis and the batch is not split.  The ranks
along every other axis (the ring's, a tail such as ``model``) compute the
same rows: one all-reduce of the flattened gradients and BatchNorm running
statistics over the whole mesh sums the data shards and averages those
replicas, which the card's nondeterministic kernels would otherwise let
drift apart (``parallel.reduce_over_mesh``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..data.batch import Batch
from ..models import FastSpeech2Loss, LossBreakdown, ModelOutput
from ..models.layers import MaskedBatchNorm
from ..parallel import Mesh, all_reduce, batch_sharding, reduce_over_mesh
from ..parallel.mesh import BatchSharding, trivial
from ..tracing import call_args, span
from .state import TrainState


def _forward(model, loss_fn, batch: Batch,
             generator: Optional[torch.Generator], sp_mesh=None,
             group=None) -> tuple[LossBreakdown, ModelOutput]:
    out = model(batch.texts, batch.src_lens, speakers=batch.speakers,
                mels=batch.mels, mel_lens=batch.mel_lens,
                p_targets=batch.pitch, e_targets=batch.energy,
                generator=generator, sp_mesh=sp_mesh, data_group=group)
    return loss_fn(out, batch.mels, batch.pitch, batch.energy, group), out


def _mean(losses: list[LossBreakdown], group=None) -> LossBreakdown:
    """Each term's mean over the microbatches; under a data group, of the
    ranks' parts summed (each part a global microbatch's loss share)."""
    stacked = torch.stack([torch.stack([getattr(l, f).detach()
                                        for f in LossBreakdown._fields])
                           for l in losses])
    return LossBreakdown(*all_reduce(stacked, group).mean(0))


def check_meshes(mesh: Optional[Mesh], sp_mesh: Optional[Mesh]) -> None:
    """JAX's rule: hybrid DP×SP shares one mesh."""
    if not trivial(sp_mesh) and not trivial(mesh) and mesh != sp_mesh:
        raise ValueError(
            "hybrid DP×SP requires one shared 2-D mesh passed as both "
            "mesh= and sp_mesh= (got two different meshes)")


def data_parallel(model_cfg, mesh: Optional[Mesh],
                  sp_mesh: Optional[Mesh],
                  data_axis: str = "data", num_hosts: int = 1
                  ) -> tuple[object, Optional[BatchSharding]]:
    """(process group, this rank's rows) of the data axis, or (None, None)
    when the batch is not split: no mesh, no process group, or the data
    axis carrying the ring (``sp_axis == data_axis``)."""
    if mesh is None or data_axis not in mesh.shape:
        return None, None
    if (sp_mesh is not None and model_cfg.sequence_parallel
            and model_cfg.sp_axis == data_axis):
        return None, None
    group = mesh.group(data_axis)
    if group is None:
        return None, None
    return group, batch_sharding(mesh, data_axis, num_hosts)


def reduce_step(model, mesh: Optional[Mesh], split: bool,
                data_axis: str = "data") -> None:
    """The step's one all-reduce over every rank of ``mesh``: the
    gradients summed over the data shards (each rank's a part of the
    global batch's sum) and averaged over the ranks that compute the same
    rows, the BatchNorm running statistics averaged; ``split`` says whether
    the batch was split over ``data_axis``."""
    if mesh is None:
        return
    shards = mesh.shape[data_axis] if split else 1
    buffers = [t for bn in model.modules() if isinstance(bn, MaskedBatchNorm)
               for t in (bn.running_mean, bn.running_var)]
    reduce_over_mesh(mesh, model.parameters(), mesh.size / shards, buffers)


def compute_gradients(state: TrainState, loss_fn: FastSpeech2Loss,
                      batch: Batch, grad_acc_steps: int = 1,
                      generator: Optional[torch.Generator] = None,
                      mesh: Optional[Mesh] = None,
                      sp_mesh: Optional[Mesh] = None,
                      data_axis: str = "data", num_hosts: int = 1
                      ) -> tuple[LossBreakdown, list[ModelOutput]]:
    """Leave in each parameter's ``.grad`` the gradient of the total loss
    averaged over ``grad_acc_steps`` microbatches (train mode: batch
    statistics, running statistics updated).  Returns the averaged loss
    terms and each microbatch's output (this rank's rows), detached."""
    model = state.model.train()
    group, rows = data_parallel(model.cfg, mesh, sp_mesh, data_axis,
                                num_hosts)
    for p in state.params:
        p.grad = None
    losses, outputs = [], []
    for mb in batch.split(grad_acc_steps):
        if rows is not None:
            mb = rows(mb)
        mb = mb.to(state.device)
        with span("step.forward"):
            lb, out = _forward(model, loss_fn, mb, generator, sp_mesh, group)
        with span("step.backward"):
            lb.total.backward()
        losses.append(lb)
        outputs.append(ModelOutput(*(None if t is None else t.detach()
                                     for t in out)))
    with span("step.reduce"):
        reduce_step(model, sp_mesh if mesh is None else mesh,
                    rows is not None, data_axis)
    if grad_acc_steps > 1:
        grads = [p.grad for p in state.params if p.grad is not None]
        torch._foreach_div_(grads, float(grad_acc_steps))
    return _mean(losses, group), outputs


def make_train_step(loss_fn: FastSpeech2Loss, grad_acc_steps: int = 1,
                    keep_outputs: bool = False, mesh: Optional[Mesh] = None,
                    data_axis: str = "data", sp_mesh: Optional[Mesh] = None,
                    num_hosts: int = 1) -> Callable:
    """``step(state, batch, generator=None) → LossBreakdown`` (with
    ``keep_outputs``, ``(LossBreakdown, [ModelOutput per microbatch])``),
    updating ``state`` in place.  On a mesh, ``batch`` is the global batch
    (with ``num_hosts`` nodes, the node's) and the losses are the global
    batch's on every rank."""
    check_meshes(mesh, sp_mesh)

    def step(state: TrainState, batch: Batch,
             generator: Optional[torch.Generator] = None):
        B, L = batch.texts.shape
        with span("step", call_args(state.step + 1, B, L,
                                    batch.mels.shape[1])):
            losses, outputs = compute_gradients(
                state, loss_fn, batch, grad_acc_steps, generator, mesh,
                sp_mesh, data_axis, num_hosts)
            with span("step.optimizer"):
                state.apply_gradients()
        return (losses, outputs) if keep_outputs else losses

    return step


def make_eval_step(loss_fn: FastSpeech2Loss, mesh: Optional[Mesh] = None,
                   data_axis: str = "data", sp_mesh: Optional[Mesh] = None,
                   num_hosts: int = 1) -> Callable:
    """``step(state, batch) → (LossBreakdown, weights)``: the loss terms in
    eval mode (running statistics, no dropout), and for each term the count
    of valid elements its masked mean was taken over (frames, phonemes or
    (frame, phoneme) pairs; 1 for the total), so that ``Σ loss·w / Σ w``
    over batches does not depend on how a split is cut into batches.  On a
    mesh both are the global batch's, on every rank."""
    check_meshes(mesh, sp_mesh)

    @torch.no_grad()
    def step(state: TrainState, batch: Batch):
        model = state.model.eval()
        group, rows = data_parallel(model.cfg, mesh, sp_mesh, data_axis,
                                    num_hosts)
        if rows is not None:
            batch = rows(batch)
        batch = batch.to(state.device)
        losses, _ = _forward(model, loss_fn, batch, None, sp_mesh, group)
        losses = _mean([losses], group)
        src = all_reduce(batch.src_lens.float().sum(), group)
        mel = all_reduce(batch.mel_lens.float().sum(), group)
        pairs = all_reduce((batch.src_lens.float()
                            * batch.mel_lens.float()).sum(), group)
        pv = src if loss_fn.pitch_level == "phoneme_level" else mel
        ev = src if loss_fn.energy_level == "phoneme_level" else mel
        weights = LossBreakdown(
            total=torch.ones((), device=src.device), mel=mel,
            postnet_mel=mel, pitch=pv, energy=ev, duration=src,
            attention=pairs)
        return losses, weights

    return step
