"""Sequence parallelism: ring attention over the frame axis, as
``smart_nar_fast_tts_tpu/parallel/sequence.py``.

- :func:`ring_self_attention`: self-attention where q, k, v are this rank's
  time slice; the key/value/mask slices travel around the ring of a process
  group while each rank folds them into an online-softmax accumulator.  The
  hop is an ``autograd.Function`` (send to ``r+1``, receive from ``r-1``;
  its backward sends the gradient the other way): JAX's ``ppermute`` and its
  transpose, so autograd differentiates the ring as JAX's ``lax.scan``.
- :func:`sequence_parallel_self_attention` takes the whole (B, H, T, D)
  tensors, as JAX's does, splits the time axis over the mesh's ``seq_axis``
  and gathers the output back.  Its split and gather are a pair of
  ``autograd.Function``s whose backwards are each other's forwards: the
  model around the ring is replicated on every rank of the seq group, so
  every parameter's gradient comes out identical on each of them, and only
  the data axis reduces gradients.  (``torch.distributed.nn``'s
  ``all_gather`` sums its gradient over the ranks, which would give n× the
  gradient here.)

The batch is this rank's own rows: a hybrid DP×SP mesh shards them over the
data axis before the model runs (``training/step.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh, all_gather_cat

NEG_INF = -1e30


def _fold(carry, s, v_blk, key_mask):
    """Online-softmax fold of one score block.

    carry: (acc (..., Tq, D), m (..., Tq), l (..., Tq)); s (..., Tq, Tk);
    v_blk (..., Tk, D); key_mask (..., Tk) bool, broadcastable into s."""
    acc, m, l = carry
    s = torch.where(key_mask, s, NEG_INF)
    m_new = torch.maximum(m, s.max(dim=-1).values)
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None]) * key_mask
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum("...qk,...kd->...qd",
                                                    p, v_blk)
    return acc_new, m_new, l_new


def _shift(group, tensors, hop: int):
    """Each tensor from rank ``r - hop`` of ``group``, this rank's sent to
    ``r + hop``, in one batch of point-to-point operations."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + hop) % n)
    src = dist.get_global_rank(group, (r - hop) % n)
    sends = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, dst, group) for t in sends]
           + [dist.P2POp(dist.irecv, o, src, group) for o in outs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingShift(torch.autograd.Function):
    """k, v and the key mask one hop along the ring; the gradients of k
    and v one hop back."""

    @staticmethod
    def forward(ctx, group, k, v, mask):
        ctx.group = group
        k, v, mask = _shift(group, (k, v, mask), +1)
        ctx.mark_non_differentiable(mask)
        return k, v, mask

    @staticmethod
    def backward(ctx, gk, gv, _):
        gk, gv = _shift(ctx.group, (gk, gv), -1)
        return None, gk, gv, None


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: torch.Tensor, group=None) -> torch.Tensor:
    """Blockwise masked attention with k/v rotating around ``group``.

    q, k, v (B, H, T_local, D), key_valid (B, T_local) bool: this rank's
    time slice.  Returns (B, H, T_local, D) = softmax(QKᵀ/√D)V over the
    global key axis, in q's dtype, with zero rows where no key anywhere is
    valid.  Hop ``j`` folds the block of rank ``(r − j) mod n``; ``n − 1``
    shifts (JAX's last ``ppermute`` is discarded).  ``group`` None is a
    ring of one."""
    n = 1 if group is None else dist.get_world_size(group)
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]),
                                          dtype=torch.float32))
    qf = q.float() * scale.to(q.device)
    acc = torch.zeros_like(qf)
    m = torch.full(qf.shape[:-1], NEG_INF, device=q.device)
    l = torch.zeros(qf.shape[:-1], device=q.device)
    # the mask travels as bytes: not every backend sends bool
    k_blk, v_blk, mask_blk = k, v, key_valid.to(torch.uint8)
    for j in range(n):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk.float())
        acc, m, l = _fold((acc, m, l), s, v_blk.float(),
                          mask_blk.bool()[:, None, None, :])
        if j < n - 1:
            k_blk, v_blk, mask_blk = _RingShift.apply(group, k_blk, v_blk,
                                                      mask_blk)
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    return out.to(q.dtype)


class _Split(torch.autograd.Function):
    """Forward: this rank's slice of ``dim``; backward: the slices'
    gradients gathered back along it."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, dim)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """Forward: the slices gathered along ``dim``; backward: this rank's
    slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, ctx.dim)[r].contiguous(), None, None


def sequence_parallel_self_attention(mesh: Mesh, q: torch.Tensor,
                                     k: torch.Tensor, v: torch.Tensor,
                                     key_valid: torch.Tensor,
                                     seq_axis: str = "data") -> torch.Tensor:
    """Full-sequence attention with the time axis split over ``seq_axis``.

    q, k, v (B, H, T, D) and key_valid (B, T) are the whole sequence, the
    same on every rank of the seq group; T must divide by the axis size.
    Returns the whole (B, H, T, D) output on each of them."""
    n = mesh.shape[seq_axis]
    T = q.shape[2]
    if T % n:
        raise ValueError(
            "ModelConfig.sequence_parallel=True: the frame capacity "
            f"{T} must divide the size {n} of mesh axis {seq_axis!r}")
    group = mesh.group(seq_axis)
    if group is None:
        return ring_self_attention(q, k, v, key_valid)
    qs, ks, vs = (_Split.apply(x, group, 2) for x in (q, k, v))
    mask = key_valid.chunk(n, 1)[dist.get_rank(group)]
    out = ring_self_attention(qs, ks, vs, mask, group)
    return _Gather.apply(out, group, 2)
