"""Training orchestration, as ``smart_nar_fast_tts_tpu/training/trainer.py``:
the reference's ``train.py:21-196`` loop, restartable, around the train
step.

Cadences (reference ``train.yaml:17-20``): log every ``log_step`` (with a
NaN guard), a synth-sample figure every ``synth_step``, validation (and a
val sample) every ``val_step``, a checkpoint every ``save_step``; the data
position ``(epoch, in_epoch)`` is saved with each checkpoint, SIGTERM stops
the loop after the current step, and the last step is always saved.

Devices: one process per card under torchrun (``parallel/mesh.py``).  The
mesh follows the JAX trainer's rule: ``mesh_shape``'s tail keeps its sizes
and the data axis is ``gcd(batch per node, ranks per node // tail)``.
Every rank draws the same global batch from the same seed and computes its
rows (``training/step.py``); only the first rank writes checkpoints, the
text log, event files and figures, and every rank restores.  A
``sequence_parallel`` model rings its decoder attention over ``sp_axis``;
a 2-D mesh such as ``(data, seq)`` gives hybrid DP×SP.

What differs from the JAX trainer:

- Where JAX would leave devices idle (a batch per node that the data slots
  do not divide), the port raises and names the sizes: a torchrun job
  cannot idle its ranks.
- ``steps_per_dispatch`` K > 1 is checked as JAX checks it (every cadence a
  multiple of K) and runs each full group of K same-shape batches as K
  single steps, the cadences after the group as JAX's ``lax.scan``
  dispatch has them; PyTorch has no ``lax.scan`` (``training/step.py``).
  ``Perf/steps_per_sec`` counts single steps, where JAX's counts groups.
- Dropout draws from a generator re-seeded from ``(train.seed, step)``
  (and the data rank past the first) before each step, as JAX folds
  ``state.step`` into one key (``training/step.py:75`` there): a run
  resumed from a checkpoint draws the masks of a run that never stopped.
  The ranks of one sequence-parallel group draw the same masks.
- Sample figures are RGB arrays (``training/logging.plot_mel``).
"""

from __future__ import annotations

import math
import signal
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, check_ported
from ..data.dataset import AcousticDataset, BucketBatcher
from ..device import resolve_device
from ..models import FastSpeech2Align, FastSpeech2Loss
from ..parallel import Mesh, all_reduce, make_mesh, replicated
from ..parallel.mesh import TORCHRUN_HINT, node_layout, world
from .checkpoint import CheckpointManager
from .evaluate import evaluate
from .logging import MetricWriter, format_losses, plot_mel
from .profiling import StepProfiler, Throughput
from .state import TrainState, create_train_state
from .step import data_parallel, make_eval_step, make_train_step


def _dispatch_groups(batch_iter, K: int):
    """Group consecutive same-bucket-shape batches into runs of ≤ K; a
    shape change or the epoch's tail flushes early."""
    buf = []
    for item in batch_iter:
        if buf and (item[0].texts.shape != buf[-1][0].texts.shape
                    or item[0].mels.shape != buf[-1][0].mels.shape):
            yield buf
            buf = []
        buf.append(item)
        if len(buf) == K:
            yield buf
            buf = []
    if buf:
        yield buf


def train_mesh(cfg: Config) -> Mesh:
    """The JAX trainer's mesh rule (``training/trainer.py:57-78`` there)
    over the ranks of the process group (one without it)."""
    _, nodes, n_local = node_layout()
    local_batch = cfg.train.optimizer.batch_size // nodes
    tail = tuple(cfg.train.mesh_shape[1:])
    tail_size = int(np.prod(tail)) if tail else 1
    if n_local % tail_size:
        raise ValueError(
            f"mesh_shape tail {tail} needs {tail_size} devices per data "
            f"slot but only {n_local} are local")
    data_size = math.gcd(local_batch, n_local // tail_size)
    if data_size * tail_size < n_local:
        raise ValueError(
            f"batch_size {cfg.train.optimizer.batch_size} over {nodes} "
            f"node(s) shards over {data_size} data slot(s) of {tail_size} "
            f"rank(s), {data_size * tail_size} of the {n_local} ranks per "
            "node: JAX would leave the others idle, a torchrun job cannot; "
            f"launch {data_size * tail_size} ranks per node or make the "
            f"batch per node a multiple of {n_local // tail_size}")
    return make_mesh((-1,) + tail, cfg.train.mesh_axis_names)


def dropout_seed(seed: int, step: int, data_index: int = 0) -> int:
    """The dropout generator's seed before update ``step + 1`` on data
    rank ``data_index``."""
    key = [seed, step] + ([data_index] if data_index else [])
    words = np.random.SeedSequence(key).generate_state(2, np.uint32)
    return int(words[0]) << 32 | int(words[1])


class Trainer:
    def __init__(self, cfg: Config,
                 device: str | torch.device | None = None,
                 mesh: Optional[Mesh] = None):
        if cfg.preprocess.stats is None:
            raise ValueError(
                "PreprocessConfig.stats is required for training "
                "(load stats.json via Config loading helpers)")
        check_ported(cfg.model)
        self.cfg = cfg
        self.mesh = train_mesh(cfg) if mesh is None else mesh
        self.data_axis = cfg.train.mesh_axis_names[0]
        self.sp_mesh = None
        if cfg.model.sequence_parallel:
            if not dist.is_initialized():
                raise ValueError("ModelConfig.sequence_parallel needs a "
                                 "process group: " + TORCHRUN_HINT)
            if cfg.model.sp_axis not in self.mesh.axis_names:
                raise ValueError(
                    f"model.tpu.sp_axis={cfg.model.sp_axis!r} is not a "
                    f"mesh axis {self.mesh.axis_names}; set train.tpu."
                    "mesh_axis_names (e.g. ['data', 'seq']) to include it")
            self.sp_mesh = self.mesh
        self.rank = world()[0]
        _, self.num_hosts, _ = node_layout()
        self.device = resolve_device(device)
        self.loss = FastSpeech2Loss(cfg.preprocess,
                                    guided_sigma=cfg.model.guided_sigma)
        parallel = dict(mesh=self.mesh, data_axis=self.data_axis,
                        sp_mesh=self.sp_mesh, num_hosts=self.num_hosts)
        self.train_step = make_train_step(
            self.loss, grad_acc_steps=cfg.train.optimizer.grad_acc_step,
            **parallel)
        self.eval_step = make_eval_step(self.loss, **parallel)
        K = cfg.train.steps_per_dispatch
        if K > 1:
            sc = cfg.train.step
            for name in ("log_step", "synth_step", "val_step", "save_step"):
                if getattr(sc, name) % K:
                    raise ValueError(
                        f"{name}={getattr(sc, name)} must be a multiple "
                        f"of steps_per_dispatch={K}")
        self._stop = False
        self._vocoder = None
        if cfg.train.vocoder_ckpt and self.rank == 0:
            from ..vocoder.convert import load_hifigan
            self._vocoder = load_hifigan(cfg.train.vocoder_ckpt).to(
                self.device)

    # -- data -------------------------------------------------------------
    def make_batcher(self, split: str,
                     pad_short: str = "repeat") -> BucketBatcher:
        c = self.cfg
        node, nodes, _ = node_layout()
        return BucketBatcher(
            AcousticDataset(split, c.preprocess),
            batch_size=c.train.optimizer.batch_size,
            text_buckets=c.train.text_buckets,
            mel_buckets=c.train.mel_buckets, seed=c.train.seed,
            host_id=node, num_hosts=nodes, pad_short=pad_short)

    # -- state ------------------------------------------------------------
    def init_state(self, rng_seed: Optional[int] = None) -> TrainState:
        """A fresh model from the port's initialisers under
        ``torch.manual_seed(seed)`` (the global generator is left as it
        was), on the trainer's device, with a fresh optimizer; on a mesh,
        the first rank's parameters on every rank."""
        seed = self.cfg.train.seed if rng_seed is None else rng_seed
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = FastSpeech2Align(self.cfg.model, self.cfg.preprocess)
        state = create_train_state(model, self.cfg.train.optimizer,
                                   self.device)
        replicated(self.mesh, state.model)
        return state

    def _dropout_generator(self, step: int) -> torch.Generator:
        group, _ = data_parallel(self.cfg.model, self.mesh, self.sp_mesh,
                                 self.data_axis)
        data_index = 0 if group is None else self.mesh.coords[self.data_axis]
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(dropout_seed(self.cfg.train.seed, step,
                                            data_index))

    def _stop_requested(self) -> bool:
        """Whether any rank received SIGTERM: all ranks stop at the same
        step."""
        flag = torch.tensor(float(self._stop), device=self.device)
        if dist.is_initialized():
            flag = all_reduce(flag, dist.group.WORLD, dist.ReduceOp.MAX)
        return bool(flag)

    # -- loop -------------------------------------------------------------
    def fit(self, total_steps: Optional[int] = None, restore: bool = True,
            restore_step: Optional[int] = None) -> TrainState:
        """Train to ``total_steps`` (default ``train.step.total_step``),
        when ``restore`` from checkpoint ``restore_step`` (default the
        latest, if any); returns the state.  On a mesh every rank runs
        this, and only the first one writes."""
        c = self.cfg
        sc = c.train.step
        total = total_steps if total_steps is not None else sc.total_step

        state = self.init_state()
        ckpt = CheckpointManager(c.train.ckpt_path,
                                 save_interval_steps=sc.save_step)
        epoch, in_epoch = 0, 0
        if restore:
            state, data_state = ckpt.restore(state, step=restore_step)
            if data_state:
                epoch = int(data_state.get("epoch", 0))
                in_epoch = int(data_state.get("in_epoch", 0))

        train_writer = MetricWriter(f"{c.train.log_path}/train")
        val_writer = MetricWriter(f"{c.train.log_path}/val")
        writes = self.rank == 0
        profiler = StepProfiler(
            c.train.log_path, c.train.profile_start_step if writes else 0,
            c.train.profile_num_steps, cuda=self.device.type == "cuda")
        throughput = Throughput(n_chips=self.mesh.size)
        train_batcher = self.make_batcher("train.txt")
        # masked (not repeated) short-batch padding: each val item counts
        # exactly once in the element-weighted averaging
        val_batcher = self.make_batcher("val.txt", pad_short="mask")

        def _on_sigterm(signum, frame):
            self._stop = True
        prev = signal.signal(signal.SIGTERM, _on_sigterm)

        step = state.step
        K = max(1, c.train.steps_per_dispatch)

        def one_step(batch):
            nonlocal step, in_epoch
            losses = self.train_step(state, batch,
                                     self._dropout_generator(step))
            step += 1
            in_epoch += 1
            profiler.step(step)
            return losses

        def cadence(losses, batch, ids):
            if step % sc.log_step == 0:
                if not np.isfinite(float(losses.total)):
                    raise FloatingPointError(
                        f"non-finite loss at step {step}: {losses}")
                train_writer.scalars(step, losses)
                rates = throughput.snapshot()
                if rates:
                    train_writer.scalar_dict(step, rates)
                train_writer.message(format_losses(step, total, losses))
            if step % sc.synth_step == 0:
                self._synth_sample(state, batch, ids, step, train_writer)
            if step % sc.val_step == 0:
                # a collective: every rank runs its rows
                msg = evaluate(self.eval_step, state,
                               val_batcher.batches(0), step, total,
                               val_writer)
                val_writer.message(msg)
                # the reference's evaluate also synthesizes one val sample
                vb = next(iter(val_batcher.batches(0)), None)
                if vb is not None:
                    self._synth_sample(state, vb[0], vb[1], step,
                                       val_writer)
            if writes:
                ckpt.save(state, {"epoch": epoch, "in_epoch": in_epoch})

        stopping = False
        try:
            while step < total and not stopping:
                done = False
                for group in _dispatch_groups(
                        train_batcher.batches(epoch, skip=in_epoch), K):
                    # JAX's K-step dispatch: a full group's cadences come
                    # after its last step; a short group's after each
                    full = K > 1 and len(group) == K
                    for i, (batch, ids, _) in enumerate(group):
                        losses = one_step(batch)
                        throughput.update(int(batch.mel_lens.sum()))
                        if full and i < K - 1:
                            continue
                        cadence(losses, batch, ids)
                        stopping = self._stop_requested()
                        if step >= total or stopping:
                            done = True
                            break
                    if done:
                        break
                if not done:     # epoch exhausted normally
                    epoch += 1
                    in_epoch = 0
            if writes and ckpt.latest_step() != step:
                ckpt.save(state, {"epoch": epoch, "in_epoch": in_epoch},
                          force=True)
        finally:
            signal.signal(signal.SIGTERM, prev)
            profiler.close(step)
            train_writer.close()
            val_writer.close()
        if dist.is_initialized():
            # no rank returns before the first one's checkpoint is written:
            # a later run of the same job restores it
            float(all_reduce(torch.zeros((), device=self.device),
                             dist.group.WORLD))
        return state

    # -- sample synthesis during training ---------------------------------
    @torch.no_grad()
    def _synth_sample(self, state: TrainState, batch, ids, step: int,
                      writer: MetricWriter) -> None:
        """Reconstruction figure of the first batch item (reference
        ``utils/tools.py:96-150`` ``synth_one_sample``): the eval-mode
        forward on item 0 alone, teacher-forced, without speakers as the
        JAX trainer's; vocoded when ``train.vocoder_ckpt`` is set.  Only
        the first rank runs it, but under sequence parallelism every rank
        does: the decoder's ring is a collective."""
        if not writer.enabled and self.sp_mesh is None:
            return
        b = batch.to(state.device)
        out = state.model.eval()(
            b.texts[:1], b.src_lens[:1], mels=b.mels[:1],
            mel_lens=b.mel_lens[:1], p_targets=b.pitch[:1],
            e_targets=b.energy[:1], sp_mesh=self.sp_mesh)
        if not writer.enabled:
            return
        n = int(batch.mel_lens[0])
        mel_pred = out.postnet_mel[0, :n].T.cpu().numpy()
        mel_true = batch.mels[0, :n].T.numpy()
        pitch = batch.pitch[0, :n].numpy()
        energy = batch.energy[0, :n].numpy()
        fig = plot_mel([(mel_pred, pitch, energy),
                        (mel_true, pitch, energy)],
                       self.cfg.preprocess.stats)
        writer.figure(step, f"Training/step_{step}_{ids[0]}", fig)
        if self._vocoder is not None:
            # the reference vocodes both the reconstruction and the ground
            # truth (utils/tools.py:108-132)
            # (the writer normalises each clip by its peak)
            sr = self.cfg.preprocess.audio.sampling_rate
            for tag, mel in (("synthesized", mel_pred.T),
                             ("reconstructed_gt", mel_true.T)):
                wav = self._vocoder(torch.from_numpy(
                    np.ascontiguousarray(mel[None])).to(self.device))[0]
                writer.audio(step, f"Training/step_{step}_{ids[0]}_{tag}",
                             wav.cpu().numpy(), sr)
