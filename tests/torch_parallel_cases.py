"""The port's side of the multi-rank parity tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_training.py``).

:func:`run_ranks` runs one function on ``WORLD`` gloo ranks of the port, in
spawned processes that meet through a ``FileStore`` under the test's
``tmp_path``, and returns each rank's result.  The processes import torch,
numpy and the port only; the test modules compute the JAX side in the
parent and hold the two against each other.  A rank that fails fails the
job at once; a job past its deadline is killed and fails (a hang never
reaches the test run's own limit).
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import time
import traceback

import numpy as np
import torch

WORLD = 4
GLOO_TIMEOUT_S = 60
DEADLINE_S = 150

# the narrow acoustic model of the parity runs: dropout off, the alignment
# kernel's configuration (intended/first), T divisible by every seq axis
WIDTHS = dict(encoder_layer=1, encoder_head=2, encoder_hidden=32,
              decoder_layer=2, decoder_head=2, decoder_hidden=32,
              conv_filter_size=64, encoder_dropout=0.0, decoder_dropout=0.0)
STATS = dict(pitch_min=-2.0, pitch_max=2.0, energy_min=-2.0, energy_max=2.0)
EXTRACTION = dict(duration_extraction="intended", duration_head_reduce="first")
B, L, T = 8, 10, 32


def acoustic_arrays(seed: int = 5, microbatches: int = 1) -> dict:
    """A seeded batch of ``microbatches`` × B rows whose rows differ in text
    and frame length, so that every rank of a 4-way data axis holds other
    valid counts in each microbatch."""
    rng = np.random.RandomState(seed)
    n = B * microbatches
    src = np.array([10, 7, 9, 4, 10, 6, 8, 5], np.int32)
    mel = np.array([32, 20, 29, 11, 32, 25, 17, 30], np.int32)
    return dict(
        texts=rng.randint(2, 300, (n, L)).astype(np.int32),
        src_lens=np.concatenate([np.roll(src, i)
                                 for i in range(microbatches)]),
        mels=rng.randn(n, T, 80).astype(np.float32),
        mel_lens=np.concatenate([np.roll(mel, 3 * i)
                                 for i in range(microbatches)]),
        pitch=rng.uniform(-1, 1, (n, T)).astype(np.float32),
        energy=rng.uniform(0, 2, (n, T)).astype(np.float32))


def port_configs(sequence_parallel: bool = False, sp_axis: str = "data"):
    from smart_nar_fast_tts_tpu_torch import config as tcfg
    model = tcfg.ModelConfig(
        transformer=tcfg.TransformerConfig(**WIDTHS), max_seq_len=64,
        sequence_parallel=sequence_parallel, sp_axis=sp_axis, **EXTRACTION)
    pre = tcfg.PreprocessConfig(stats=tcfg.FeatureStats(**STATS))
    return model, pre


def _rank_main(fn, rank, world, store, out_dir, inputs_path):
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        torch.set_num_threads(1)
        from smart_nar_fast_tts_tpu_torch.parallel import init_distributed
        init_distributed("cpu", init_method=f"file://{store}",
                         timeout_s=GLOO_TIMEOUT_S)
        inputs = torch.load(inputs_path, weights_only=False)
        result = fn(inputs)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


class Ranks:
    """``fn(inputs)`` started on ``world`` gloo ranks; :meth:`wait` returns
    each rank's return value (the parent may work meanwhile)."""

    def __init__(self, fn, tmp_path, inputs, world: int = WORLD,
                 deadline_s: float = DEADLINE_S):
        self.out_dir = tmp_path / "ranks"
        self.out_dir.mkdir()
        inputs_path = tmp_path / "inputs.pt"
        torch.save(inputs, inputs_path)
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(fn, r, world,
                                        str(tmp_path / "store"),
                                        str(self.out_dir), str(inputs_path)))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline_s = deadline_s
        self.end = time.monotonic() + deadline_s

    def wait(self) -> list:
        procs = self.procs
        try:
            while any(p.is_alive() for p in procs):
                failed = [p for p in procs
                          if not p.is_alive() and p.exitcode != 0]
                if failed or time.monotonic() > self.end:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        out = self.out_dir
        errors = {r: (out / f"{r}.err").read_text()
                  for r in range(len(procs)) if (out / f"{r}.err").exists()}
        if errors:
            raise RuntimeError("ranks failed:\n" + "\n".join(
                f"--- rank {r}\n{e}" for r, e in sorted(errors.items())))
        if time.monotonic() > self.end:
            raise TimeoutError(
                f"ranks did not finish in {self.deadline_s} s: exit codes "
                f"{[p.exitcode for p in procs]}")
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError("ranks failed before their work began: exit "
                               f"codes {[p.exitcode for p in procs]}")
        return [torch.load(out / f"{r}.pt", weights_only=False)
                for r in range(len(procs))]


def run_ranks(fn, tmp_path, inputs, world: int = WORLD,
              deadline_s: float = DEADLINE_S) -> list:
    """``fn(inputs)`` on ``world`` gloo ranks; each rank's return value."""
    return Ranks(fn, tmp_path, inputs, world, deadline_s).wait()


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _trainer_config(**train):
    from smart_nar_fast_tts_tpu_torch import config as tcfg
    model, pre = port_configs(**train.pop("model", {}))
    return tcfg.Config(preprocess=pre, model=model, train=dataclasses.replace(
        tcfg.TrainConfig(), **train))


# -- tests/test_torch_parallel.py --------------------------------------------

def parallel_cases(inputs: dict) -> dict:
    """Meshes, the ring, the channel-sharded HiFi-GAN and the errors."""
    from smart_nar_fast_tts_tpu_torch import config as tcfg
    from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Loss
    from smart_nar_fast_tts_tpu_torch.parallel import (
        batch_sharding, make_mesh, sequence_parallel_self_attention)
    from smart_nar_fast_tts_tpu_torch.training import (Trainer,
                                                       make_train_step)
    from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                      HiFiGANGenerator,
                                                      shard_hifigan)
    out = {}
    flat = make_mesh((-1,), ("data",))
    grid = make_mesh((2, -1), ("data", "seq"))
    out["meshes"] = dict(
        flat=(flat.shape, flat.coords), grid=(grid.shape, grid.coords),
        default=make_mesh().shape,
        rows=batch_sharding(grid, "data").rows(8),
        grid_groups=[torch.distributed.get_process_group_ranks(
            grid.group(a)) for a in ("data", "seq")])

    ring = {}
    for name, (q, k, v, valid) in inputs["ring"].items():
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        o = sequence_parallel_self_attention(
            flat, q, k, v, torch.from_numpy(valid), "data")
        (o * torch.from_numpy(inputs["cotangent"][name])).sum().backward()
        ring[name] = dict(out=o.detach().numpy(), dq=q.grad.numpy(),
                          dk=k.grad.numpy(), dv=v.grad.numpy())
    out["ring"] = ring

    gen = HiFiGANGenerator(HiFiGANConfig(**inputs["hifigan_config"]))
    gen.load_state_dict(inputs["hifigan_state"])
    tp = make_mesh((2, 2), ("data", "model"))
    forward = shard_hifigan(gen, tp)
    out["tp_wavs"] = forward(torch.from_numpy(inputs["tp_mels"])).numpy()
    out["tp_shapes"] = {n: tuple(p.shape) for n, p in
                        forward.generator.named_parameters()}

    q = torch.zeros(1, 2, 30, 8)
    out["errors"] = dict(
        two_meshes=_error(lambda: make_train_step(
            FastSpeech2Loss(), mesh=flat, sp_mesh=grid)),
        indivisible=_error(lambda: sequence_parallel_self_attention(
            flat, q, q, q, torch.ones(1, 30, dtype=torch.bool), "data")),
        sp_axis=_error(lambda: Trainer(_trainer_config(
            model=dict(sequence_parallel=True, sp_axis="seq")),
            device="cpu")),
        tail=_error(lambda: Trainer(_trainer_config(mesh_shape=(-1, 8)),
                                    device="cpu")),
        idle=_error(lambda: Trainer(_trainer_config(
            optimizer=tcfg.OptimizerConfig(batch_size=2)), device="cpu")))
    return out


# -- tests/test_torch_parallel_training.py -----------------------------------

GAN_B = 4


def _named(module) -> dict:
    return {n: p.detach().numpy().copy() for n, p in
            module.named_parameters()}


def _grads(state) -> dict:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)
                ).numpy().copy() for n, p in state.model.named_parameters()}


def _bn_stats(model) -> list:
    return [(bn.running_mean.numpy().copy(), bn.running_var.numpy().copy())
            for _, bn in model.postnet.convolutions]


def training_cases(inputs: dict) -> dict:
    """The DP, accumulated, data × model, SP and hybrid train steps, the DP
    eval and GAN steps, and two steps of ``Trainer.fit`` on a data × seq
    mesh."""
    from smart_nar_fast_tts_tpu_torch import config as tcfg
    from smart_nar_fast_tts_tpu_torch.audio import MelSpectrogramConfig
    from smart_nar_fast_tts_tpu_torch.data import Batch
    from smart_nar_fast_tts_tpu_torch.models import (FastSpeech2Align,
                                                     FastSpeech2Loss)
    from smart_nar_fast_tts_tpu_torch.parallel import make_mesh
    from smart_nar_fast_tts_tpu_torch.training import (
        CheckpointManager, Trainer, VocoderOptimizer, compute_gradients,
        create_train_state,
        create_vocoder_state, make_eval_step, make_train_step,
        make_vocoder_train_step)
    from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                      HiFiGANDiscriminator,
                                                      HiFiGANGenerator)
    batch, acc_batch = (Batch(**{k: torch.from_numpy(v)
                                 for k, v in inputs[name].items()})
                        for name in ("arrays", "acc_arrays"))
    loss = FastSpeech2Loss(port_configs()[1])

    def state(**sp):
        model = FastSpeech2Align(*port_configs(**sp))
        model.load_state_dict(inputs["acoustic"])
        return create_train_state(model, device="cpu")

    def floats(losses):
        return {k: float(v) for k, v in losses._asdict().items()}

    flat = make_mesh((4,), ("data",))
    grid = make_mesh((2, 2), ("data", "seq"))
    # a (data, model) mesh: the ranks along the tail compute the same rows
    tail = make_mesh((2, 2), ("data", "model"))
    out = {}
    for name, acc, b, mesh in (("dp", 1, batch, flat),
                               ("acc", 2, acc_batch, flat),
                               ("tail", 1, batch, tail)):
        # make_train_step's two halves: the gradients, then the update
        st = state()
        losses, _ = compute_gradients(st, loss, b, acc, mesh=mesh)
        grads = _grads(st)
        st.apply_gradients()
        out[name] = dict(losses=floats(losses), grads=grads,
                         params=_named(st.model), bn=_bn_stats(st.model))
    st = state()
    make_train_step(loss, 2, mesh=flat)(st, acc_batch)
    out["step"] = _named(st.model)
    for name, mesh, sp in (("sp", None, dict(sp_axis="data")),
                           ("hybrid", grid, dict(sp_axis="seq"))):
        st = state(sequence_parallel=True, **sp)
        losses, _ = compute_gradients(st, loss, batch, mesh=mesh,
                                      sp_mesh=flat if mesh is None else grid)
        out[name] = dict(losses=floats(losses), grads=_grads(st))
    losses, weights = make_eval_step(loss, mesh=flat)(state(), batch)
    out["eval"] = dict(losses=floats(losses), weights=floats(weights))

    gan = inputs["gan"]
    gen = HiFiGANGenerator(HiFiGANConfig(**gan["gen_config"]))
    disc = HiFiGANDiscriminator(**gan["disc_config"])
    gen.load_state_dict(gan["gen_state"])
    disc.load_state_dict(gan["disc_state"])
    tx = VocoderOptimizer(2e-4)
    vst = create_vocoder_state(gen, disc, tx, tx, device="cpu")
    step = make_vocoder_train_step(MelSpectrogramConfig(**gan["mel"]),
                                   mesh=make_mesh((-1, 1)))
    metrics = step(vst, torch.from_numpy(gan["wavs"]))
    out["gan"] = dict(metrics={k: float(v) for k, v in
                               metrics._asdict().items()},
                      gen=vst.generator.state_dict(),
                      disc=vst.discriminator.state_dict())

    cfg = tcfg.Config.from_yaml_triplet(*inputs["triplet"]).with_stats(
        tcfg.FeatureStats.from_stats_json(inputs["stats"]))
    trainer = Trainer(cfg, device="cpu")
    fitted = trainer.fit(total_steps=2)
    out["fit"] = dict(step=fitted.step, mesh=trainer.mesh.shape,
                      sp=trainer.sp_mesh is not None,
                      # what this rank sees on disk as fit returns
                      saved=CheckpointManager(cfg.train.ckpt_path
                                              ).all_steps(),
                      params=torch.cat([p.detach().reshape(-1) for p in
                                        fitted.params]).numpy())
    return out
