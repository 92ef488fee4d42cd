"""Config-driven training: config → loaders, model, loss, optimizer → the
epoch loop.

Port of ``texttoaudiogrounding_tpu/training/runner_base.py`` (reference
python_scripts/training/run_strong.py:29-120, 679-810) for one device:
``setup`` seeds, ``build_dataloader`` / ``build_model`` / ``build_loss``
instantiate the config's components, :meth:`BaseRunner.train_step` runs
forward in train mode (batch-statistics BN, which moves the running
statistics, and dropout), the loss, the backward, global-norm clipping and
Adam, and :meth:`BaseRunner.fit` runs the epochs with a validation loss,
the plateau learning rate, early stopping and the best/last checkpoints.
``static_train_inputs`` are added to the model's input in the train steps
and never in validation.  Between the backward and the clipping,
:meth:`BaseRunner.post_grad_hook` may change the gradients (the weak
runner's NaN guard); each epoch starts
with the train loader's ``set_epoch`` where it has one (the datasets that
sample draw anew).  ``resume: <checkpoint>`` in the config continues a run
(JAX ``runner_base.py:368-381, 534``): the weights, Adam's state, the
plateau scheduler, the metric monitor and ``not_improve_cnt``, from the
saved epoch + 1; with ``finetune: true`` (top level or under ``trainer``)
it loads the weights alone and starts at epoch 1, as it does for a
reference-format ``.pth``.  :meth:`BaseRunner.restore_state` loads an
experiment's ``best`` or ``last`` weights for evaluation.

The model's freeze flags (``freeze_cnn``, ``freeze_audio_encoder``,
``freeze_text_encoder``, ``freeze_embedding``) become a mask
(``optim.freeze_mask_from_model``): the optimizer, its clipping norm
included, sees the trainable parameters only.  With
``trainer.save_trainable_only`` (the weak runner's default) a masked run's
checkpoints leave the frozen parameters out and keep every buffer; resume
and restore merge them over the parameters the model holds.
``trainer.profile: {start_step, num_steps}`` traces those steps
(``profiling.StepProfiler``) and each epoch's log line gives the
samples/s and steps/s of its training steps (``ThroughputMeter``), as in
the JAX ``fit``.

Several ranks (JAX ``runner_base.py:311, 354, 434-436``): ``setup`` builds
the run's mesh (``parallel/mesh.py:mesh_from_config``) over the process
group, which it initializes from ``torchrun``'s environment where none
exists; ``fit`` shards the model by ``parallel.rules``
(``parallel/tensor_parallel.py``), and every rank walks the same batches,
each padded to the mesh's ranks and cut to the rank's ``data`` rows
(``device_feed``; ``batch_size`` is the global batch).  A step runs the
rank's rows under the ``data`` axis (global BatchNorm statistics, dropout
drawn for the global batch: ``parallel/kernel_shard.py``), computes the
loss of the global batch from the ranks' outputs gathered, and sums the
gradients over the ``data`` axis: N ranks compute the one-rank step on the
global batch, as GSPMD's step does.  A model's ``whole_batch_inputs``
(the alignment models' text side, which meets every audio row) reach
every rank whole, and :meth:`BaseRunner.output_rows` names the row counts
of the output that are batch rows (a mixup step's are half the batch's).
Rank 0 writes the checkpoints (full tensors) and the log; a checkpoint of
one mesh resumes under another.

Runs on the card unless ``device="cpu"`` is asked for.  TF32 is off: f32
convolutions and matrix products run in full f32, as the JAX reference
trains; the runner sets both ``torch.backends`` switches and logs it.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from texttoaudiogrounding_tpu_torch.data.loader import build_loader
from texttoaudiogrounding_tpu_torch.device import resolve_device
from texttoaudiogrounding_tpu_torch.models.remat import checkpointed
from texttoaudiogrounding_tpu_torch.parallel import tensor_parallel
from texttoaudiogrounding_tpu_torch.parallel.kernel_shard import (
    data_parallel,
    global_output,
)
from texttoaudiogrounding_tpu_torch.parallel.mesh import (
    device_feed,
    mesh_from_config,
)
from texttoaudiogrounding_tpu_torch.training.optim import (
    MetricImprover,
    Optimizer,
    ReduceLROnPlateau,
    freeze_mask_from_model,
    trainable_parameters,
)
from texttoaudiogrounding_tpu_torch.training.profiling import (
    StepProfiler,
    ThroughputMeter,
)
from texttoaudiogrounding_tpu_torch.training.train_state import (
    checkpoint_path,
    load_checkpoint,
    load_weights,
    save_checkpoint,
)
from texttoaudiogrounding_tpu_torch.utils.config import (
    dump_config,
    load_config,
)
from texttoaudiogrounding_tpu_torch.utils.registry import instantiate


def whole_batch_inputs(model) -> tuple:
    """The input keys ``model`` takes whole on every rank (its
    ``whole_batch_inputs``; none for most models)."""
    return tuple(getattr(model, "whole_batch_inputs", ()))


def _check_finite(iteration, tensors: dict) -> None:
    """``FloatingPointError`` naming the step and the first of
    ``tensors`` that holds a NaN or an infinity (``trainer.debug_nans``;
    reads them on the host)."""
    for name, t in tensors.items():
        if not bool(torch.isfinite(t.detach()).all()):
            raise FloatingPointError(
                f"step {iteration}: non-finite values in {name!r}")


def init_logger(filename: Path, level: str = "INFO") -> logging.Logger:
    """File + stdout logger (reference utils/train_util.py:91-101)."""
    logger = logging.getLogger(f"ttg_torch.{filename}")
    logger.setLevel(getattr(logging, level))
    for handler in list(logger.handlers):
        handler.close()
    logger.handlers.clear()
    formatter = logging.Formatter(
        "[ %(levelname)s : %(asctime)s ] - %(message)s")
    for handler in (logging.FileHandler(filename),
                    logging.StreamHandler(sys.stdout)):
        handler.setFormatter(formatter)
        logger.addHandler(handler)
    logger.propagate = False
    return logger


class BaseRunner:
    # leave the frozen parameters out of the checkpoints of a masked run
    # (``trainer.save_trainable_only`` overrides it)
    save_trainable_only = False

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.config: dict = {}
        self.mesh = None
        self.logger = logging.getLogger(__name__)
        self._freeze_mask = None
        # flags added to the model's input in train steps only, never in
        # validation (JAX ``_static_train_inputs``, ``runner_base.py:
        # 178-193``): the class-mapping runner's ``{"specaug": True}``
        self.static_train_inputs: dict = {}

    # ------------------------------------------------------------ builders
    def setup(self, config) -> dict:
        """``config``: a dict, or a JSON or YAML path.  Seeds numpy and
        torch (the dropout masks' generator starts from the torch seed)."""
        self.config = load_config(config)
        self.config.setdefault("seed", 1)
        np.random.seed(self.config["seed"])
        torch.manual_seed(self.config["seed"])
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.mesh = mesh_from_config(self.config.get("parallel"), self.device)
        return self.config

    def build_dataloader(self, cfg: dict, shuffle: bool):
        dataset = instantiate(cfg["dataset"])
        collate_fn = instantiate(cfg["collate_fn"])
        kwargs = dict(cfg.get("dataloader_args", {}))
        kwargs.setdefault("shuffle", shuffle)
        kwargs.setdefault("drop_last", shuffle)
        return build_loader(dataset, collate_fn,
                            seed=self.config.get("seed", 1), **kwargs)

    def build_model(self) -> torch.nn.Module:
        return instantiate(self.config["model"], device=self.device)

    def build_loss(self):
        return instantiate(self.config["loss"])

    @property
    def is_main(self) -> bool:
        """Rank 0, or the one process: the rank that writes and prints."""
        return self.mesh is None or self.mesh.is_main

    def prepare_experiment(self) -> Path:
        exp_dir = Path(self.config["experiment_path"])
        exp_dir.mkdir(parents=True, exist_ok=True)
        if self.is_main:
            dump_config(self.config, exp_dir / "config.json")
            self.logger = init_logger(exp_dir / "train.log")
        else:
            self.logger = logging.getLogger(f"ttg_torch.rank{self.mesh.rank}")
            self.logger.addHandler(logging.NullHandler())
            self.logger.propagate = False
        return exp_dir

    # --------------------------------------------------------------- steps
    def post_grad_hook(self, loss: torch.Tensor, grads: list) -> None:
        """Between the backward and the clipping: may change ``grads`` (the
        parameters' ``.grad``) in place.  The default leaves them."""

    def output_rows(self, batch: dict) -> tuple:
        """The leading dims of the step's output tensors that are the
        rank's rows of the batch: the batch's own."""
        return (batch["waveform"].shape[0],)

    def _global(self, output: dict, batch: dict):
        """``output`` of the rank's rows as the global batch's (its row
        tensors, by :meth:`output_rows`, gathered over the ``data`` axis
        when read)."""
        axis = None if self.mesh is None else self.mesh.axis("data")
        if axis is None:
            return output
        return global_output(output, self.output_rows(batch), axis)

    def train_step(self, model, loss_fn, optimizer, batch: dict,
                   output_transform: Callable,
                   iteration: int | None = None) -> torch.Tensor:
        """One optimizer step on ``batch`` (tensors on the device: the
        rank's rows); returns the global batch's loss, still on the
        device.  ``trainer.remat`` recomputes the forward's activations in
        the backward (``models/remat.py``, JAX ``jax.checkpoint``);
        ``trainer.debug_nans`` runs the step under
        ``torch.autograd.detect_anomaly`` (its forward traces kept for an
        error in the backward) and raises ``FloatingPointError`` at a
        non-finite output, loss or gradient, naming the step
        (``iteration``) and the tensor; an infinity raises too, where
        JAX's ``jax_debug_nans`` raises at a NaN only."""
        trainer = self.config.get("trainer", {})
        debug = trainer.get("debug_nans", False)
        model.train()
        inputs = {**batch, **self.static_train_inputs}
        with (torch.autograd.detect_anomaly(check_nan=False) if debug
              else contextlib.nullcontext()):
            with data_parallel(self.mesh):
                raw = (checkpointed(model, inputs)
                       if trainer.get("remat") else model(inputs))
                output = output_transform(raw, batch)
            loss = loss_fn(self._global(output, batch))
            if debug:
                _check_finite(iteration, {"loss": loss, **{
                    k: v for k, v in raw.items() if torch.is_tensor(v)
                    and v.is_floating_point()}})
            optimizer.zero_grad()
            loss.backward()
        if debug:
            _check_finite(iteration, {
                name: p.grad for name, p in model.named_parameters()
                if p.grad is not None})
        tensor_parallel.sync_grads(
            optimizer.params,
            None if self.mesh is None else self.mesh.axis("data"))
        self.post_grad_hook(loss.detach(), [p.grad for p in optimizer.params
                                            if p.grad is not None])
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def val_step(self, model, loss_fn, batch: dict,
                 output_transform: Callable) -> torch.Tensor:
        model.eval()
        return loss_fn(self._global(output_transform(model(batch), batch),
                                    batch))

    # ----------------------------------------------------------- main loop
    def fit(self, model, loss_fn, train_loader, val_loader,
            output_transform: Callable, exp_dir: Path) -> dict:
        """Epoch loop with plateau LR, early stop, best/last checkpoints
        (reference run_strong.py:712-810).  ``trainer.lr_update_interval``
        is ``"epoch"`` (the default: the scheduler's ``step``, where it
        has one, after each validation) or ``"iteration"`` (a callable
        scheduler's rate set before every step, JAX ``runner_base.py:
        437-462``).  Returns the run's record: ``train_loss`` and
        ``val_loss`` per epoch, ``step_loss`` and ``step_lr`` (every
        step's loss and learning rate), ``start_epoch`` and ``profile``
        (the traces written)."""
        trainer = self.config.get("trainer", {})
        epochs = trainer.get("epochs", 10)
        epoch_length = trainer.get("epoch_length")
        early_stop = trainer.get("early_stop", epochs)
        save_interval = trainer.get("save_interval", 1)
        include_optim = trainer.get("include_optim_in_ckpt", True)
        trainable_only = trainer.get("save_trainable_only",
                                     self.save_trainable_only)
        monitor = trainer.get("metric_monitor",
                              {"mode": "min", "name": "loss"})
        metric_improver = MetricImprover(monitor["mode"])
        self._freeze_mask = freeze_mask_from_model(model)
        ckpt_mask = self._freeze_mask if trainable_only else None
        mesh = self.mesh
        whole = whole_batch_inputs(model)
        shards = tensor_parallel.shard_model(
            model, mesh, self.config.get("parallel", {}).get("rules"))
        by_param = {model.get_parameter(n): s for n, s in shards.items()}
        optimizer = Optimizer(
            self.config.get("optimizer", {"type": "Adam",
                                          "args": {"lr": 1e-3}}),
            trainable_parameters(model, self._freeze_mask),
            trainer.get("max_grad_norm"), by_param)
        # the run's model and optimizer, for inspection after the fit
        self.model, self.optimizer = model, optimizer
        if "lr_scheduler" in self.config:
            scheduler = instantiate(self.config["lr_scheduler"])
        else:
            scheduler = ReduceLROnPlateau(mode=monitor["mode"])
        # "iteration": a callable scheduler gives every step's rate from
        # the fit's step count (from 0 in each fit, a resumed one too);
        # "epoch": its ``step`` moves the rate after each validation
        interval = trainer.get("lr_update_interval", "epoch")
        n_params = tensor_parallel.global_numel(model)
        n_train = sum(p.numel() * (by_param[p].axis.size if p in by_param
                                   else 1) for p in optimizer.params)
        # f32 parameters; the audio encoder computes in its own dtype
        compute = getattr(getattr(model, "audio_encoder", model), "dtype",
                          torch.float32)
        self.logger.info(
            f"{n_params} parameters ({n_train} trainable); device "
            f"{self.device}; compute "
            f"{str(compute).replace('torch.', '')}; TF32 "
            f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}; "
            f"mesh={mesh.shape}; sharded: {sorted(shards)}")

        start_epoch, not_improve_cnt = 1, 0
        if self.config.get("resume"):
            finetune = self.config.get("finetune",
                                       trainer.get("finetune", False))
            meta = self._resume(model, optimizer, scheduler, metric_improver,
                                self.config["resume"], finetune)
            if meta:
                start_epoch = meta["epoch"] + 1
                not_improve_cnt = meta["not_improve_cnt"]

        record = {"train_loss": [], "val_loss": [], "step_loss": [],
                  "step_lr": [], "start_epoch": start_epoch}
        profiler = StepProfiler(trainer.get("profile") if self.is_main
                                else None, exp_dir, self.device)
        meter = ThroughputMeter()

        def save(name: str) -> None:
            # every rank gathers the slices; rank 0 writes, the rest wait
            model_state = tensor_parallel.full_state_dict(model)
            optim_state = (tensor_parallel.full_optimizer_state(
                optimizer.state_dict(), optimizer.shards) if include_optim
                else None)
            if self.is_main:
                save_checkpoint(exp_dir / name, model, optimizer, scheduler,
                                epoch, metric_improver.state_dict(),
                                not_improve_cnt, include_optim,
                                trainable_only, ckpt_mask,
                                model_state=model_state,
                                optimizer_state=optim_state)
            mesh.barrier()

        iteration = 0
        epoch = start_epoch - 1
        train_iter = iter(train_loader)
        for epoch in range(start_epoch, epochs + 1):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            t0 = time.time()
            meter.reset()
            steps = epoch_length or len(train_loader)
            losses = []

            def epoch_batches():
                nonlocal train_iter
                for _ in range(steps):
                    try:
                        yield next(train_iter)
                    except StopIteration:
                        train_iter = iter(train_loader)
                        yield next(train_iter)

            for batch, _, real_bs in device_feed(epoch_batches(), mesh,
                                                 self.device, whole=whole):
                if interval == "iteration" and callable(scheduler):
                    optimizer.lr = scheduler(iteration)
                record["step_lr"].append(optimizer.lr)
                profiler.step(iteration)
                losses.append(self.train_step(
                    model, loss_fn, optimizer, batch, output_transform,
                    iteration))
                meter.update(real_bs)
                iteration += 1
            profiler.close(iteration)
            step_losses = torch.stack(losses).cpu().tolist()
            throughput = meter.summary()
            record["step_loss"].extend(step_losses)
            train_loss = float(np.mean(step_losses))

            val_losses = [float(self.val_step(
                model, loss_fn, batch, output_transform))
                for batch, _, _ in device_feed(val_loader, mesh, self.device,
                                               whole=whole)]
            val_loss = float(np.mean(val_losses))
            record["train_loss"].append(train_loss)
            record["val_loss"].append(val_loss)

            lr = optimizer.lr
            if interval == "epoch" and hasattr(scheduler, "step"):
                new_lr = scheduler.step(val_loss, lr)
                if new_lr != lr:
                    optimizer.lr = lr = new_lr
            self.logger.info(
                f"epoch: {epoch}  train_loss: {train_loss:.4g}  "
                f"val_loss: {val_loss:.4g}  lr: {lr:.2g}  "
                f"({time.time() - t0:.1f}s, {throughput})")

            if metric_improver(val_loss):
                not_improve_cnt = 0
                save("best.pth")
            else:
                not_improve_cnt += 1
            if epoch % save_interval == 0:
                save("last.pth")
            if not_improve_cnt == early_stop:
                break
        save("last.pth")
        record["profile"] = profiler.traces
        return record

    # ------------------------------------------------------ checkpoints
    def restore_state(self, model, exp_dir: Path, which: str = "best"
                      ) -> dict:
        """Load ``exp_dir``'s ``which`` checkpoint's weights into ``model``
        (evaluation; JAX ``runner_base.py:489``); returns its payload."""
        payload = load_checkpoint(checkpoint_path(exp_dir, which))
        load_weights(model, payload, self.logger.info)
        return payload

    def _resume(self, model, optimizer, scheduler, monitor, ckpt_path,
                finetune: bool = False) -> dict:
        """Restore a checkpoint into a fresh run (JAX
        ``runner_base.py:534``).  The weights always; unless ``finetune``,
        and where the checkpoint has them, the optimizer and scheduler
        states and the monitor.  Returns ``{epoch, not_improve_cnt}`` for a
        full resume, else ``{}``."""
        payload = load_checkpoint(ckpt_path)
        if (payload.get("trainables_only") and not finetune
                and self._freeze_mask is None):
            raise ValueError(
                f"{ckpt_path} is a trainable-only checkpoint but the current "
                "model freezes nothing: its frozen parameters cannot be "
                "restored")
        # a checkpoint holds full tensors: cut to this rank's slices
        payload = {**payload, "model": tensor_parallel.shard_state_dict(
            model, payload["model"])}
        load_weights(model, payload, self.logger.info)
        full = not finetune and "epoch" in payload
        if full:
            if "optimizer" in payload:
                optimizer.load_state_dict(
                    tensor_parallel.shard_optimizer_state(
                        payload["optimizer"], optimizer.shards))
            if "lr_scheduler" in payload:
                scheduler.load_state_dict(payload["lr_scheduler"])
            monitor.load_state_dict(payload["metric_monitor"])
        self.logger.info(f"resumed from {ckpt_path} (finetune={finetune}, "
                         f"epoch={payload.get('epoch')})")
        if not full:
            return {}
        return {"epoch": payload["epoch"],
                "not_improve_cnt": payload["not_improve_cnt"]}
