"""Class-mapping SED runners: ``AudioTagging`` over phrase→class labels.

Port of ``texttoaudiogrounding_tpu/training/runner_class_mapping.py:26-223``
(reference python_scripts/training/mapping_to_class/run_strong.py and
run_weak.py).  :class:`ClassMappingStrongRunner` trains on strong frame
labels (``MaskedFrameBceLoss``, ``configs/class_mapping/kmeans_strong.yaml``)
and scores each evaluated phrase by its class channel,
``frame_sim[idx, :len, text_idx]`` (``configs/class_mapping/eval.yaml``),
through the strong runner's evaluation on tables.
:class:`ClassMappingWeakRunner` trains audio tagging on weak labels
(``ClipBceLoss``, ``kmeans_weak.yaml``) with mixup and SpecAugment:
the mixup coefficients are drawn on the host a batch
(:func:`_mixup_lambdas` on ``np.random.RandomState(seed + 1234)``, JAX's
draws bit for bit), the model mixes the log-mel and the length, the step's
output transform the labels; ``specaug`` reaches the train steps only.
``evaluate_tagging`` gives each class's average precision
(``evaluation/tagging.py``, NumPy) and writes it as a TSV with ``csv``.

On several ranks (``runner_base.py``) the mixup pairs (rows 2k, 2k + 1)
of the global batch are mixed as on one rank: within a rank where its
row count is even, else over the gathered rows, each rank mixing the
pairs whose even row it holds (``do_mixup``: the ranks then hold unequal
counts of mixed rows, one of them possibly none); the mixed outputs and
labels are gathered as the global batch's (:meth:`ClassMappingWeakRunner.
output_rows`), SpecAugment's stripes are drawn for the global batch and
cut to the rank's rows, as dropout's masks are; evaluation forwards each
rank's rows and gathers them (``eval_forward``), and rank 0 scores and
writes.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import torch

from texttoaudiogrounding_tpu_torch.evaluation.tagging import (
    average_precision,
)
from texttoaudiogrounding_tpu_torch.models.layers import do_mixup
from texttoaudiogrounding_tpu_torch.parallel.kernel_shard import mixup_rows
from texttoaudiogrounding_tpu_torch.training.runner_strong import StrongRunner
from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
    weak_output_transform,
)
from texttoaudiogrounding_tpu_torch.utils.config import (
    parse_config_or_kwargs,
)


def _mixup_lambdas(rng: np.random.RandomState, batch_size: int,
                   alpha: float = 1.0) -> np.ndarray:
    """Paired mixup coefficients ``[λ, 1 - λ, ...]``, λ ~ Beta(α, α)
    (reference utils/train_util.py:48-70)."""
    lams = []
    for _ in range(0, batch_size, 2):
        lam = float(rng.beta(alpha, alpha))
        lams.extend([lam, 1.0 - lam])
    return np.array(lams[:batch_size], np.float32)


def mapping_strong_output_transform(output: dict, batch: dict) -> dict:
    """The batch under the model output, ``weak_label`` as the class mask
    where the batch has no ``strong_label_mask`` (the k-means and spectral
    strong datasets), and ``frame_sim`` / ``strong_label`` cut to a common
    frame count with the lengths clamped to ``[1, T]`` (reference
    run_strong.py:107-118)."""
    merged = weak_output_transform(output, batch)
    if "strong_label_mask" not in merged and "weak_label" in merged:
        merged["strong_label_mask"] = merged["weak_label"]
    if "strong_label" in merged:
        frame_sim = merged["frame_sim"]
        label = merged["strong_label"].to(frame_sim.dtype)
        t = min(frame_sim.shape[1], label.shape[1])
        merged["frame_sim"] = frame_sim[:, :t]
        merged["strong_label"] = label[:, :t]
        merged["length"] = torch.clamp(merged["length"], 1, t)
    return merged


def mixup_output_transform(output: dict, batch: dict) -> dict:
    """The batch under the model output, with ``label`` mixed by the
    batch's ``mixup_lambda`` where it has one (a train batch under mixup:
    the model mixed its features the same way)."""
    merged = weak_output_transform(output, batch)
    if "mixup_lambda" in batch:
        merged["label"] = do_mixup(batch["label"], batch["mixup_lambda"])
    return merged


class ClassMappingStrongRunner(StrongRunner):
    """``ClassMappingStrongRunner(device).train(config)`` (strong class
    labels) and ``.evaluate(exp_dir, eval_config)``, each phrase scored by
    its mapped class channel."""

    output_transform = staticmethod(mapping_strong_output_transform)

    def eval_tracks(self, output: dict, model, batch: dict) -> list:
        """``frame_sim[idx, :len, text_idx]`` of each item (reference
        mapping_to_class/run_strong.py:202-228)."""
        frame_sim = output["frame_sim"].float().cpu().numpy()
        lengths = output["length"].cpu().numpy()
        text_idx = np.asarray(batch["text_idx"])
        return [frame_sim[i, :max(int(n), 1), int(text_idx[i])]
                for i, n in enumerate(lengths)]


class _AugLoader:
    """The training loader with each batch's mixup coefficients added
    (``mixup_lambda [B]``, drawn on the host in batch order)."""

    def __init__(self, inner, mix_rng, mixup: bool):
        self.inner = inner
        self.dataset = inner.dataset
        self.mix_rng = mix_rng
        self.mixup = mixup
        if hasattr(inner, "set_epoch"):
            self.set_epoch = inner.set_epoch

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        for batch in self.inner:
            out = dict(batch)
            if self.mixup:
                out["mixup_lambda"] = _mixup_lambdas(
                    self.mix_rng, out["waveform"].shape[0])
            yield out


class ClassMappingWeakRunner(ClassMappingStrongRunner):
    """Weak class mapping (audio tagging) with mixup and SpecAugment
    (reference mapping_to_class/run_weak.py:34-58): ``mixup: true`` and
    ``specaug: true`` at the config's top level."""

    def output_rows(self, batch: dict) -> tuple:
        """A mixup step's outputs (and mixed labels) have the rank's mixed
        rows (half the rank's rows, or each rank's count of the pairs whose
        even row it holds: ``kernel_shard.mixup_rows``); the batch's other
        entries its rows."""
        rows = batch["waveform"].shape[0]
        if "mixup_lambda" not in batch:
            return (rows,)
        axis = None if self.mesh is None else self.mesh.axis("data")
        mixed = mixup_rows(rows, axis)
        return (rows, mixed[0] if len(set(mixed)) == 1 else mixed)

    def fit(self, model, loss_fn, train_loader, val_loader,
            output_transform, exp_dir) -> dict:
        """The base ``fit`` over the loader with mixup coefficients and the
        ``specaug`` flag in the train steps; ``output_transform`` gives way
        to :func:`mixup_output_transform` (validation batches carry no
        ``mixup_lambda``)."""
        use_mixup = self.config.get("mixup", False)
        self.static_train_inputs = (
            {"specaug": True} if self.config.get("specaug", False) else {})
        mix_rng = np.random.RandomState(self.config.get("seed", 1) + 1234)
        return super().fit(model, loss_fn,
                           _AugLoader(train_loader, mix_rng, use_mixup),
                           val_loader, mixup_output_transform, exp_dir)

    def evaluate_tagging(self, experiment_path, eval_config, overrides=None,
                         **kwargs) -> dict:
        """Each class's average precision over the run's validation set
        (reference mapping_to_class/run_weak.py:60-103): a table
        ``{"label_index", "ap"}``, 0 for a class without a positive,
        written as a TSV to the eval config's ``output`` in the run's
        directory where it names one; the weights are the run's best.  On
        several ranks each rank forwards its rows (``eval_forward``) and
        rank 0 scores and writes; every rank returns the table."""
        eval_config = parse_config_or_kwargs(eval_config, overrides,
                                             **kwargs)
        exp_dir = Path(experiment_path)
        self.setup(exp_dir / "config.json")
        model = self.build_model()
        dataloader = self.build_dataloader(self.config["data"]["val"],
                                           shuffle=False)
        self.restore_state(model, exp_dir, "best")
        model.eval()
        probs, labels = [], []
        with torch.no_grad():
            for batch in dataloader:
                output = self.eval_forward(batch, model)
                probs.append(output["clip_sim"].float().cpu().numpy())
                labels.append(np.asarray(batch["label"]))
        return self.main_only(_tagging_result, np.concatenate(probs),
                              np.concatenate(labels), exp_dir,
                              eval_config.get("output"))


def _tagging_result(probs: np.ndarray, labels: np.ndarray, exp_dir: Path,
                    out: str | None) -> dict:
    """Each class's average precision, written as a TSV to ``exp_dir /
    out`` where ``out`` is given."""
    result = {"label_index": np.arange(labels.shape[1]),
              "ap": average_precision(labels, probs)}
    if out:
        with open(exp_dir / out, "w", newline="") as f:
            writer = csv.writer(f, delimiter="\t", lineterminator="\n")
            writer.writerow(["label_index", "ap"])
            writer.writerows(zip(result["label_index"].tolist(),
                                 result["ap"].tolist()))
    print(f"tagging mAP: {result['ap'].mean():.4f}")
    return result
