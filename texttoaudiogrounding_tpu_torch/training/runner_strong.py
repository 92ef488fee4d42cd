"""Strongly-supervised grounding: frame-BCE training and evaluation.

Port of ``texttoaudiogrounding_tpu/training/runner_strong.py`` (reference
python_scripts/training/run_strong.py).  ``evaluate`` runs the test set
through the model in batches (one host copy of ``frame_sim`` and
``length`` a batch), decodes every track at ``n_thresholds`` thresholds
(``decode_multi_threshold``, native by default) and reports PSDS over
``max_efprs`` and th-AUC over two ranges, all on tables
(``evaluation/tables.py``) without pandas.  ``model_overrides`` in the
eval config evaluates a checkpoint in another configuration of the same
weights, e.g. the serving one, ``{audio_encoder: {args: {dtype: bfloat16,
conv_mode: int8}}}``.  ``calc_params`` counts the parameters of the JAX
package's flax tree; the MAC count (``calc_params_macs``) is not ported
and exits with :data:`CALC_PARAMS_MACS_MESSAGE`.
"""

from __future__ import annotations

import copy
import math
import time
from pathlib import Path

import numpy as np
import torch

from texttoaudiogrounding_tpu_torch.data.loader import to_device
from texttoaudiogrounding_tpu_torch.evaluation.decode import (
    decode_multi_threshold,
)
from texttoaudiogrounding_tpu_torch.evaluation.psds import (
    compute_psds,
    compute_psds_sed_scores,
)
from texttoaudiogrounding_tpu_torch.evaluation.tables import (
    drop,
    table,
    write_tsv,
)
from texttoaudiogrounding_tpu_torch.evaluation.th_auc import compute_th_auc
from texttoaudiogrounding_tpu_torch.models.layers import BiGRU
from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
from texttoaudiogrounding_tpu_torch.training.runner_base import BaseRunner
from texttoaudiogrounding_tpu_torch.utils.config import (
    merge_a_into_b,
    parse_config_or_kwargs,
)
from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

CALC_PARAMS_MACS_MESSAGE = (
    "calc_params_macs is not ported: the JAX package counts the forward's "
    "FLOPs with XLA's cost_analysis() of the compiled program, and PyTorch "
    "has no counter of the same operations; calc_params gives the "
    "parameter count")


def strong_output_transform(output: dict, batch: dict) -> dict:
    """Cut ``frame_sim`` and ``label`` to a common length and clamp the
    lengths to ``[1, T]`` (reference run_strong.py:107-118)."""
    frame_sim = output["frame_sim"]
    label = batch["label"].to(frame_sim.dtype)
    t = min(frame_sim.shape[1], label.shape[1])
    length = torch.clamp(output["length"], 1, t)
    return {**output, "frame_sim": frame_sim[:, :t], "label": label[:, :t],
            "length": length}


def build_grounding_ground_truth(data: list) -> dict:
    """Ground truth keyed by ``{audiocap_id}_{start_index}``: ``gt_table``
    (filename, event_label, onset, offset, audio_id), ``gt_dict`` (filename
    → [(onset, offset, "fake_event")]) and ``fname_to_aid``; zero-length
    segments are skipped (reference run_strong.py:176-200)."""
    rows, gt_dict, fname_to_aid = [], {}, {}
    for audio_item in data:
        audio_id = audio_item["audio_id"]
        for phrase_item in audio_item["phrases"]:
            fname = (f"{audio_item['audiocap_id']}_"
                     f"{phrase_item['start_index']}")
            gt_dict[fname] = []
            fname_to_aid[fname] = audio_id
            for onset, offset in phrase_item["segments"]:
                if onset == 0 and offset == 0:
                    continue
                rows.append((fname, onset, offset, audio_id))
                gt_dict[fname].append((onset, offset, "fake_event"))
    gt_table = table({"filename": [r[0] for r in rows],
                      "event_label": ["fake_event"] * len(rows),
                      "onset": [r[1] for r in rows],
                      "offset": [r[2] for r in rows],
                      "audio_id": [r[3] for r in rows]})
    return {"gt_table": gt_table, "gt_dict": gt_dict,
            "fname_to_aid": fname_to_aid}


def detection_tables(segments: dict) -> dict:
    """``{threshold: [(filename, [R, 2] seconds), ...]}`` → ``{threshold:
    table(filename, event_label, onset, offset)}``."""
    out = {}
    for th, per_file in segments.items():
        names = [f for f, seg in per_file for _ in range(len(seg))]
        pairs = (np.concatenate([seg for _, seg in per_file])
                 if per_file else np.zeros((0, 2)))
        out[th] = table({"filename": names,
                         "event_label": ["fake_event"] * len(names),
                         "onset": pairs[:, 0], "offset": pairs[:, 1]})
    return out


class StrongRunner(BaseRunner):
    """``StrongRunner(device).train(config)`` and the ``evaluate*`` entry
    points; ``config`` is a dict, a JSON or a YAML path (PyYAML needed
    for YAML), the data HDF5 files (h5py needed) or waveforms in memory."""

    output_transform = staticmethod(strong_output_transform)

    # ---------------------------------------------------------------- train
    def train(self, config, overrides=None, **kwargs) -> Path:
        self.setup(parse_config_or_kwargs(config, overrides, **kwargs))
        exp_dir = self.prepare_experiment()
        train_loader = self.build_dataloader(self.config["data"]["train"],
                                             shuffle=True)
        val_loader = self.build_dataloader(self.config["data"]["val"],
                                           shuffle=False)
        model = self.build_model()
        loss_fn = self.build_loss()
        self.fit(model, loss_fn, train_loader, val_loader,
                 self.train_transform(), exp_dir)
        return exp_dir

    def train_transform(self):
        """The output transform of ``train``'s steps, built after the
        model and the loss."""
        return self.output_transform

    # ------------------------------------------------------------ inference
    def eval_batch(self, batch: dict, model) -> dict:
        """A loader batch as the model's input on the device."""
        return to_device(batch, self.device)

    def eval_inference(self, dataloader, model,
                       scores_per_sample=None) -> dict:
        """Batched inference, then every track decoded at all thresholds
        (reference run_strong.py:171-277): ``pred_buffer`` (threshold →
        detection table), ``score_buffer`` (filename → score track
        ``{onset, offset, fake_event}``) and the ground truth.  The host
        seconds of the forwards (the host copy included) and of decoding go
        to ``self.eval_seconds``."""
        eval_cfg = self.config.get("eval_config", {})
        n_thresholds = eval_cfg.get("n_thresholds", 50)
        thresholds = np.arange(1 / (n_thresholds * 2), 1, 1 / n_thresholds)
        window_size = self.config.get("inference_args",
                                      {}).get("window_size", 1)
        time_resolution = self._train_time_resolution()
        n_connect = math.ceil(0.5 / time_resolution)

        gt = build_grounding_ground_truth(dataloader.dataset.data)
        valid_fnames = set(gt["gt_table"]["filename"])
        model.eval()
        segments: dict = {th: [] for th in thresholds}
        score_buffer: dict = {}
        forward_s = decode_s = 0.0
        for batch in dataloader:
            t0 = time.perf_counter()
            with torch.no_grad():
                tracks = self.eval_tracks(
                    model(self.eval_batch(batch, model)), model, batch)
            t1 = time.perf_counter()
            for idx, scores in enumerate(tracks):
                fname = (f"{batch['audiocap_id'][idx]}_"
                         f"{batch['start_index'][idx]}")
                if fname not in valid_fnames:
                    continue
                if scores_per_sample is not None:
                    scores = scores_per_sample(scores)
                timestamps = np.arange(len(scores) + 1) * time_resolution
                score_buffer[fname] = {"onset": timestamps[:-1],
                                       "offset": timestamps[1:],
                                       "fake_event": scores}
                segs = decode_multi_threshold(
                    scores, thresholds, window_size=window_size,
                    connect_n=n_connect, time_resolution=time_resolution)
                for th, seg in zip(thresholds, segs):
                    segments[th].append((fname, seg))
            forward_s += t1 - t0
            decode_s += time.perf_counter() - t1
        self.eval_seconds = {"forward": forward_s, "decode": decode_s}
        return {"pred_buffer": detection_tables(segments),
                "score_buffer": score_buffer, **gt}

    def eval_tracks(self, output: dict, model, batch: dict) -> list:
        """Each item's score track (numpy, on the host) from the forward's
        output on the loader's ``batch``: ``frame_sim`` (at the first
        phrase of a multi-phrase one) cut to the item's length."""
        frame_sim = output["frame_sim"].float().cpu().numpy()
        lengths = output["length"].cpu().numpy()
        if frame_sim.ndim == 3:
            frame_sim = frame_sim[:, :, 0]
        return [scores[:max(int(n), 1)]
                for scores, n in zip(frame_sim, lengths)]

    def _train_time_resolution(self) -> float:
        try:
            return self.config["data"]["train"]["dataset"]["args"][
                "time_resolution"]
        except KeyError:
            return 0.04

    # ------------------------------------------------------------- evaluate
    def evaluate(self, experiment_path, eval_config, overrides=None,
                 **kwargs) -> dict:
        """The full metric suite on the test set (reference
        run_strong.py:814-905): threshold-free PSDS over ``max_efprs`` and
        th-AUC over two ranges; predictions, curves and ``result.txt``
        written to the experiment directory.  The buffers stay on the
        runner as ``eval_output`` (``eval_inference``'s dict)."""
        exp_dir, eval_config, model, dataloader = self._load_for_eval(
            experiment_path, eval_config, overrides, **kwargs)
        self.eval_output = self.eval_inference(dataloader, model)
        return self._report_metrics(self.eval_output, eval_config, exp_dir)

    def _copy_train_keys(self, test_cfg: dict,
                         keys=("vocabulary", "model_type")) -> None:
        """Copy train-time dataset / tokenizer args into the eval config
        (reference copy_args_recursive, run_strong.py:823-826)."""
        def rec(src, tgt):
            for k, v in src.items():
                if k == "args":
                    for key in v:
                        if key in keys:
                            tgt.setdefault("args", {})[key] = v[key]
                elif isinstance(v, dict) and isinstance(tgt.get(k), dict):
                    rec(v, tgt[k])
        rec(self.config["data"]["train"], test_cfg)

    def _report_metrics(self, output: dict, eval_config: dict,
                        exp_dir: Path) -> dict:
        exp_dir = Path(exp_dir)
        pred_buffer = output["pred_buffer"]
        pred_dir = exp_dir / "predictions"
        for th, events in pred_buffer.items():
            write_tsv(events, pred_dir / f"predictions_th_{th:.2f}.tsv")

        duration = eval_config["data"]["test"]["duration"]
        gt_events = drop(output["gt_table"], "event_label", "audio_id")
        results = {}
        seconds = {"psds": 0.0, "th_auc": 0.0}
        out_path = exp_dir / eval_config.get("output", "result.txt")
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as writer:
            for max_efpr in eval_config.get("max_efprs", [None]):
                t0 = time.perf_counter()
                psds = compute_psds_sed_scores(
                    scores=output["score_buffer"],
                    ground_truth=output["gt_dict"], duration=duration,
                    fname_to_aid=output["fname_to_aid"],
                    dtc_threshold=0.5, gtc_threshold=0.5,
                    max_efpr=max_efpr,
                    save_dir=exp_dir / eval_config.get("psds_dir", "psds"))
                seconds["psds"] += time.perf_counter() - t0
                results[f"psds@{max_efpr}"] = psds
                line = f"max_efpr: {max_efpr}, psds: {psds:.1%}"
                print(line)
                print(line, file=writer)
            for min_th, max_th in zip([0.0, 0.2], [1.0, 0.8]):
                t0 = time.perf_counter()
                th_auc = compute_th_auc(
                    pred_buffer, gt_events, dtc_threshold=0.5,
                    gtc_threshold=0.5, min_threshold=min_th,
                    max_threshold=max_th,
                    save_dir=exp_dir / eval_config.get("th_auc_dir",
                                                       "th_auc"))
                seconds["th_auc"] += time.perf_counter() - t0
                results[f"th_auc@{min_th}-{max_th}"] = th_auc
                line = (f"threshold: {min_th:.2f} ~ {max_th:.2f}, "
                        f"th_auc: {th_auc:.1%}")
                print(line)
                print(line, file=writer)
        self.eval_seconds = {**getattr(self, "eval_seconds", {}), **seconds}
        return results

    def _load_for_eval(self, experiment_path, eval_config, overrides=None,
                       **kwargs) -> tuple:
        """Reload the experiment's config, rebuild the model (with the eval
        config's ``model_overrides``), load the ``resume`` checkpoint
        (``best`` by default) and build the test loader."""
        eval_config = parse_config_or_kwargs(eval_config, overrides,
                                             **kwargs)
        exp_dir = Path(experiment_path)
        self.setup(exp_dir / "config.json")
        if eval_config.get("model_overrides"):
            merge_a_into_b(copy.deepcopy(eval_config["model_overrides"]),
                           self.config["model"])
        self.config["eval_config"] = {
            "n_thresholds": eval_config.get("n_thresholds", 50)}
        inf_args = {"window_size": eval_config.get("window_size", 1)}
        for key in ("time_resolution", "word_aggregation"):
            if key in eval_config:
                inf_args[key] = eval_config[key]
        self.config["inference_args"] = inf_args
        model = self.build_model()
        test_cfg = eval_config["data"]["test"]
        self._copy_train_keys(test_cfg)
        dataloader = self.build_dataloader(test_cfg, shuffle=False)
        self.restore_state(model, exp_dir, eval_config.get("resume", "best"))
        return exp_dir, eval_config, model, dataloader

    def evaluate_psds(self, experiment_path, eval_config, overrides=None,
                      **kwargs) -> dict:
        """Operating-point PSDS (psds_eval path, reference
        run_strong.py:966-1052) at dtc = gtc in ``dtc_gtc_thresholds``."""
        _, eval_config, model, dataloader = self._load_for_eval(
            experiment_path, eval_config, overrides, **kwargs)
        output = self.eval_inference(dataloader, model)
        results = {}
        for dtc_gtc in eval_config.get("dtc_gtc_thresholds",
                                       [0.1, 0.5, 0.7]):
            value = compute_psds(
                output["pred_buffer"], output["gt_table"],
                eval_config["data"]["test"]["duration"],
                dtc_threshold=dtc_gtc, gtc_threshold=dtc_gtc,
                max_efpr=eval_config.get("max_efpr"))
            results[f"psds_op@dtc=gtc={dtc_gtc}"] = value
            print(f"dtc=gtc={dtc_gtc}: psds={value:.1%}")
        return results

    def evaluate_th_auc(self, experiment_path, eval_config, overrides=None,
                        **kwargs) -> dict:
        """th-AUC over the whole threshold range (reference
        run_strong.py:1054-1116)."""
        exp_dir, eval_config, model, dataloader = self._load_for_eval(
            experiment_path, eval_config, overrides, **kwargs)
        output = self.eval_inference(dataloader, model)
        value = compute_th_auc(
            output["pred_buffer"],
            drop(output["gt_table"], "event_label", "audio_id"),
            dtc_threshold=0.5, gtc_threshold=0.5,
            save_dir=exp_dir / eval_config.get("th_auc_dir", "th_auc"))
        print(f"th_auc_scenario1: {value:.1%}")
        return {"th_auc": value}

    def evaluate_collar_auc(self, experiment_path, eval_config,
                            overrides=None, **kwargs) -> dict:
        """Collar-based F-score-curve AUC (reference
        run_strong.py:1118-1163)."""
        from texttoaudiogrounding_tpu_torch.evaluation.curves import (
            collar_fscore_curve,
        )

        _, eval_config, model, dataloader = self._load_for_eval(
            experiment_path, eval_config, overrides, **kwargs)
        output = self.eval_inference(dataloader, model)
        collar = eval_config.get("collar", 0.2)
        result = collar_fscore_curve(
            output["score_buffer"], output["gt_dict"],
            onset_collar=collar, offset_collar=collar,
            offset_collar_rate=eval_config.get("offset_collar_rate", 0.2),
            num_thresholds=eval_config.get("n_thresholds", 50))
        print(f"collar auc: {result['auc']:.2%}")
        return {"collar_auc": result["auc"]}

    def evaluate_intersection_auc(self, experiment_path, eval_config,
                                  overrides=None, **kwargs) -> dict:
        """Intersection-criteria threshold AUC and best F1 (reference
        run_strong.py:1166-1207)."""
        from texttoaudiogrounding_tpu_torch.evaluation.curves import (
            intersection_fscore_curve,
        )

        _, eval_config, model, dataloader = self._load_for_eval(
            experiment_path, eval_config, overrides, **kwargs)
        output = self.eval_inference(dataloader, model)
        result = intersection_fscore_curve(
            output["score_buffer"], output["gt_dict"],
            dtc_threshold=0.5, gtc_threshold=0.5,
            num_thresholds=eval_config.get("n_thresholds", 50))
        print(f"intersection auc: {result['score']:.2%}")
        print(f"best f1: {result['f_max']:.2%}")
        return {"intersection_auc": result["score"],
                "best_f1": result["f_max"]}

    def evaluate_psds_single(self, experiment_path, eval_config,
                             overrides=None, **kwargs) -> dict:
        """Each audio item through the whole PSDS pipeline alone (reference
        run_strong.py:1219-1263): a table (audiocap_id, psds), written as a
        TSV to ``output`` when the eval config names one."""
        exp_dir, eval_config, model, dataloader = self._load_for_eval(
            experiment_path, eval_config, overrides, **kwargs)
        dataset = dataloader.dataset
        all_data = list(dataset.data)
        duration = eval_config["data"]["test"]["duration"]
        ids, values = [], []
        try:
            for single in all_data:
                dataset.data = [single]
                dataset.generate_index()
                output = self.eval_inference(dataloader, model)
                if not len(output["gt_table"]["filename"]):
                    continue
                ids.append(single["audiocap_id"])
                values.append(compute_psds_sed_scores(
                    scores=output["score_buffer"],
                    ground_truth=output["gt_dict"], duration=duration,
                    fname_to_aid=output["fname_to_aid"],
                    dtc_threshold=0.5, gtc_threshold=0.5,
                    max_efpr=eval_config.get("max_efpr")))
        finally:
            dataset.data = all_data
            dataset.generate_index()
        result = table({"audiocap_id": ids,
                        "psds": np.asarray(values, np.float64)})
        if eval_config.get("output"):
            write_tsv(result, exp_dir / eval_config["output"])
        return result

    # -------------------------------------------------------- sanity floors
    def evaluate_random(self, eval_config, overrides=None, **kwargs) -> dict:
        """Uniform-random frame scores through the whole metric pipeline
        (reference run_strong.py:279-380, 908-964)."""
        eval_config = parse_config_or_kwargs(eval_config, overrides,
                                             **kwargs)
        test_cfg = eval_config["data"]["test"]
        dataset = instantiate(test_cfg["dataset"])
        time_resolution = eval_config.get("time_resolution", 0.04)
        n_thresholds = eval_config.get("n_thresholds", 50)
        thresholds = np.arange(1 / (n_thresholds * 2), 1, 1 / n_thresholds)
        n_connect = math.ceil(0.5 / time_resolution)
        rng = np.random.default_rng(eval_config.get("seed", 0))

        gt = build_grounding_ground_truth(dataset.data)
        segments: dict = {th: [] for th in thresholds}
        score_buffer: dict = {}
        for audio_item in dataset.data:
            for phrase_item in audio_item["phrases"]:
                fname = (f"{audio_item['audiocap_id']}_"
                         f"{phrase_item['start_index']}")
                if fname not in gt["gt_dict"]:
                    continue
                events = gt["gt_dict"][fname]
                duration = (max(float(o) for _, o, _ in events) if events
                            else 10.0)
                n_frames = int(duration / time_resolution) + 1
                scores = rng.uniform(size=n_frames).astype(np.float32)
                timestamps = np.arange(n_frames + 1) * time_resolution
                score_buffer[fname] = {"onset": timestamps[:-1],
                                       "offset": timestamps[1:],
                                       "fake_event": scores}
                segs = decode_multi_threshold(
                    scores, thresholds,
                    window_size=eval_config.get("window_size", 1),
                    connect_n=n_connect, time_resolution=time_resolution)
                for th, seg in zip(thresholds, segs):
                    segments[th].append((fname, seg))
        results = {}
        for max_efpr in eval_config.get("max_efprs", [None]):
            results[f"psds@{max_efpr}"] = compute_psds_sed_scores(
                scores=score_buffer, ground_truth=gt["gt_dict"],
                duration=test_cfg["duration"],
                fname_to_aid=gt["fname_to_aid"], max_efpr=max_efpr)
        results["th_auc@0.0-1.0"] = compute_th_auc(
            detection_tables(segments),
            drop(gt["gt_table"], "event_label", "audio_id"))
        return results

    # ----------------------------------------------------------------- misc
    def train_evaluate(self, train_config, eval_config, overrides=None,
                       **kwargs) -> dict:
        exp_dir = self.train(train_config, overrides, **kwargs)
        return self.evaluate(exp_dir, eval_config)

    def debug(self, config, overrides=None, iters: int = 3,
              **kwargs) -> list:
        """A few train steps on one batch to check shapes and gradients
        (reference run_strong.py:1267-1276); returns the losses."""
        self.setup(parse_config_or_kwargs(config, overrides, **kwargs))
        train_loader = self.build_dataloader(self.config["data"]["train"],
                                             shuffle=True)
        model = self.build_model()
        loss_fn = self.build_loss()
        optimizer = Optimizer(
            self.config.get("optimizer", {"type": "Adam",
                                          "args": {"lr": 1e-3}}),
            model.parameters(),
            self.config.get("trainer", {}).get("max_grad_norm"))
        batch = to_device(next(iter(train_loader)), self.device)
        losses = []
        for i in range(iters):
            losses.append(float(self.train_step(
                model, loss_fn, optimizer, batch, self.output_transform)))
            print(f"debug iter {i}: loss={losses[-1]:.4f}")
        return losses

    def calc_params(self, config, overrides=None, **kwargs) -> int:
        """The model's parameter count as the JAX package counts its flax
        tree (``runner_strong.py:468-469``): every parameter but each GRU
        direction's r/z recurrent biases (``bias_hh[:2H]``), which the flax
        cells lack and the port keeps detached (``models/layers.py``
        ``BiGRU``)."""
        self.setup(parse_config_or_kwargs(config, overrides, **kwargs))
        model = self.build_model()
        n = sum(p.numel() for p in model.parameters()) - sum(
            2 * m.hidden * 2 for m in model.modules() if isinstance(m, BiGRU))
        print(f"params: {n}")
        return n

    def calc_params_macs(self, config, overrides=None, **kwargs):
        """Not ported: see :data:`CALC_PARAMS_MACS_MESSAGE`."""
        raise SystemExit(CALC_PARAMS_MACS_MESSAGE)
