"""Command-line entry point (JAX ``cli.py:1-154``; reference runners
run_strong.py:1295-1296, with argparse):

    python -m texttoaudiogrounding_tpu_torch strong train \\
        --config configs/strong/biencoder_train.yaml [key.path=value ...]
    python -m texttoaudiogrounding_tpu_torch strong evaluate \\
        --experiment_path EXP --eval_config configs/strong/biencoder_eval.yaml
    python -m texttoaudiogrounding_tpu_torch class_mapping_weak \\
        evaluate_tagging --experiment_path EXP --eval_config EVAL
    python -m texttoaudiogrounding_tpu_torch inference \\
        --experiment_path EXP --audio x.wav --phrase "dog barking"
    python -m texttoaudiogrounding_tpu_torch export \\
        --experiment_path EXP --output DEPLOY_DIR [best | last]

The runners (``strong``, ``weak_phrase``, ``weak_phrase_selfsup``,
``weak_sentence``, ``class_mapping_strong``, ``class_mapping_weak``)
take the JAX commands; ``inference``, ``export``, ``evaluate_desed`` and
``evaluate_sed_eval`` are commands of their own.  A ``key=value`` in the
command slot is an override (the command is then ``train``).  One
argument more than the JAX CLI: ``--device`` (``cuda`` by default;
``--device cpu`` runs the plain PyTorch versions of the kernels on the
CPU).  ``calc_params_macs`` is not ported and exits with a message.
YAML configs and ``key=value`` overrides need PyYAML, the HDF5 datasets
h5py, the k-means datasets joblib; each is imported where it is used.
"""

from __future__ import annotations

import argparse
import sys

_RUNNERS = {
    "strong": ("runner_strong", "StrongRunner"),
    "weak_phrase": ("runner_weak_phrase", "WeakPhraseRunner"),
    "weak_phrase_selfsup": ("runner_weak_phrase",
                            "WeakPhraseSelfSupervisionRunner"),
    "weak_sentence": ("runner_weak_sentence", "WeakSentenceRunner"),
    "class_mapping_strong": ("runner_class_mapping",
                             "ClassMappingStrongRunner"),
    "class_mapping_weak": ("runner_class_mapping", "ClassMappingWeakRunner"),
}


def _runner(name: str, device):
    if name not in _RUNNERS:
        raise SystemExit(
            f"unknown runner '{name}' (expected strong | weak_phrase | "
            "weak_phrase_selfsup | weak_sentence | class_mapping_strong | "
            "class_mapping_weak | inference)")
    import importlib

    module, cls = _RUNNERS[name]
    return getattr(importlib.import_module(
        f"texttoaudiogrounding_tpu_torch.training.{module}"), cls)(
            device=device)


def _sed_eval(kw: dict):
    """Event- and segment-based F1 over prediction / ground-truth TSVs
    (reference python_scripts/evaluation/evaluate_sed_eval.py)."""
    from texttoaudiogrounding_tpu_torch.evaluation.sed_metrics import (
        compute_sed_eval,
    )
    from texttoaudiogrounding_tpu_torch.evaluation.tables import read_tsv

    event, segment = compute_sed_eval(
        read_tsv(kw["reference"]), read_tsv(kw["prediction"]),
        t_collar=kw.get("t_collar", 0.2),
        time_resolution=kw.get("time_resolution", 1.0))
    print(f"event-based F1 (micro): "
          f"{event['overall']['f_measure']:.4f}  "
          f"(macro): {event['class_wise_average']['f_measure']:.4f}")
    print(f"segment-based F1 (micro): "
          f"{segment['overall']['f_measure']:.4f}  "
          f"(macro): {segment['class_wise_average']['f_measure']:.4f}")
    return event, segment


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(prog="texttoaudiogrounding_tpu_torch")
    parser.add_argument("runner", help="strong | weak_phrase | "
                        "weak_phrase_selfsup | weak_sentence | "
                        "class_mapping_strong | class_mapping_weak | "
                        "inference | export | evaluate_desed | "
                        "evaluate_sed_eval")
    parser.add_argument("command", nargs="?", default=None,
                        help="train | evaluate | train_evaluate | "
                        "evaluate_psds | evaluate_th_auc | "
                        "evaluate_collar_auc | evaluate_intersection_auc | "
                        "evaluate_psds_single | evaluate_tagging | "
                        "evaluate_random | debug | calc_params")
    parser.add_argument("--config", default=None)
    parser.add_argument("--eval_config", default=None)
    parser.add_argument("--experiment_path", default=None)
    parser.add_argument("--audio", default=None)
    parser.add_argument("--phrase", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) | cpu")
    parser.add_argument("overrides", nargs="*",
                        help="key.path=value config overrides")
    args = parser.parse_args(argv)
    # a key=value token in the command slot is an override, not a command
    if args.command and "=" in args.command:
        args.overrides = [args.command] + args.overrides
        args.command = None

    if args.runner == "inference":
        from texttoaudiogrounding_tpu_torch.inference import run_inference
        return run_inference(experiment_path=args.experiment_path,
                             audio=args.audio, phrase=args.phrase,
                             output=args.output, device=args.device)

    if args.runner == "export":
        # export EXP to a standalone deployment directory:
        #   ... export --experiment_path EXP --output OUT [which]
        from texttoaudiogrounding_tpu_torch.deployment import (
            export_deployment,
        )
        if not args.output:
            parser.error("export requires --output (deployment dir)")
        out = export_deployment(args.experiment_path, args.output,
                                which=args.command or "best",
                                device=args.device)
        print(f"exported deployment -> {out}")
        return out

    if args.runner in ("evaluate_desed", "evaluate_sed_eval"):
        from texttoaudiogrounding_tpu_torch.utils.config import (
            parse_overrides,
        )
        kw = parse_overrides(args.overrides)
        if args.runner == "evaluate_sed_eval":
            return _sed_eval(kw)
        # zero-shot SED (reference python_scripts/evaluation/
        # evaluate_on_desed.py); overrides: wav=... gt=... duration=...
        from texttoaudiogrounding_tpu_torch.evaluation.desed import (
            run_desed_evaluation,
        )
        return run_desed_evaluation(
            args.experiment_path, kw["wav"], kw["gt"], kw["duration"],
            time_resolution=kw.get("time_resolution", 0.04),
            device=args.device)

    runner = _runner(args.runner, args.device)
    command = args.command or "train"
    if command == "train":
        return runner.train(args.config, args.overrides)
    if command == "evaluate":
        return runner.evaluate(args.experiment_path, args.eval_config,
                               args.overrides)
    if command == "train_evaluate":
        return runner.train_evaluate(args.config, args.eval_config,
                                     args.overrides)
    if command in ("evaluate_psds", "evaluate_th_auc",
                   "evaluate_collar_auc", "evaluate_intersection_auc",
                   "evaluate_psds_single", "evaluate_tagging"):
        return getattr(runner, command)(args.experiment_path,
                                        args.eval_config, args.overrides)
    if command == "evaluate_random":
        return runner.evaluate_random(args.eval_config, args.overrides)
    if command == "debug":
        return runner.debug(args.config, args.overrides)
    if command in ("calc_params", "calc_params_macs"):
        return getattr(runner, command)(args.config, args.overrides)
    raise SystemExit(f"unknown command '{command}'")


if __name__ == "__main__":
    main()
