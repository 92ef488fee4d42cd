"""Standalone deployment directories: export a trained run into a
self-contained directory, and serve one without the run's directory.

Port of ``texttoaudiogrounding_tpu/deployment.py:32-243`` (reference
models/hf_modeling_grounding.py:305-352).  :func:`export_deployment`
writes the directory the JAX package writes, but for its weights::

    deploy_dir/
      deploy.json         # model, tokenizer and inference settings (the
                          # JAX keys)
      vocabulary.pkl      # a DictTokenizer's vocabulary
      model.pth           # the weights, {"model": state_dict}: the port's
                          # state dict is the reference torch format
      config.json, modeling_grounding.py, pytorch_model.bin
                          # the trust_remote_code AutoModel artifact
                          # (BiEncoder(Cnn8Rnn, EmbeddingAgg, DotProduct or
                          # ExpNegL2) with a DictTokenizer only)

The JAX package writes its flax variables to ``weights.npz`` beside a
``model.pth``.  :func:`load_deployment` and
:func:`predictor_from_deployment` read either: a ``weights.npz``
(unflattened, through ``weights.from_jax_variables``) where the
directory has one, else ``model.pth``, each loaded strictly.
``hf_artifact/modeling_grounding.py`` is copied into exports and never
imported here.  ``python -m texttoaudiogrounding_tpu_torch.deployment
EXPERIMENT OUTPUT [--which best] [--device cuda]`` exports a run.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch

from texttoaudiogrounding_tpu_torch.device import resolve_device
from texttoaudiogrounding_tpu_torch.inference import GroundingPredictor
from texttoaudiogrounding_tpu_torch.training.train_state import (
    load_checkpoint,
)
from texttoaudiogrounding_tpu_torch.utils.config import load_config
from texttoaudiogrounding_tpu_torch.utils.registry import instantiate
from texttoaudiogrounding_tpu_torch.weights import from_jax_variables

HF_FILES = ["modeling_grounding.py", "config.json", "pytorch_model.bin"]


def _unflatten(flat: dict) -> dict:
    """``{"a/b/c": array}`` → nested dicts."""
    tree: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def export_deployment(experiment_path, output_dir, which: str = "best",
                      device="cuda") -> Path:
    """Pack ``experiment_path``'s ``which`` checkpoint into a standalone
    directory ``output_dir``; the model is built on ``device`` (the card
    unless the CPU is asked for)."""
    exp_dir = Path(experiment_path)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    config = load_config(exp_dir / "config.json")
    predictor = GroundingPredictor.from_experiment(exp_dir, which=which,
                                                   device=device)
    sd = {k: v.detach().cpu() for k, v in
          predictor.model.state_dict().items()}
    torch.save({"model": sd}, out / "model.pth")

    tok_cfg = json.loads(json.dumps(
        config["data"]["train"]["collate_fn"]["args"]["tokenizer"]))
    vocab = tok_cfg.get("args", {}).get("vocabulary")
    if vocab:
        shutil.copy(vocab, out / "vocabulary.pkl")
        tok_cfg["args"]["vocabulary"] = "vocabulary.pkl"

    hf_files = None
    try:
        export_hf_artifact(config, predictor, sd, out)
        hf_files = list(HF_FILES)
    except (ValueError, KeyError):
        pass

    deploy = {
        "model": config["model"],
        "torch_checkpoint": "model.pth",
        "hf_artifact": hf_files,
        "tokenizer": tok_cfg,
        "time_resolution": predictor.time_resolution,
        "audio_bucket": predictor.audio_bucket,
        "text_bucket": predictor.text_bucket,
        "batch_buckets": list(predictor.batch_buckets),
        "sample_rate": config["model"].get("audio_encoder", {})
                             .get("args", {}).get("sample_rate", 32000),
    }
    with open(out / "deploy.json", "w") as f:
        json.dump(deploy, f, indent=2)
    return out


def export_hf_artifact(config: dict, predictor, state_dict: dict,
                       out: Path) -> None:
    """The ``trust_remote_code`` AutoModel artifact beside the deployment
    files (JAX ``deployment.py:133-211``): ``modeling_grounding.py``
    (copied from ``hf_artifact/``), ``config.json`` with the ``auto_map``
    hooks and the vocabulary, and ``pytorch_model.bin``, the state dict
    under the wrapper's ``model.`` prefix.  Only BiEncoder(Cnn8Rnn,
    EmbeddingAgg, DotProduct or ExpNegL2) with a ``DictTokenizer``
    vocabulary; raises ``ValueError`` for anything else."""
    mcfg = config["model"]
    if mcfg.get("type") not in ("BiEncoder",):
        raise ValueError(f"HF artifact supports BiEncoder; "
                         f"got {mcfg.get('type')}")
    if mcfg["audio_encoder"]["type"] not in ("Cnn8Rnn", "Cnn8_Rnn"):
        raise ValueError("HF artifact supports Cnn8Rnn audio encoders")
    text_cfg = mcfg["text_encoder"]
    if text_cfg["type"] != "EmbeddingAgg":
        raise ValueError("HF artifact supports EmbeddingAgg text encoders")
    match_cfg = mcfg["match_fn"]
    match_type = match_cfg["type"].replace("Match", "")
    if match_type not in ("DotProduct", "ExpNegL2"):
        raise ValueError(f"no HF artifact match fn for {match_cfg['type']}")
    vocab = getattr(getattr(predictor.tokenizer, "vocabulary", None),
                    "word2idx", None)
    if vocab is None:
        raise ValueError("HF artifact needs a DictTokenizer vocabulary")

    hf_config = {
        "model_type": "text_audio_grounding",
        "architectures": ["GroundingModel"],
        "auto_map": {
            "AutoConfig": "modeling_grounding.GroundingConfig",
            "AutoModel": "modeling_grounding.GroundingModel",
        },
        "sample_rate": mcfg["audio_encoder"].get("args", {}).get(
            "sample_rate", 32000),
        "shared_dim": mcfg.get("args", {}).get("shared_dim", 512),
        "add_proj": mcfg.get("args", {}).get("add_proj", False),
        "upsample": mcfg.get("args", {}).get("upsample", False),
        "audio_encoder": {"type": "Cnn8Rnn"},
        "text_encoder": {
            "type": "EmbeddingAgg",
            "vocab_size": text_cfg["args"]["vocab_size"],
            "embed_dim": text_cfg["args"]["embed_dim"],
            "aggregation": text_cfg["args"].get("aggregation", "mean"),
        },
        "match_fn": {"type": match_type,
                     **{k: v for k, v in match_cfg.get("args", {}).items()
                        if k in ("l2norm", "scale", "text_level")}},
        "vocab": vocab,
        "torch_dtype": "float32",
    }
    with open(out / "config.json", "w") as f:
        json.dump(hf_config, f, indent=2)
    shutil.copy(Path(__file__).parent / "hf_artifact"
                / "modeling_grounding.py", out / "modeling_grounding.py")
    torch.save({f"model.{k}": v for k, v in state_dict.items()},
               out / "pytorch_model.bin")


def load_deployment(deploy_dir, device="cuda") -> tuple:
    """``(model on device, tokenizer, deploy.json)`` from a deployment
    directory, the port's or the JAX package's."""
    root = Path(deploy_dir)
    with open(root / "deploy.json") as f:
        deploy = json.load(f)
    model = instantiate(deploy["model"], device=resolve_device(device))
    if (root / "weights.npz").is_file():
        with np.load(root / "weights.npz") as z:
            variables = _unflatten({k: z[k] for k in z.files})
        state_dict = from_jax_variables(variables)
    else:
        state_dict = load_checkpoint(
            root / deploy.get("torch_checkpoint", "model.pth"))["model"]
    model.load_state_dict(state_dict)
    model.eval()

    tok_cfg = json.loads(json.dumps(deploy["tokenizer"]))
    vocab = tok_cfg.get("args", {}).get("vocabulary")
    if vocab and not Path(vocab).is_absolute():
        tok_cfg["args"]["vocabulary"] = str(root / vocab)
    return model, instantiate(tok_cfg), deploy


def predictor_from_deployment(deploy_dir, device="cuda"
                              ) -> GroundingPredictor:
    """A :class:`GroundingPredictor` on ``device`` (the card unless the CPU
    is asked for) from a deployment directory."""
    model, tokenizer, deploy = load_deployment(deploy_dir, device)
    return GroundingPredictor(
        model, tokenizer,
        time_resolution=deploy.get("time_resolution", 0.04),
        audio_bucket=deploy.get("audio_bucket", 32000),
        text_bucket=deploy.get("text_bucket", 4),
        # directories written before batch bucketing ran exact sizes
        batch_buckets=tuple(deploy.get("batch_buckets", ())))


def main(argv=None) -> Path:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("experiment_path")
    ap.add_argument("output_dir")
    ap.add_argument("--which", default="best")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = export_deployment(args.experiment_path, args.output_dir,
                            args.which, device=args.device)
    print(f"exported deployment -> {out}")
    return out


if __name__ == "__main__":
    main()
