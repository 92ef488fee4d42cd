"""The port's loss classes against the JAX package's.

Every class of ``texttoaudiogrounding_tpu/losses.py`` beyond the two BCEs
the trainers already used, one parametrised case each, on the same output
dict made from a numpy seed: the loss within 1e-6 relative (1e-7
absolute).  ``RandomTripletLoss`` is held on the same drawn negatives (the
JAX key's draws given to the port's ``at``), and the port's own draws come
from an explicit ``torch.Generator``.  The frame BCE's ``[B, T, C]`` form
(which ``ClipFrameBceLoss`` reaches) is held too, and every name resolves
in the port's registry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texttoaudiogrounding_tpu import losses as jlosses
from texttoaudiogrounding_tpu_torch import losses
from texttoaudiogrounding_tpu_torch.utils.registry import resolve


def _outputs(seed: int = 0) -> dict:
    """Every key some loss reads, as numpy arrays."""
    rng = np.random.default_rng(seed)
    b, t, c = 4, 7, 5
    out = {
        "clip_sim": rng.uniform(0.02, 0.98, (b, c)),
        "label": (rng.random((b, c)) > 0.5).astype(np.float64),
        "counts": rng.integers(1, 50, (b, c)).astype(np.float64),
        "label_mask": (rng.random((b, c)) > 0.3).astype(np.float64),
        "frame_sim": rng.uniform(0.02, 0.98, (b, t, c)),
        "strong_label": (rng.random((b, t, c)) > 0.6).astype(np.float64),
        "strong_label_mask": (rng.random((b, c)) > 0.2).astype(np.float64),
        "weak_label": (rng.random((b, c)) > 0.5).astype(np.float64),
        "length": np.array([7, 5, 3, 6]),
        "sim": rng.normal(0.0, 0.6, (b, b)),
        "sim2": rng.normal(0.0, 0.6, (b, b)),
        "vq_loss": np.array(0.37),
    }
    out["strong_label_mask"][0] = 1.0
    # one clear winner a row for the weighted triplet's mixed case
    out["sim"][np.arange(b), np.arange(b)] += 0.9
    return {k: v.astype(np.float32) if v.dtype.kind == "f" else v
            for k, v in out.items()}


# case -> constructor arguments ("vq" and "sum" build the losses the
# wrapper classes take); the class is the case's name up to its "_"
CASES = {
    "MilNceLoss": {"tau": 0.5},
    "FocalClipBceLoss": {"gamma": 2, "alpha": 0.25},
    "ClipBceLossFreqWeight": {"C": 10.0, "gamma": 0.5},
    "SymmetricClipBceLoss": {"eps": 1e-3},
    "OriginSymmetricClipBceLoss": {"a": 0.7, "b": 0.4, "eps": 1e-3},
    "PriorAdjustedClipBceLoss": {"data_size": 80.0, "tau": 1.5},
    "MaskedClipBceLoss": {},
    "MaskedClipBceLoss_fixed": {"fixed_masking": True},
    "MaskedFrameBceLoss": {},
    "ClipMaskedFrameBceLoss": {"frame_weight": 0.3},
    "ClipFrameBceLoss": {"frame_weight": 0.6},
    "VectorQuantizeLoss": "vq",
    "MaxMarginRankingLoss": {"margin": 0.5},
    "MaxMarginRankingLoss_unfixed": {"margin": 0.5, "fix_norm": False,
                                     "lamda1": 0.8, "sim_key": "sim2"},
    "InfoNceLoss": {"tau": 0.1},
    "MaxTripletLoss": {"margin": 0.3},
    "WeightedTripletLoss": {"margin": 0.5},
    "WeightedTripletLoss_none": {"margin": -5.0},
    "MultipleLossSum": "sum",
}


def _build(pkg, name: str, args):
    cls = getattr(pkg, name.split("_")[0])
    if args == "vq":
        return cls(pkg.ClipBceLoss(), vq_weight=0.25)
    if args == "sum":
        return cls(["vq_loss", "clip", "rank"], [0.5, 1.0, 2.0],
                   clip=pkg.FocalClipBceLoss(),
                   rank=pkg.MaxMarginRankingLoss(margin=0.4))
    return cls(**args)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name):
    args = CASES[name]
    out = _outputs(len(name))
    ref = float(_build(jlosses, name, args)(
        {k: jnp.asarray(v) for k, v in out.items()}))
    got = float(_build(losses, name, args)(
        {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}))
    assert np.isfinite(ref)
    assert got == pytest.approx(ref, rel=1e-6, abs=1e-7)


def test_random_triplet_loss_matches_jax_on_the_same_draws():
    out = _outputs(3)
    key = jax.random.PRNGKey(5)
    n = out["sim"].shape[0]
    k1, k2 = jax.random.split(key)
    s_idx = np.array(jax.random.randint(k1, (n,), 0, n))
    a_idx = np.array(jax.random.randint(k2, (n,), 0, n))
    ref = float(jlosses.RandomTripletLoss(margin=0.4)(
        {"sim": jnp.asarray(out["sim"])}, rng=key))
    loss = losses.RandomTripletLoss(margin=0.4)
    sim = torch.from_numpy(out["sim"])
    got = float(loss.at(sim, torch.from_numpy(s_idx),
                        torch.from_numpy(a_idx)))
    assert got == pytest.approx(ref, rel=1e-6, abs=1e-7)
    # the port's own draws: one explicit generator, the same seed the same
    gens = [torch.Generator().manual_seed(9) for _ in range(2)]
    first, second = (float(loss({"sim": sim}, generator=g)) for g in gens)
    draw = torch.Generator().manual_seed(9)
    s = torch.randint(0, n, (n,), generator=draw)
    a = torch.randint(0, n, (n,), generator=draw)
    assert first == second == pytest.approx(float(loss.at(sim, s, a)))


def test_frame_bce_over_classes_matches_jax():
    out = _outputs(7)
    keys = {"frame_sim": out["frame_sim"], "label": out["strong_label"],
            "length": out["length"]}
    ref = float(jlosses.FrameBceLoss()(
        {k: jnp.asarray(v) for k, v in keys.items()}))
    got = float(losses.FrameBceLoss()(
        {k: torch.from_numpy(v) for k, v in keys.items()}))
    assert got == pytest.approx(ref, rel=1e-6)


def test_every_loss_class_is_registered():
    assert len(losses.__all__) == 19
    for name in losses.__all__:
        assert resolve(name) is getattr(losses, name)
        assert hasattr(jlosses, name)
