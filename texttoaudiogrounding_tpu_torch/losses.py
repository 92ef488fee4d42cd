"""Loss functions over the model output dict: ``loss_fn(output) -> scalar``.

Port of ``texttoaudiogrounding_tpu/losses.py`` (reference losses.py:11-440),
all 19 classes: the frame- and clip-level BCEs of strong supervision and
WSTAG, their weighted, focal, symmetric, prior-adjusted and masked
variants, MIL-NCE, the VQ wrapper, the ranking and triplet losses over a
``[B, B]`` similarity matrix and the weighted sum of named losses.
Probability BCE has torch ``F.binary_cross_entropy`` semantics (each log
clamped at -100).  The one loss that draws (``RandomTripletLoss``) takes an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

from texttoaudiogrounding_tpu_torch.ops.masking import generate_length_mask

__all__ = [
    "FrameBceLoss", "ClipBceLoss", "MilNceLoss", "FocalClipBceLoss",
    "ClipBceLossFreqWeight", "SymmetricClipBceLoss",
    "OriginSymmetricClipBceLoss", "PriorAdjustedClipBceLoss",
    "MaskedClipBceLoss", "MaskedFrameBceLoss", "ClipMaskedFrameBceLoss",
    "ClipFrameBceLoss", "VectorQuantizeLoss", "MaxMarginRankingLoss",
    "InfoNceLoss", "MaxTripletLoss", "RandomTripletLoss",
    "WeightedTripletLoss", "MultipleLossSum",
]

_LOG_CLAMP = -100.0


def binary_cross_entropy(prob: torch.Tensor, target: torch.Tensor,
                         weight: torch.Tensor | None = None,
                         reduction: str = "none") -> torch.Tensor:
    """BCE on probabilities, elementwise (``"none"``), ``"mean"`` or
    ``"sum"``, each element scaled by ``weight`` first."""
    log_p = torch.clamp_min(torch.log(prob), _LOG_CLAMP)
    log_1p = torch.clamp_min(torch.log1p(-prob), _LOG_CLAMP)
    loss = -(target * log_p + (1.0 - target) * log_1p)
    if weight is not None:
        loss = loss * weight
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


class FrameBceLoss:
    """Length-masked frame BCE: ``output`` holds ``frame_sim [B, T]`` (or
    ``[B, T, 1]``, or ``[B, T, C]`` against a ``[B, T, C]`` label),
    ``label`` and ``length [B]``."""

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        frame_sim = output["frame_sim"]
        if frame_sim.dim() == 3 and frame_sim.shape[2] == 1:
            frame_sim = frame_sim[..., 0]
        return self.forward_tensor(frame_sim, output["label"],
                                   output["length"])

    @staticmethod
    def forward_tensor(frame_sim, label, length) -> torch.Tensor:
        loss = binary_cross_entropy(frame_sim, label)
        mask = generate_length_mask(length, frame_sim.shape[1]).to(loss.dtype)
        if loss.dim() == 3:
            mask = mask[..., None].expand(loss.shape)
        return torch.sum(loss * mask) / torch.sum(mask)


class ClipBceLoss:
    """Clip-level BCE: the mean over ``clip_sim [B, N]`` against ``label
    [B, N]`` (1 for a caption's phrases, 0 for sampled negatives)."""

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        return self.forward_tensor(output["clip_sim"], output["label"])

    @staticmethod
    def forward_tensor(prob, label) -> torch.Tensor:
        return binary_cross_entropy(prob, label, reduction="mean")


class MilNceLoss:
    """MIL-NCE over ``clip_sim [B, N]``: ``logsumexp(s / τ) -
    logsumexp(s · label / τ)`` a row, averaged."""

    def __init__(self, tau: float = 1.0):
        self.tau = tau

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        clip_sim, label = output["clip_sim"], output["label"]
        nominator = torch.logsumexp(clip_sim * label / self.tau, dim=1)
        denominator = torch.logsumexp(clip_sim / self.tau, dim=1)
        return torch.mean(denominator - nominator)


class FocalClipBceLoss:
    """Focal clip BCE (logs not clamped, as in the JAX package)."""

    def __init__(self, gamma: float = 2, alpha: float = 0.25):
        self.gamma = gamma
        self.alpha = alpha

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        p, y = output["clip_sim"], output["label"]
        loss = (-self.alpha * torch.pow(1 - p, self.gamma) * y * torch.log(p)
                - (1 - self.alpha) * torch.pow(p, self.gamma) * (1.0 - y)
                * torch.log(1 - p))
        return torch.mean(loss)


class ClipBceLossFreqWeight:
    """Clip BCE with each positive weighted by ``(C / (C + counts))^γ``
    (``output["counts"]``)."""

    def __init__(self, C: float, gamma: float):
        self.C = C
        self.gamma = gamma

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        label = output["label"]
        weight = (self.C / (self.C + output["counts"])) ** self.gamma
        weight = torch.where(label == 0.0, torch.ones_like(weight), weight)
        return binary_cross_entropy(output["clip_sim"], label, weight,
                                    reduction="mean")


class SymmetricClipBceLoss:
    """BCE plus the reverse BCE, the labels clamped to ``[eps, 1 - eps]``
    as the reverse's probabilities (``a`` and ``b`` unused, as in the JAX
    package)."""

    def __init__(self, a: float = 1, b: float = 1, eps: float = 1e-3):
        self.a, self.b, self.eps = a, b, eps

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        p, y = output["clip_sim"], output["label"]
        loss = binary_cross_entropy(p, y, reduction="mean")
        return loss + binary_cross_entropy(
            torch.clamp(y, self.eps, 1.0 - self.eps), p, reduction="mean")


class OriginSymmetricClipBceLoss:
    """``a`` · BCE + ``b`` · the reverse term with ``log(eps)`` in place of
    ``log 0``."""

    def __init__(self, a: float = 1, b: float = 1, eps: float = 1e-3):
        self.a, self.b = a, b
        self.A = math.log(eps)

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        p, y = output["clip_sim"], output["label"]
        loss = binary_cross_entropy(p, y, reduction="mean")
        reverse = -torch.mean(y * (1 - p) * self.A + (1 - y) * self.A * p)
        return self.a * loss + self.b * reverse


class PriorAdjustedClipBceLoss:
    """Clip BCE on probabilities adjusted by the class prior
    ``counts / data_size`` raised to ``tau``."""

    def __init__(self, data_size: float, tau: float = 1):
        self.data_size = data_size
        self.tau = tau

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        p, y = output["clip_sim"], output["label"]
        prior = output["counts"] / self.data_size
        one = p * prior ** self.tau
        zero = (1 - p) * (1 - prior) ** self.tau
        return binary_cross_entropy(one / (one + zero), y, reduction="mean")


class MaskedClipBceLoss:
    """Class-masked clip BCE.  As in the JAX package, the default is the
    reference's effective behaviour, the plain unmasked mean (its legacy
    ``reduce="none"`` resolves to a mean); ``fixed_masking`` takes the mean
    over the entries of ``label_mask``."""

    def __init__(self, fixed_masking: bool = False):
        self.fixed_masking = fixed_masking

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        loss = binary_cross_entropy(output["clip_sim"], output["label"])
        if not self.fixed_masking:
            return torch.mean(loss)
        cls_mask = output["label_mask"]
        return torch.sum(loss * cls_mask) / torch.sum(cls_mask)


class MaskedFrameBceLoss:
    """Frame BCE over ``frame_sim [N, T, C]`` against ``strong_label``,
    masked by the lengths and by ``strong_label_mask [N, C]``."""

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        prob = output["frame_sim"]
        loss = binary_cross_entropy(prob, output["strong_label"])
        len_mask = generate_length_mask(output["length"],
                                        prob.shape[1]).to(loss.dtype)
        mask = len_mask[..., None] * output["strong_label_mask"][:, None, :]
        return torch.sum(loss * mask) / torch.sum(mask)


class ClipMaskedFrameBceLoss:
    """``(1 - w)`` · clip BCE on ``weak_label`` + ``w`` · masked frame
    BCE."""

    def __init__(self, frame_weight: float):
        self.frame_weight = frame_weight
        self.frame_loss_fn = MaskedFrameBceLoss()

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        clip = ClipBceLoss.forward_tensor(output["clip_sim"],
                                          output["weak_label"])
        return ((1 - self.frame_weight) * clip
                + self.frame_weight * self.frame_loss_fn(output))


class ClipFrameBceLoss:
    """``(1 - w)`` · clip BCE + ``w`` · length-masked frame BCE, on
    configurable keys (the self-supervision distillation loss)."""

    def __init__(self, frame_weight: float,
                 clip_label_key: str = "weak_label",
                 clip_prob_key: str = "clip_sim",
                 frame_label_key: str = "strong_label",
                 frame_prob_key: str = "frame_sim"):
        self.frame_weight = frame_weight
        self.clip_label_key = clip_label_key
        self.clip_prob_key = clip_prob_key
        self.frame_label_key = frame_label_key
        self.frame_prob_key = frame_prob_key

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        clip = ClipBceLoss.forward_tensor(output[self.clip_prob_key],
                                          output[self.clip_label_key])
        frame = FrameBceLoss.forward_tensor(output[self.frame_prob_key],
                                            output[self.frame_label_key],
                                            output["length"])
        return (1 - self.frame_weight) * clip + self.frame_weight * frame


class VectorQuantizeLoss:
    """``loss_fn``'s loss plus ``vq_weight`` · ``output["vq_loss"]``."""

    def __init__(self, loss_fn, vq_weight: float = 1.0):
        self.loss_fn = loss_fn
        self.vq_weight = vq_weight

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        return self.vq_weight * output["vq_loss"] + self.loss_fn(output, **kw)


class MaxMarginRankingLoss:
    """Bidirectional max-margin ranking over a ``[B, B]`` similarity matrix
    (``fix_norm`` drops the diagonal pairs)."""

    def __init__(self, margin: float = 1, fix_norm: bool = True,
                 lamda1: float = 1, sim_key: str = "sim"):
        self.margin = margin
        self.fix_norm = fix_norm
        self.lamda1 = lamda1
        self.sim_key = sim_key

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        x = output[self.sim_key]
        n = x.shape[0]
        d = torch.diagonal(x)[:, None]
        cost1 = torch.relu(self.margin - (d - x))
        cost2 = torch.relu(self.margin - (d - self.lamda1 * x.T))
        if self.fix_norm:
            keep = 1.0 - torch.eye(n, dtype=x.dtype, device=x.device)
            total = torch.sum(cost1 * keep) + torch.sum(cost2 * keep)
            return total / (2 * n * (n - 1))
        return (torch.sum(cost1) + torch.sum(cost2)) / (2 * n * n)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None]))


class InfoNceLoss:
    """Symmetric InfoNCE over a ``[B, B]`` similarity matrix."""

    def __init__(self, tau: float = 0.07):
        self.tau = tau

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        sim = output["sim"]
        logit = sim.T / self.tau
        labels = torch.arange(sim.shape[0], device=sim.device)
        return (_cross_entropy(logit.T, labels)
                + _cross_entropy(logit, labels)) / 2


def _triplet_costs(sim: torch.Tensor, margin: float) -> tuple:
    n = sim.shape[0]
    d = torch.diagonal(sim)[:, None]
    off = 1.0 - torch.eye(n, dtype=sim.dtype, device=sim.device)
    cost_s = torch.relu(margin + sim - d)        # caption retrieval
    cost_a = torch.relu(margin + sim - d.T)      # audio retrieval
    return cost_s * off, cost_a * off


class MaxTripletLoss:
    """Hardest-negative triplet loss."""

    def __init__(self, margin: float = 1.0):
        self.margin = margin

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        sim = output["sim"]
        cost_s, cost_a = _triplet_costs(sim, self.margin)
        return (torch.sum(cost_s.max(dim=1).values)
                + torch.sum(cost_a.max(dim=0).values)) / sim.shape[0]


class RandomTripletLoss:
    """Random-negative triplet loss: a uniform negative index a row for
    each direction, drawn from ``generator`` (else the loss's own, seeded
    from the torch seed when first used on a device)."""

    def __init__(self, margin: float = 1.0):
        self.margin = margin
        self._generator = None

    def _own_generator(self, device: torch.device) -> torch.Generator:
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device)
            self._generator.manual_seed(torch.initial_seed())
        return self._generator

    def __call__(self, output: dict,
                 generator: torch.Generator | None = None,
                 **kw) -> torch.Tensor:
        sim = output["sim"]
        n = sim.shape[0]
        gen = generator or self._own_generator(sim.device)
        s_idx = torch.randint(0, n, (n,), generator=gen, device=sim.device)
        a_idx = torch.randint(0, n, (n,), generator=gen, device=sim.device)
        return self.at(sim, s_idx, a_idx)

    def at(self, sim: torch.Tensor, s_idx: torch.Tensor,
           a_idx: torch.Tensor) -> torch.Tensor:
        """The loss with the negatives ``s_idx`` / ``a_idx`` ``[B]``."""
        cost_s, cost_a = _triplet_costs(sim, self.margin)
        rows = torch.arange(sim.shape[0], device=sim.device)
        return (torch.sum(cost_s[rows, s_idx])
                + torch.sum(cost_a[rows, a_idx])) / sim.shape[0]


class WeightedTripletLoss:
    """Polynomial-weighted triplet loss: a row's hardest negative among
    those that violate the margin; rows with none add zero, and with none
    anywhere the loss is 0 with a live gradient path."""

    def __init__(self, margin: float = 1.0):
        self.margin = margin

    def _one_direction(self, sim: torch.Tensor) -> tuple:
        n = sim.shape[0]
        pos = torch.diagonal(sim)
        off_diag = ~torch.eye(n, dtype=torch.bool, device=sim.device)
        violate = off_diag & (sim + self.margin > pos[:, None])
        neg = torch.where(violate, sim, torch.full_like(sim, -math.inf))
        neg = neg.max(dim=1).values
        has_neg = violate.any(dim=1)
        neg = torch.where(has_neg, neg, torch.zeros_like(neg))
        pos_loss = torch.relu(0.2 * pos ** 2 - 0.7 * pos + 0.5)
        neg_loss = torch.relu(0.9 * neg ** 2 - 0.4 * neg + 0.03)
        per_row = torch.where(has_neg, pos_loss + neg_loss,
                              torch.zeros_like(pos_loss))
        return torch.sum(per_row), has_neg.any()

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        sim = output["sim"]
        l1, any1 = self._one_direction(sim)
        l2, any2 = self._one_direction(sim.T)
        total = (l1 + l2) / sim.shape[0]
        return torch.where(any1 | any2, total, sim.mean() - sim.mean())


class MultipleLossSum:
    """Weighted sum of named losses; a name already in the output dict
    (``vq_loss``, say) is taken from it."""

    def __init__(self, names: list, weights: list, **loss_fns):
        self.names = names
        self.weights = weights
        self.loss_fns = loss_fns

    def __call__(self, output: dict, **kw) -> torch.Tensor:
        total = 0.0
        for name, weight in zip(self.names, self.weights):
            loss = (output[name] if name in output
                    else self.loss_fns[name](output, **kw))
            total = total + weight * loss
        return total
