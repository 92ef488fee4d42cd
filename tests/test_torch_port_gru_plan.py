"""Row 13's first design at any width and batch: ``gru.per_step_plan``
pads H up to a multiple of 4 with zero units and splits the batch rows
into launches whose carries fit in shared memory;
``gru.run_per_step_plan`` runs a call by that plan.  On the CPU each
launch is the plain version, so the plan's call must equal the plain
version on the unpadded, unsplit call: forward, backward (dproj, dWh,
dbn) and the hoisted walks, each output within 1e-6 relative RMS (the
padded units add exact zeros; only the order of the f32 sums of dWh and
dbn over the groups moves).
"""

import numpy as np
import pytest
import torch

from texttoaudiogrounding_tpu_torch.ops.kernels import gru

# (B, H): padded (302 → 304), split (300 at 200 rows: the carries of 200
# rows overflow shared memory), both (302 at 170 rows: the backward
# splits, the forward does not)
SHAPES = [(3, 302), (200, 300), (170, 302)]


def _inputs(b: int, h: int, seed: int = 0) -> tuple:
    rng = np.random.default_rng(seed)
    proj = torch.from_numpy(rng.normal(size=(3, 2 * b, 3 * h)).astype(
        np.float32))
    wh = torch.from_numpy(rng.normal(0, 1 / np.sqrt(h), (2, h, 3 * h))
                          .astype(np.float32))
    bn = torch.from_numpy(rng.normal(0, 0.1, (2, h)).astype(np.float32))
    return proj, wh, bn


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def _planned(b: int, h: int, part: str, launch, rows: tuple, wh, bn,
             row_outputs: int) -> tuple:
    return gru.run_per_step_plan(gru.per_step_plan(b, h, part), launch, rows,
                                 (wh, bn), h, row_outputs)


@pytest.mark.parametrize("b,h", SHAPES)
def test_plan_pads_and_splits_within_shared_memory(b, h):
    for part in ("forward", "backward", "walk"):
        plan = gru.per_step_plan(b, h, part)
        assert plan["h"] == -(-h // 4) * 4
        groups = plan["groups"]
        assert groups[0][0] == 0 and groups[-1][1] == b
        assert all(lo < hi and hi == nxt for (lo, hi), (nxt, _) in
                   zip(groups, groups[1:] + [(b, None)]))
        smem = gru._per_step_smem(part, False)
        assert all(smem(hi - lo, plan["h"]) <= gru._SMEM_MAX
                   for lo, hi in groups)
        # as few groups as fit: one fewer would not
        if len(groups) > 1:
            assert smem(-(-b // (len(groups) - 1)), plan["h"]) > \
                gru._SMEM_MAX


def test_split_shapes_need_their_splits():
    assert len(gru.per_step_plan(200, 300, "forward")["groups"]) == 2
    assert len(gru.per_step_plan(170, 302, "forward")["groups"]) == 1
    assert len(gru.per_step_plan(170, 302, "backward")["groups"]) == 2
    with pytest.raises(ValueError, match="one row"):
        gru.per_step_plan(1, 6000, "backward")


@pytest.mark.parametrize("b,h", SHAPES)
def test_planned_forward_is_the_plain_forward(b, h):
    proj, wh, bn = _inputs(b, h)
    got, = _planned(b, h, "forward", lambda *a: (gru.gru_forward_plain(*a),),
                    (proj,), wh, bn, 1)
    assert got.shape == (3, 2 * b, h)
    assert _rel(got, gru.gru_forward_plain(proj, wh, bn)) <= 1e-6


@pytest.mark.parametrize("b,h", SHAPES)
def test_planned_backward_is_the_plain_backward(b, h):
    proj, wh, bn = _inputs(b, h, 1)
    ys = gru.gru_forward_plain(proj, wh, bn)
    gy = torch.from_numpy(np.random.default_rng(2).normal(
        size=ys.shape).astype(np.float32))
    got = _planned(b, h, "backward",
                   lambda *a: gru.gru_backward_plain(*a), (proj, ys, gy),
                   wh, bn, 1)
    ref = gru.gru_backward_plain(proj, ys, gy, wh, bn)
    for name, g, r in zip(("dproj", "dwh", "dbn"), got, ref):
        assert g.shape == r.shape, name
        assert _rel(g, r) <= 1e-6, name


@pytest.mark.parametrize("variant", gru.VARIANTS)
@pytest.mark.parametrize("b,h", SHAPES)
def test_planned_walk_is_the_plain_walk(b, h, variant):
    proj, wh, bn = _inputs(b, h, 3)
    ys = gru.gru_forward_plain(proj, wh, bn)
    gy = torch.from_numpy(np.random.default_rng(4).normal(
        size=ys.shape).astype(np.float32))
    third = variant == "v3"
    got = _planned(b, h, "walk",
                   lambda *a: gru.gru_walk_plain(*a, third), (proj, ys, gy),
                   wh, bn, 2)
    ref = gru.gru_walk_plain(proj, ys, gy, wh, bn, third)
    for name, g, r in zip(("dproj", "drznn"), got, ref):
        assert g.shape == r.shape, name
        assert _rel(g, r) <= 1e-6, name
