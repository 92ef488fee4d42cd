"""Bidirectional GRU recurrence, forward and backward: ``csrc/gru.cu``,
``csrc/gru_fwd_sm90.cu``, ``csrc/gru_bwd_sm90.cu`` and
``csrc/gru_walk_sm90.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/gru.py``: ``:62
bigru_pallas`` (the forward, with an f32 or a bf16 carry), ``:199
_bigru_bwd`` (its reversed-walk backward, with f32 or bf16 product
operands), ``:412`` / ``:474`` the hoisted backwards of ``:566
bigru_pallas_trainable_v3`` and ``:540 bigru_pallas_trainable_v2`` (the
walk without dWh / dbn, which one matrix product and a sum take after
it), and ``:608 bigru_pallas_trainable`` / ``:283
bigru_pallas_trainable_bf16`` (forward and backward joined as a custom
VJP, here :class:`BiGRUFunction` with ``dtype`` f32 or bf16 and, in f32,
the backward ``variant``).

Contract: time-major ``proj [T, 2B, 3H]`` f32 (the hoisted input
projections plus biases; direction-0 rows, then direction-1 rows already
time-flipped), ``wh [2, H, 3H]``, ``bn [2, H]`` → ``ys [T, 2B, H]`` f32.

Each wrapper launches the kernel for CUDA tensors and runs the plain
PyTorch version of the same arithmetic for CPU tensors; ``launches``
counts the wrappers' calls by kernel (one call of a C entry point runs
the whole walk).  The forward of ``:62`` runs by default on its second
design, ``csrc/gru_fwd_sm90.cu``: one cluster launch a walk
(:func:`forward_plan`, :func:`gru_forward_cluster_emulated`); the
backward of ``:199`` on ``csrc/gru_bwd_sm90.cu``: one cluster launch a
walk and one launch that sums the batch groups' dWh / dbn
(:func:`cluster_plan`, :func:`gru_backward_cluster_emulated`); the
hoisted walks of ``:412`` / ``:474`` on ``csrc/gru_walk_sm90.cu``: one
cluster launch a walk (:func:`walk_plan`,
:func:`gru_walk_cluster_emulated`).  Their first designs, one CUDA launch
a step in ``csrc/gru.cu``, stay callable as ``gru_forward(...,
design="per_step")``, ``gru_backward(..., design="per_step")`` and
``gru_walk(..., design="per_step")``; they take any H and B through
:func:`per_step_plan` (H padded up to a multiple of 4 with zero units,
the rows split into launches whose carries fit in shared memory).  The
hoisted backward's dWh product after the walk is ``torch.bmm`` in full
f32 on either device.  The models' calls pick the design by shape
(:func:`route`): the cluster designs take H <= 256, the first design
every wider width.
"""

from __future__ import annotations

import ctypes

import torch

from texttoaudiogrounding_tpu_torch.ops.kernels import _build

# calls of the C entry points through gru_forward and gru_backward, by
# operand type (the first designs as ``*_per_step``), and through
# gru_walk, by variant
launches = {"gru_fwd": 0, "gru_fwd_bf16": 0, "gru_fwd_per_step": 0,
            "gru_fwd_bf16_per_step": 0, "gru_bwd": 0, "gru_bwd_bf16": 0,
            "gru_bwd_per_step": 0, "gru_bwd_bf16_per_step": 0,
            "gru_bwd_v2": 0, "gru_bwd_v3": 0, "gru_bwd_v2_per_step": 0,
            "gru_bwd_v3_per_step": 0}
# the hoisted f32 backwards: the dh chain as one K = 3H dot (v2) or as
# three K = H dots added in gate order (v3)
VARIANTS = ("v2", "v3")
# gru_forward's, gru_backward's and gru_walk's designs: one cluster launch
# a walk (csrc/gru_fwd_sm90.cu, csrc/gru_bwd_sm90.cu,
# csrc/gru_walk_sm90.cu), or one launch a step (csrc/gru.cu)
DESIGNS = ("cluster", "per_step")

_SMEM_MAX = 232448    # bytes of shared memory a block can use (H100)
_JT = 4               # hidden units per block (csrc/gru.cu)
# csrc/gru_bwd_sm90.cu: units a CTA owns and batch rows a cluster walks, at
# most; CTAs a cluster; threads a CTA (one per k, and the rows of its Wh
# and h tiles); the gate product's K slice a warp
_UMAX, _RMAX, _CLUSTER_MAX, _THREADS, _KW = 16, 12, 16, 256, 32
# csrc/gru_fwd_sm90.cu and csrc/gru_walk_sm90.cu: the gate product's K
# slices, one a warp, summed in warp order
_FWD_WARPS = 8


def _dims(proj: torch.Tensor) -> tuple:
    t, b2, h3 = proj.shape
    return t, b2 // 2, h3 // 3


def gru_forward_plain(proj: torch.Tensor, wh: torch.Tensor, bn: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The forward recurrence in plain PyTorch.  ``dtype`` is the carry's
    and the recurrent product's operand type; products accumulate in f32,
    gates and outputs are f32 (``gru.py:33-56``)."""
    t, b, h = _dims(proj)
    whd = wh.to(dtype).float()                          # [2, H, 3H]
    bnb = bn.float()[:, None]                           # [2, 1, H]
    hid = torch.zeros(2, b, h, dtype=dtype, device=proj.device)
    ys = []
    for step in range(t):
        pp = proj[step].float().reshape(2, b, 3 * h)
        rzn = torch.bmm(hid.float(), whd)
        r = torch.sigmoid(pp[..., :h] + rzn[..., :h])
        z = torch.sigmoid(pp[..., h:2 * h] + rzn[..., h:2 * h])
        n = torch.tanh(pp[..., 2 * h:] + r * (rzn[..., 2 * h:] + bnb))
        out = (1 - z) * n + z * hid.float()
        ys.append(out.reshape(2 * b, h))
        hid = out.to(dtype)
    return torch.stack(ys)


def _gates(pp, rzn, bnb, h: int) -> tuple:
    """The recomputed gates ``(r, z, an, n)`` of one step, ``an`` the
    recurrent n term with its bias, from the recurrent product ``rzn``."""
    r = torch.sigmoid(pp[..., :h] + rzn[..., :h])
    z = torch.sigmoid(pp[..., h:2 * h] + rzn[..., h:2 * h])
    an = rzn[..., 2 * h:] + bnb
    return r, z, an, torch.tanh(pp[..., 2 * h:] + r * an)


def _pre_activation_grads(dhp, h_prev, r, z, an, n) -> tuple:
    """``(da_r, da_z, da_n, drzn_n)`` of one step from ``dL/dh_t``."""
    dn = dhp * (1 - z)
    dz = dhp * (h_prev - n)
    da_n = dn * (1 - n * n)
    da_r = da_n * an * r * (1 - r)
    da_z = dz * z * (1 - z)
    return da_r, da_z, da_n, da_n * r


def gru_backward_plain(proj: torch.Tensor, ys: torch.Tensor,
                       gy: torch.Tensor, wh: torch.Tensor,
                       bn: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> tuple:
    """The reversed walk in plain PyTorch, as ``_bwd_kernel``
    (``gru.py:113-190``): the gates are recomputed from ``ysp`` (the
    outputs shifted by one step), and the walk returns
    ``(dproj [T, 2B, 3H], dwh [2, H, 3H], dbn [2, H])``.  ``dtype`` is the
    products' operand type (``dot_dtype``): with bf16, ``h_{t-1}``, ``Wh``
    and the ``dcol`` rows are rounded to bf16 before each product (the
    rounded ``h_{t-1}`` is the bf16 forward's carry, bit for bit), while
    ``dz``'s ``h_{t-1}``, the gates, ``dbn`` and the sums stay f32."""
    t, b, h = _dims(proj)

    def op(v):
        return v.to(dtype).float()

    ysp = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    wh = op(wh.float())
    bnb = bn.float()[:, None]
    dh = torch.zeros(2, b, h, dtype=torch.float32, device=proj.device)
    dproj = torch.empty_like(proj, dtype=torch.float32)
    dwh = torch.zeros_like(wh)
    dbn = torch.zeros(2, h, dtype=torch.float32, device=proj.device)
    for step in range(t - 1, -1, -1):
        pp = proj[step].float().reshape(2, b, 3 * h)
        h_prev = ysp[step].reshape(2, b, h)
        h_op = op(h_prev)
        r, z, an, n = _gates(pp, torch.bmm(h_op, wh), bnb, h)
        dhp = gy[step].reshape(2, b, h) + dh
        da_r, da_z, da_n, drzn_n = _pre_activation_grads(dhp, h_prev, r, z,
                                                         an, n)
        dproj[step] = torch.cat([da_r, da_z, da_n], -1).reshape(2 * b, 3 * h)
        dcol = op(torch.cat([da_r, da_z, drzn_n], -1))      # [2, B, 3H]
        dh = dhp * z + torch.bmm(dcol, wh.transpose(1, 2))
        dwh += torch.bmm(h_op.transpose(1, 2), dcol)
        dbn += drzn_n.sum(dim=1)
    return dproj, dwh, dbn


def _in_order(parts) -> torch.Tensor:
    """The sum of ``parts``, added one after another in their order."""
    total = parts[0]
    for x in parts[1:]:
        total = total + x
    return total


def _split(b: int, h: int) -> tuple:
    """``(ctas, groups, rows)`` of a cluster design: the fewest CTAs, at
    most 16, that divide H into at most 16 units each, and groups of at
    most 12 rows, as evenly filled as their count allows."""
    ctas = next((c for c in range(-(-h // _UMAX), _CLUSTER_MAX + 1)
                 if h % c == 0), None)
    if ctas is None:
        raise ValueError(f"H = {h} splits into no cluster of at most "
                         f"{_CLUSTER_MAX} CTAs of at most {_UMAX} units")
    groups = -(-b // _RMAX)
    return ctas, groups, -(-b // groups)


def forward_plan(b: int, h: int, dtype: torch.dtype = torch.float32) -> dict:
    """How ``csrc/gru_fwd_sm90.cu`` walks ``B = b`` rows of ``H = h`` units
    a direction: ``ctas`` CTAs a cluster of ``units`` units each,
    ``groups`` clusters a direction of at most 12 ``rows`` each (as
    :func:`cluster_plan`), and the ``smem`` bytes of shared memory a CTA
    takes (its Wh columns, the carry twice, the gate product's warp sums,
    a barrier for each carry).
    Raises ``ValueError`` on a shape the kernel cannot take."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("the carry is float32 or bfloat16")
    if b < 1 or h < 1:
        raise ValueError("the GRU needs B >= 1 and H >= 1")
    ctas, groups, rows = _split(b, h)
    cols = 3 * (h // ctas)
    smem = 4 * (-(-h * cols // 4) * 4 + 2 * h * _RMAX
                + -(-_FWD_WARPS * _RMAX * cols // 2) * 2) + 16
    if smem > _SMEM_MAX:
        raise ValueError(f"the cluster GRU forward needs {smem} bytes of "
                         f"shared memory at H={h}; the card has {_SMEM_MAX}")
    return {"ctas": ctas, "units": h // ctas, "groups": groups,
            "rows": rows, "smem": smem}


def gru_forward_cluster_emulated(proj: torch.Tensor, wh: torch.Tensor,
                                 bn: torch.Tensor,
                                 dtype: torch.dtype = torch.float32, *,
                                 ctas: int, groups: int) -> torch.Tensor:
    """The forward summed in ``csrc/gru_fwd_sm90.cu``'s order, in plain
    PyTorch: the rows walk in ``groups`` batch groups (of ``ceil(B /
    groups)`` rows), the units split over ``ctas`` CTAs (which changes no
    sum), and each step's gate product is the sum, in order, of the
    products over 8 K slices of ``ceil(H / 8)``, one a warp.  Within a
    slice the kernel adds sequential FMAs (f32 carry) or sums on the
    tensor cores (``mma.sync``, bf16 carry), neither of which
    ``torch.bmm`` reproduces: only the slice order is fixed.  ``dtype`` is
    the carry's, rounded as in :func:`gru_forward_plain`."""
    t, b, h = _dims(proj)
    if ctas < 1 or h % ctas or not 1 <= groups <= b:
        raise ValueError("ctas must divide H and 1 <= groups <= B")
    rows, kw = -(-b // groups), -(-h // _FWD_WARPS)
    whd = wh.to(dtype).float()
    bnb = bn.float()[:, None]
    pj = proj.float().reshape(t, 2, b, 3 * h)
    ys = torch.empty(t, 2, b, h, dtype=torch.float32, device=proj.device)
    for b0 in range(0, b, rows):
        sl = slice(b0, min(b, b0 + rows))
        carry = torch.zeros_like(ys[0, :, sl])
        for step in range(t):
            rzn = _in_order([torch.bmm(carry[..., k:k + kw],
                                       whd[:, k:k + kw])
                             for k in range(0, h, kw)])
            pp = pj[step, :, sl]
            r = torch.sigmoid(pp[..., :h] + rzn[..., :h])
            z = torch.sigmoid(pp[..., h:2 * h] + rzn[..., h:2 * h])
            n = torch.tanh(pp[..., 2 * h:] + r * (rzn[..., 2 * h:] + bnb))
            out = (1 - z) * n + z * carry
            ys[step, :, sl] = out
            carry = out.to(dtype).float()
    return ys.reshape(t, 2 * b, h)


def cluster_plan(b: int, h: int, dtype: torch.dtype = torch.float32) -> dict:
    """How ``csrc/gru_bwd_sm90.cu`` walks ``B = b`` rows of ``H = h`` units
    a direction: ``ctas`` CTAs a cluster (the fewest, at most 16, that
    divide H into at most 16 ``units`` each), ``groups`` clusters a
    direction of at most 12 ``rows`` each, and the ``smem`` bytes of shared
    memory a CTA takes (Wh columns, a 3-tile ring of h, dcol, the partial
    dh twice, the gate product's warp sums).  Raises ``ValueError`` on a
    shape the kernel cannot take."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("the operands are float32 or bfloat16")
    if b < 1 or h < 1:
        raise ValueError("the GRU needs B >= 1 and H >= 1")
    if h > _THREADS:
        raise ValueError(f"the cluster GRU backward takes H <= {_THREADS}, "
                         f"not {h}")
    ctas, groups, rows = _split(b, h)
    cols = 3 * _UMAX
    smem = 4 * (_THREADS * cols + 3 * _THREADS * _RMAX + _RMAX * cols
                + 2 * _RMAX * h + _THREADS // 32 * _RMAX * cols)
    if smem > _SMEM_MAX:
        raise ValueError(f"the cluster GRU backward needs {smem} bytes of "
                         f"shared memory at H={h}; the card has {_SMEM_MAX}")
    return {"ctas": ctas, "units": h // ctas, "groups": groups,
            "rows": rows, "smem": smem}


def gru_backward_cluster_emulated(proj: torch.Tensor, ys: torch.Tensor,
                                  gy: torch.Tensor, wh: torch.Tensor,
                                  bn: torch.Tensor,
                                  dtype: torch.dtype = torch.float32, *,
                                  ctas: int, groups: int) -> tuple:
    """The backward summed in ``csrc/gru_bwd_sm90.cu``'s orders, in plain
    PyTorch: the rows split into ``groups`` batch groups (of
    ``ceil(B / groups)`` rows), the units into ``ctas`` CTAs; the gate
    products added by K slices of 32 in order; dh the sum, in CTA order, of
    each CTA's partial ``dcol[:, own] · Wh[:, own]ᵀ`` over its own three
    thirds of columns, plus ``dhp·z``; each group's dWh the rows' outer
    products ``h_{t-1}[b]ᵀ · dcol[b]`` added one row after another, step
    after step; dbn each row's ``drzn_n`` added over the steps, then over
    the rows; the groups added in group order.
    ``dtype`` rounds the products' operands as in
    :func:`gru_backward_plain`.  Returns ``(dproj, dwh, dbn)``."""
    t, b, h = _dims(proj)
    if ctas < 1 or h % ctas or not 1 <= groups <= b:
        raise ValueError("ctas must divide H and 1 <= groups <= B")

    def op(v):
        return v.to(dtype).float()

    units, rows = h // ctas, -(-b // groups)
    own = [torch.cat([torch.arange(third * h + r * units,
                                   third * h + (r + 1) * units)
                      for third in range(3)]) for r in range(ctas)]
    ysp = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]]).float()
    wh = op(wh.float())
    own_w = [wh[:, :, cols].transpose(1, 2) for cols in own]   # [2, 3U, H]
    bnb = bn.float()[:, None]
    dproj = torch.empty(t, 2, b, 3 * h, dtype=torch.float32,
                        device=proj.device)
    pj = proj.float().reshape(t, 2, b, 3 * h)
    hs = ysp.reshape(t, 2, b, h)
    gs = gy.float().reshape(t, 2, b, h)
    dwh_parts, dbn_parts = [], []
    for b0 in range(0, b, rows):
        sl = slice(b0, min(b, b0 + rows))
        dh = torch.zeros_like(hs[0, :, sl])
        dwh = torch.zeros_like(wh)
        dbn_rows = torch.zeros_like(dh)
        for step in range(t - 1, -1, -1):
            pp, h_prev = pj[step, :, sl], hs[step, :, sl]
            h_op = op(h_prev)
            r, z, an, n = _gates(pp, _in_order([
                torch.bmm(h_op[..., k:k + _KW], wh[:, k:k + _KW])
                for k in range(0, h, _KW)]), bnb, h)
            dhp = gs[step, :, sl] + dh
            da_r, da_z, da_n, drzn_n = _pre_activation_grads(
                dhp, h_prev, r, z, an, n)
            dproj[step, :, sl] = torch.cat([da_r, da_z, da_n], -1)
            dcol = op(torch.cat([da_r, da_z, drzn_n], -1))
            dh = dhp * z + _in_order([torch.bmm(dcol[..., cols], w)
                                      for cols, w in zip(own, own_w)])
            for row in range(h_op.shape[1]):
                dwh = dwh + h_op[:, row, :, None] * dcol[:, row, None, :]
            dbn_rows = dbn_rows + drzn_n
        dwh_parts.append(dwh)
        dbn_parts.append(_in_order(dbn_rows.unbind(1)))
    return (dproj.reshape(t, 2 * b, 3 * h), _in_order(dwh_parts),
            _in_order(dbn_parts))


class _full_f32:
    """Matrix products on the card in full f32 (no TF32) inside the
    block, whatever the global switch says; restored after."""

    def __enter__(self):
        self.prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.prev


def hoisted_weight_grads(ys: torch.Tensor, dproj: torch.Tensor,
                         drznn: torch.Tensor) -> tuple:
    """``(dwh [2, H, 3H], dbn [2, H])`` after the hoisted walk, as
    ``_bigru_bwd_v2`` / ``_v3`` take them after theirs (``gru.py:518-525``):
    ``dWh[g] = Σ_{t,b} h_{t-1}[t,g,b]ᵀ · [da_r | da_z | drznn][t,g,b]``, one
    f32 product of ``[H, T·B] × [T·B, 3H]`` per direction (TF32 off), and
    ``dbn = Σ_{t,b} drznn``."""
    t, b2, h = ys.shape
    b = b2 // 2
    ysp = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    hp = ysp.reshape(t, 2, b, h).transpose(0, 1).reshape(2, t * b, h)
    dcols = torch.cat([dproj[..., :2 * h], drznn], -1).reshape(
        t, 2, b, 3 * h).transpose(0, 1).reshape(2, t * b, 3 * h)
    with _full_f32():
        dwh = torch.bmm(hp.transpose(1, 2), dcols)
    return dwh, drznn.reshape(t, 2, b, h).sum(dim=(0, 2))


def gru_walk_plain(proj: torch.Tensor, ys: torch.Tensor, gy: torch.Tensor,
                   wh: torch.Tensor, bn: torch.Tensor,
                   per_third: bool) -> tuple:
    """The walk of the hoisted f32 backward in plain PyTorch, as
    ``_bwd_kernel_v3`` (``per_third``, ``gru.py:359-409``: ``dh = ((dhp·z
    + da_r·Wrᵀ) + da_z·Wzᵀ) + drznn·Wnᵀ``) or ``_bwd_kernel_v2``
    (``:302-356``: ``dh = dhp·z + dcols·Whᵀ``, one K = 3H product): no dWh
    or dbn inside it; returns ``(dproj [T, 2B, 3H], drznn [T, 2B, H])``,
    ``drznn = da_n·r``."""
    t, b, h = _dims(proj)
    ysp = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    wh = wh.float()
    wht = wh.transpose(1, 2)                                # [2, 3H, H]
    bnb = bn.float()[:, None]
    dh = torch.zeros(2, b, h, dtype=torch.float32, device=proj.device)
    dproj = torch.empty_like(proj, dtype=torch.float32)
    drznn = torch.empty(t, 2 * b, h, dtype=torch.float32, device=proj.device)
    for step in range(t - 1, -1, -1):
        pp = proj[step].float().reshape(2, b, 3 * h)
        h_prev = ysp[step].reshape(2, b, h)
        r, z, an, n = _gates(pp, torch.bmm(h_prev, wh), bnb, h)
        dhp = gy[step].reshape(2, b, h) + dh
        da_r, da_z, da_n, drzn_n = _pre_activation_grads(dhp, h_prev, r, z,
                                                         an, n)
        dproj[step] = torch.cat([da_r, da_z, da_n], -1).reshape(2 * b, 3 * h)
        drznn[step] = drzn_n.reshape(2 * b, h)
        dh = dhp * z
        if per_third:
            for third, dcol in enumerate((da_r, da_z, drzn_n)):
                dh = dh + torch.bmm(dcol, wht[:, third * h:(third + 1) * h])
        else:
            dh = dh + torch.bmm(torch.cat([da_r, da_z, drzn_n], -1), wht)
    return dproj, drznn


def walk_plan(b: int, h: int) -> dict:
    """How ``csrc/gru_walk_sm90.cu`` walks ``B = b`` rows of ``H = h`` units
    a direction: ``ctas`` CTAs a cluster of ``units`` units each,
    ``groups`` clusters a direction of at most 12 ``rows`` each (as
    :func:`cluster_plan`), and the ``smem`` bytes of shared memory a CTA
    takes (its Wh columns, three steps of h tiles and item inputs, the dcol
    exchange twice, the two products' warp sums, a barrier for each
    exchange buffer).  Raises
    ``ValueError`` on a shape the kernel cannot take."""
    if b < 1 or h < 1:
        raise ValueError("the GRU needs B >= 1 and H >= 1")
    if h > _THREADS:
        raise ValueError(f"the cluster GRU walk takes H <= {_THREADS}, "
                         f"not {h}")
    ctas, groups, rows = _split(b, h)
    cols = 3 * (h // ctas)
    smem = 4 * (-(-h * cols // 4) * 4 + 3 * h * _RMAX + 3 * 5 * _RMAX * _UMAX
                + 2 * ctas * (3 * _UMAX * _RMAX + 4)
                + -(-_FWD_WARPS * _RMAX * cols // 4) * 4
                + _FWD_WARPS * 3 * _RMAX * _UMAX + 4)
    if smem > _SMEM_MAX:
        raise ValueError(f"the cluster GRU walk needs {smem} bytes of "
                         f"shared memory at H={h}; the card has {_SMEM_MAX}")
    return {"ctas": ctas, "units": h // ctas, "groups": groups,
            "rows": rows, "smem": smem}


def gru_walk_cluster_emulated(proj: torch.Tensor, ys: torch.Tensor,
                              gy: torch.Tensor, wh: torch.Tensor,
                              bn: torch.Tensor, variant: str, *, ctas: int,
                              groups: int) -> tuple:
    """The hoisted walk ``variant`` summed in ``csrc/gru_walk_sm90.cu``'s
    orders, in plain PyTorch: the rows walk in ``groups`` batch groups (of
    ``ceil(B / groups)`` rows), the units split over ``ctas`` CTAs; the
    gate recompute sums 8 K slices of ``ceil(H / 8)`` in order; the dh
    chain sums products over half slices of each CTA's dcol (``S_q,hh,th``:
    units ``8 hh .. 8 hh + 7`` of CTA q in third th), one pair of CTAs
    (2w, 2w + 1) a warp, ``P_w = (S_2w,0 + S_2w,1) + (S_2w+1,0 +
    S_2w+1,1)``, the warps in order:

    * v2, one K = 3H accumulation: ``dh = dhp·z + Σ_w P_w``, each ``S_q,hh``
      the r, z and n thirds in one sum;
    * v3, three K = H sums added in gate order: ``dh = ((dhp·z + Σ_w
      P_w,r) + Σ_w P_w,z) + Σ_w P_w,n``.

    Within a slice the kernel adds sequential FMAs, which ``torch.bmm``
    does not reproduce: only the slices' order is fixed.  Returns
    ``(dproj [T, 2B, 3H], drznn [T, 2B, H])``."""
    t, b, h = _dims(proj)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    if (not 1 <= ctas <= _CLUSTER_MAX or h % ctas or h // ctas > _UMAX
            or not 1 <= groups <= b):
        raise ValueError("ctas (at most 16) must divide H into at most 16 "
                         "units each, and 1 <= groups <= B")
    units, rows, kw = h // ctas, -(-b // groups), -(-h // _FWD_WARPS)
    wh = wh.float()
    wht = wh.transpose(1, 2)                                # [2, 3H, H]
    bnb = bn.float()[:, None]
    pj = proj.float().reshape(t, 2, b, 3 * h)
    hs = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]]).float().reshape(
        t, 2, b, h)
    gs = gy.float().reshape(t, 2, b, h)
    dproj = torch.empty(t, 2, b, 3 * h, dtype=torch.float32,
                        device=proj.device)
    drznn = torch.empty(t, 2, b, h, dtype=torch.float32, device=proj.device)

    def warp_sum(dcol, w, thirds):
        """``P_w`` over ``thirds``, each half slice's thirds in one sum."""
        def part(q, hh):
            lo, hi = q * units + 8 * hh, q * units + min(8 * hh + 8, units)
            cols = torch.cat([torch.arange(th * h + lo,
                                           th * h + max(lo, hi))
                              for th in thirds])
            return torch.bmm(dcol[..., cols], wht[:, cols])
        return _in_order([_in_order([part(q, 0), part(q, 1)])
                          for q in (2 * w, 2 * w + 1) if q < ctas])

    warps = range(-(-ctas // 2))
    for b0 in range(0, b, rows):
        sl = slice(b0, min(b, b0 + rows))
        dh = torch.zeros_like(hs[0, :, sl])
        for step in range(t - 1, -1, -1):
            h_prev = hs[step, :, sl]
            r, z, an, n = _gates(pj[step, :, sl], _in_order([
                torch.bmm(h_prev[..., k:k + kw], wh[:, k:k + kw])
                for k in range(0, h, kw)]), bnb, h)
            dhp = gs[step, :, sl] + dh
            da_r, da_z, da_n, drzn_n = _pre_activation_grads(
                dhp, h_prev, r, z, an, n)
            dproj[step, :, sl] = torch.cat([da_r, da_z, da_n], -1)
            drznn[step, :, sl] = drzn_n
            dcol = torch.cat([da_r, da_z, drzn_n], -1)
            if variant == "v3":
                dh = _in_order([dhp * z] + [
                    _in_order([warp_sum(dcol, w, [th]) for w in warps])
                    for th in range(3)])
            else:
                dh = dhp * z + _in_order([warp_sum(dcol, w, range(3))
                                          for w in warps])
    return dproj.reshape(t, 2 * b, 3 * h), drznn.reshape(t, 2 * b, h)


def gru_backward_hoisted_plain(proj: torch.Tensor, ys: torch.Tensor,
                               gy: torch.Tensor, wh: torch.Tensor,
                               bn: torch.Tensor, per_third: bool) -> tuple:
    """The hoisted f32 backward (v3 with ``per_third``, else v2) in plain
    PyTorch: :func:`gru_walk_plain`, then :func:`hoisted_weight_grads`.
    Returns ``(dproj, dwh, dbn)``."""
    dproj, drznn = gru_walk_plain(proj, ys, gy, wh, bn, per_third)
    return (dproj,) + hoisted_weight_grads(ys, dproj, drznn)


def _check(proj: torch.Tensor, wh: torch.Tensor, bn: torch.Tensor) -> None:
    if proj.dim() != 3 or proj.shape[1] % 2 or proj.shape[2] % 3:
        raise ValueError("proj must be [T, 2B, 3H]")
    t, b, h = _dims(proj)
    if tuple(wh.shape) != (2, h, 3 * h) or tuple(bn.shape) != (2, h):
        raise ValueError("wh must be [2, H, 3H] and bn [2, H]")


def _kernel_ready(*tensors: torch.Tensor) -> list:
    """f32, contiguous views of CUDA tensors on one device."""
    dev = tensors[0].device
    if any(x.device != dev for x in tensors):
        raise ValueError("the GRU kernel's inputs must lie on one device")
    return [x.float().contiguous() for x in tensors]


def _hs_floats(b: int, h: int) -> int:
    return -(-b * (h + 1) // 4) * 4


def _per_step_smem(part: str, b16: bool):
    """Bytes of shared memory ``csrc/gru.cu``'s ``part`` (``"forward"``,
    ``"backward"`` or ``"walk"``) takes at (B, H) (its ``*_smem``)."""
    def smem(b: int, h: int) -> int:
        floats = _hs_floats(b, h) + h * 3 * _JT
        if part != "forward":
            floats += _JT * (3 * h + 1)
        if part == "backward":
            floats += b * (4 if b16 else 3) * _JT
        return 4 * floats
    return smem


def per_step_plan(b: int, h: int, part: str,
                  dtype: torch.dtype = torch.float32) -> dict:
    """The first design's call plan at ``B = b``, ``H = h``: ``{"h": H
    padded up to a multiple of 4, "groups": [(first row, end), ...]}``, the
    batch rows split into as few even groups as keep each launch's carries
    within the card's shared memory.  Zero units are exact: with a zero
    carry a padded unit's ``n`` is ``tanh(0) = 0``, so its carry stays 0,
    and its zero rows of ``wh`` add nothing to the real units; the rows of
    a GRU are independent.  Raises where one row does not fit."""
    if part not in ("forward", "backward", "walk"):
        raise ValueError(f"part must be forward, backward or walk: {part}")
    hp = -(-h // _JT) * _JT
    smem = _per_step_smem(part, dtype == torch.bfloat16)
    if smem(1, hp) > _SMEM_MAX:
        raise ValueError(f"the GRU kernel needs {smem(1, hp)} bytes of "
                         f"shared memory for one row at H={h}; the card has "
                         f"{_SMEM_MAX}")
    rows = b
    while smem(rows, hp) > _SMEM_MAX:
        rows -= 1
    groups = -(-b // rows)
    rows = -(-b // groups)
    return {"h": hp, "groups": [(lo, min(b, lo + rows))
                                for lo in range(0, b, rows)]}


def _pad_last(x: torch.Tensor, h: int, hp: int) -> torch.Tensor:
    """``x [..., k·h]`` (k gates of h units) → ``[..., k·hp]``, each
    gate's units padded with zeros."""
    if hp == h:
        return x
    parts = x.unflatten(-1, (x.shape[-1] // h, h))
    return torch.nn.functional.pad(parts, (0, hp - h)).flatten(-2)


def _cut_last(x: torch.Tensor, h: int, hp: int) -> torch.Tensor:
    """The inverse of :func:`_pad_last`."""
    if hp == h:
        return x
    return x.unflatten(-1, (x.shape[-1] // hp, hp))[..., :h].flatten(-2)


def run_per_step_plan(plan: dict, launch, rows: tuple, weights: tuple,
                      h: int, row_outputs: int) -> tuple:
    """``launch`` over :func:`per_step_plan`'s ``plan``: for each group,
    its direction-0 and direction-1 rows of the time-major ``rows`` (``[T,
    2B, k·H]``: proj, ys, gy) and the ``weights`` (``wh [2, H, 3H]``, ``bn
    [2, H]``), all padded to the plan's H, go to ``launch``, which returns
    a tuple of outputs.  Its first ``row_outputs`` outputs are the group's
    rows (put back in place), the others weight gradients (summed over the
    groups in order); every output is cut back to H."""
    hp, b = plan["h"], rows[0].shape[1] // 2
    wh, bn = weights
    pw = torch.nn.functional.pad(_pad_last(wh, h, hp), (0, 0, 0, hp - h))
    pb = _pad_last(bn, h, hp)
    full = [_pad_last(x, h, hp) for x in rows]
    outs: list = []
    for lo, hi in plan["groups"]:
        if (lo, hi) == (0, b):
            got = launch(*full, pw, pb)
        else:
            got = launch(*[torch.cat([x[:, lo:hi], x[:, b + lo:b + hi]], 1)
                           for x in full], pw, pb)
        if not outs:
            outs = [x.new_empty(x.shape[0], 2 * b, x.shape[2])
                    for x in got[:row_outputs]]
            outs += [torch.zeros_like(x) for x in got[row_outputs:]]
        for i, x in enumerate(got):
            if i < row_outputs:
                outs[i][:, lo:hi] = x[:, :hi - lo]
                outs[i][:, b + lo:b + hi] = x[:, hi - lo:]
            else:
                outs[i] += x
    cut = [_cut_last(x, h, hp) for x in outs]
    return tuple(x[:, :h] if x.dim() == 3 and i >= row_outputs else x
                 for i, x in enumerate(cut))


_P, _I = _build.P, _build.I


def gru_forward(proj: torch.Tensor, wh: torch.Tensor, bn: torch.Tensor,
                dtype: torch.dtype = torch.float32,
                design: str = "cluster") -> torch.Tensor:
    """``proj [T, 2B, 3H]`` → ``ys [T, 2B, H]`` f32, with an f32 or a bf16
    carry (``dtype``).  On the card ``design`` picks the kernel:
    ``"cluster"`` (``csrc/gru_fwd_sm90.cu``, counted as ``gru_fwd`` /
    ``gru_fwd_bf16``) or ``"per_step"`` (``csrc/gru.cu``'s first design,
    counted as ``gru_fwd_per_step`` / ``gru_fwd_bf16_per_step``, by
    :func:`per_step_plan`: H padded, the rows split into launches that
    fit); a shape the cluster design cannot take raises."""
    _check(proj, wh, bn)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("the carry is float32 or bfloat16")
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}")
    if not proj.is_cuda:
        return gru_forward_plain(proj, wh, bn, dtype)
    t, b, h = _dims(proj)
    name = "gru_fwd_bf16" if dtype == torch.bfloat16 else "gru_fwd"
    if design == "cluster":
        plan = forward_plan(b, h, dtype)
        proj, wh, bn = _kernel_ready(proj, wh, bn)
        ys = torch.empty(t, 2 * b, h, dtype=torch.float32,
                         device=proj.device)
        fn = _build.function("gru_fwd_sm90", "ttg_gru_fwd_cluster",
                             [_P] * 4 + [_I] * 7 + [_P])
        err = fn(proj.data_ptr(), wh.data_ptr(), bn.data_ptr(),
                 ys.data_ptr(), t, b, h, plan["ctas"], plan["groups"],
                 plan["rows"], int(dtype == torch.bfloat16),
                 _build.stream(proj))
        launches[name] += 1
        _build.check(err, "ttg_gru_fwd_cluster")
        return ys
    return run_per_step_plan(per_step_plan(b, h, "forward", dtype),
                             lambda *a: (_fwd_per_step(*a, dtype),),
                             (proj,), (wh, bn), h, 1)[0]


def _fwd_per_step(proj: torch.Tensor, wh: torch.Tensor, bn: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """One call of ``csrc/gru.cu``'s forward (a launch a step) at a shape
    it takes."""
    t, b, h = _dims(proj)
    proj, wh, bn = _kernel_ready(proj, wh, bn)
    ys = torch.empty(t, 2 * b, h, dtype=torch.float32, device=proj.device)
    if dtype == torch.float32:
        fn = _build.function("gru", "ttg_gru_fwd_f32",
                             [_P, _P, _P, _P, _I, _I, _I, _P])
        err = fn(proj.data_ptr(), wh.data_ptr(), bn.data_ptr(),
                 ys.data_ptr(), t, b, h, _build.stream(proj))
    else:
        whr = wh.to(torch.bfloat16).float()           # the bf16 operands
        hbuf = torch.empty(2, 2 * b, h, dtype=torch.bfloat16,
                           device=proj.device)
        fn = _build.function("gru", "ttg_gru_fwd_bf16",
                             [_P, _P, _P, _P, _P, _I, _I, _I, _P])
        err = fn(proj.data_ptr(), whr.data_ptr(), bn.data_ptr(),
                 ys.data_ptr(), hbuf.data_ptr(), t, b, h, _build.stream(proj))
    name = "gru_fwd_bf16" if dtype == torch.bfloat16 else "gru_fwd"
    launches[f"{name}_per_step"] += 1
    _build.check(err, f"ttg_{name}")
    return ys


def gru_backward(proj: torch.Tensor, ys: torch.Tensor, gy: torch.Tensor,
                 wh: torch.Tensor, bn: torch.Tensor,
                 dtype: torch.dtype = torch.float32,
                 design: str = "cluster") -> tuple:
    """Gradients ``(dproj, dwh, dbn)`` of the recurrence, given its inputs,
    its outputs ``ys`` and their gradient ``gy``, with f32 or bf16 product
    operands (``dtype``).  On the card ``design`` picks the kernel:
    ``"cluster"`` (``csrc/gru_bwd_sm90.cu``, counted as ``gru_bwd`` /
    ``gru_bwd_bf16``) or ``"per_step"`` (``csrc/gru.cu``'s first design,
    counted as ``gru_bwd_per_step`` / ``gru_bwd_bf16_per_step``, by
    :func:`per_step_plan`); a shape the cluster design cannot take
    raises."""
    _check(proj, wh, bn)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("the operands are float32 or bfloat16")
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}")
    if not proj.is_cuda:
        return gru_backward_plain(proj, ys, gy, wh, bn, dtype)
    t, b, h = _dims(proj)
    b16 = dtype == torch.bfloat16
    if design == "per_step":
        return run_per_step_plan(
            per_step_plan(b, h, "backward", dtype),
            lambda *a: _bwd_per_step(*a, dtype), (proj, ys, gy), (wh, bn),
            h, 1)
    plan = cluster_plan(b, h, dtype)
    proj, ys, gy, wh, bn = _kernel_ready(proj, ys, gy, wh, bn)
    name = "gru_bwd_bf16" if b16 else "gru_bwd"
    whk = wh.to(dtype).float() if b16 else wh
    dev = proj.device
    dproj = torch.empty_like(proj)
    n = 2 * h * 3 * h + 2 * h
    out = torch.empty(n, dtype=torch.float32, device=dev)
    part = torch.empty(plan["groups"], n, dtype=torch.float32, device=dev)
    fn = _build.function("gru_bwd_sm90", "ttg_gru_bwd_cluster",
                         [_P] * 8 + [_I] * 7 + [_P])
    err = fn(proj.data_ptr(), ys.data_ptr(), gy.data_ptr(), whk.data_ptr(),
             bn.data_ptr(), dproj.data_ptr(), out.data_ptr(),
             part.data_ptr(), t, b, h, plan["ctas"], plan["groups"],
             plan["rows"], int(b16), _build.stream(proj))
    launches[name] += 1
    _build.check(err, "ttg_gru_bwd_cluster")
    return (dproj, out[:n - 2 * h].view(2, h, 3 * h),
            out[n - 2 * h:].view(2, h))


def _bwd_per_step(proj: torch.Tensor, ys: torch.Tensor, gy: torch.Tensor,
                  wh: torch.Tensor, bn: torch.Tensor,
                  dtype: torch.dtype) -> tuple:
    """One call of ``csrc/gru.cu``'s backward (a launch a step) at a shape
    it takes: ``(dproj, dwh, dbn)``."""
    t, b, h = _dims(proj)
    b16 = dtype == torch.bfloat16
    proj, ys, gy, wh, bn = _kernel_ready(proj, ys, gy, wh, bn)
    name = "gru_bwd_bf16" if b16 else "gru_bwd"
    whk = wh.to(dtype).float() if b16 else wh
    dev = proj.device
    dproj = torch.empty_like(proj)
    dwh = torch.zeros_like(wh)
    dbn = torch.zeros_like(bn)
    dcol = torch.empty(2, 2 * b, 3 * h, dtype=torch.float32, device=dev)
    part = torch.empty(2 * b, h, dtype=torch.float32, device=dev)
    fn = _build.function("gru", f"ttg_{name}", [_P] * 10 + [_I] * 3 + [_P])
    err = fn(proj.data_ptr(), ys.data_ptr(), gy.data_ptr(), whk.data_ptr(),
             bn.data_ptr(), dproj.data_ptr(), dwh.data_ptr(), dbn.data_ptr(),
             dcol.data_ptr(), part.data_ptr(), t, b, h, _build.stream(proj))
    launches[f"{name}_per_step"] += 1
    _build.check(err, f"ttg_{name}")
    return dproj, dwh, dbn


def cluster_occupancy(h: int, plan: dict, dtype: torch.dtype,
                      forward: bool = False,
                      variant: str | None = None) -> int:
    """How many clusters of ``plan`` (:func:`cluster_plan`'s, with
    ``forward`` :func:`forward_plan`'s, with a ``variant``
    :func:`walk_plan`'s for that hoisted walk) the current device holds at
    once."""
    count = ctypes.c_int(0)
    b16 = int(dtype == torch.bfloat16)
    if variant is not None:
        fn = _build.query("gru_walk_sm90", "ttg_gru_walk_cluster_occupancy",
                          [_I] * 5 + [_P])
        err = fn(h, plan["ctas"], plan["groups"], plan["rows"],
                 int(variant == "v3"), ctypes.addressof(count))
    elif forward:
        fn = _build.query("gru_fwd_sm90", "ttg_gru_fwd_cluster_occupancy",
                          [_I] * 5 + [_P])
        err = fn(h, plan["ctas"], plan["groups"], plan["rows"], b16,
                 ctypes.addressof(count))
    else:
        fn = _build.query("gru_bwd_sm90", "ttg_gru_bwd_cluster_occupancy",
                          [_I] * 4 + [_P])
        err = fn(h, plan["ctas"], plan["groups"], b16,
                 ctypes.addressof(count))
    _build.check(err, "ttg_gru_cluster_occupancy")
    return count.value


def gru_walk(proj: torch.Tensor, ys: torch.Tensor, gy: torch.Tensor,
             wh: torch.Tensor, bn: torch.Tensor, variant: str,
             design: str = "cluster") -> tuple:
    """The walk of the hoisted f32 backward ``variant`` (``"v2"`` or
    ``"v3"``): ``(dproj [T, 2B, 3H], drznn [T, 2B, H])``.  On the card
    ``design`` picks the kernel: ``"cluster"`` (``csrc/gru_walk_sm90.cu``,
    counted as ``gru_bwd_<variant>``) or ``"per_step"`` (``csrc/gru.cu``'s
    ``ttg_gru_bwd_<variant>``, counted as ``gru_bwd_<variant>_per_step``,
    by :func:`per_step_plan`); a shape the cluster design cannot take
    raises."""
    _check(proj, wh, bn)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}")
    if not proj.is_cuda:
        return gru_walk_plain(proj, ys, gy, wh, bn, variant == "v3")
    t, b, h = _dims(proj)
    if design == "per_step":
        return run_per_step_plan(
            per_step_plan(b, h, "walk"),
            lambda *a: _walk_per_step(*a, variant), (proj, ys, gy), (wh, bn),
            h, 2)
    plan = walk_plan(b, h)
    proj, ys, gy, wh, bn = _kernel_ready(proj, ys, gy, wh, bn)
    dproj = torch.empty_like(proj)
    drznn = torch.empty_like(ys)
    fn = _build.function("gru_walk_sm90", "ttg_gru_walk_cluster",
                         [_P] * 7 + [_I] * 7 + [_P])
    err = fn(proj.data_ptr(), ys.data_ptr(), gy.data_ptr(), wh.data_ptr(),
             bn.data_ptr(), dproj.data_ptr(), drznn.data_ptr(), t, b, h,
             plan["ctas"], plan["groups"], plan["rows"],
             int(variant == "v3"), _build.stream(proj))
    launches[f"gru_bwd_{variant}"] += 1
    _build.check(err, "ttg_gru_walk_cluster")
    return dproj, drznn


def _walk_per_step(proj: torch.Tensor, ys: torch.Tensor, gy: torch.Tensor,
                   wh: torch.Tensor, bn: torch.Tensor, variant: str) -> tuple:
    """One call of ``csrc/gru.cu``'s hoisted walk ``variant`` (a launch a
    step) at a shape it takes: ``(dproj, drznn)``."""
    t, b, h = _dims(proj)
    name = f"gru_bwd_{variant}"
    proj, ys, gy, wh, bn = _kernel_ready(proj, ys, gy, wh, bn)
    dproj = torch.empty_like(proj)
    drznn = torch.empty_like(ys)
    part = torch.empty(2 * b, h, dtype=torch.float32, device=proj.device)
    fn = _build.function("gru", f"ttg_{name}", [_P] * 8 + [_I] * 3 + [_P])
    err = fn(proj.data_ptr(), ys.data_ptr(), gy.data_ptr(), wh.data_ptr(),
             bn.data_ptr(), dproj.data_ptr(), drznn.data_ptr(),
             part.data_ptr(), t, b, h, _build.stream(proj))
    launches[f"{name}_per_step"] += 1
    _build.check(err, f"ttg_{name}")
    return dproj, drznn


def gru_backward_hoisted(proj: torch.Tensor, ys: torch.Tensor,
                         gy: torch.Tensor, wh: torch.Tensor,
                         bn: torch.Tensor, variant: str,
                         design: str = "cluster") -> tuple:
    """Gradients ``(dproj, dwh, dbn)`` by the hoisted f32 backward
    ``variant``: :func:`gru_walk` (of ``design``), then
    :func:`hoisted_weight_grads`."""
    dproj, drznn = gru_walk(proj, ys, gy, wh, bn, variant, design)
    return (dproj,) + hoisted_weight_grads(ys, dproj, drznn)


def _takes(plan, *args) -> bool:
    try:
        plan(*args)
    except ValueError:
        return False
    return True


def route(b: int, h: int, dtype: torch.dtype = torch.float32,
          variant: str | None = None) -> dict:
    """The designs a call at ``B = b``, ``H = h`` takes on the card:
    ``{"forward": ..., "backward": ...}``, each ``"cluster"`` where its
    plan (:func:`forward_plan`; :func:`cluster_plan`, or :func:`walk_plan`
    for a hoisted ``variant``) takes the shape, else ``"per_step"``
    (``csrc/gru.cu``'s first design, which takes every shape through
    :func:`per_step_plan`: word2vec's 300, or 302 padded to 304)."""
    bwd_plan = (cluster_plan if variant is None
                else lambda b_, h_, _: walk_plan(b_, h_))
    return {part: "cluster" if _takes(plan, b, h, dtype) else "per_step"
            for part, plan in (("forward", forward_plan),
                               ("backward", bwd_plan))}


class BiGRUFunction(torch.autograd.Function):
    """The recurrence with the hand-written backward: with ``dtype`` f32,
    ``bigru_pallas_trainable`` (``variant`` None), ``_v2`` or ``_v3``
    (``variant`` "v2" / "v3": the same forward, the hoisted backward);
    with bf16, ``bigru_pallas_trainable_bf16`` (bf16 carry forward,
    bf16-operand backward).  The forward saves ``(proj, ys, wh, bn)`` as
    ``_bigru_fwd`` does, and the backward walks them reversed."""

    @staticmethod
    def forward(ctx, proj, wh, bn, dtype, variant):
        if variant is not None and dtype != torch.float32:
            raise ValueError("the hoisted backward is the f32 recurrence's")
        t, b, h = _dims(proj)
        ctx.dtype, ctx.variant = dtype, variant
        if b == 0:
            # a rank with no rows (a mixup whose pairs span the ranks,
            # kernel_shard.mixup_rows): nothing to launch, zero gradients
            ctx.save_for_backward(proj, wh, bn)
            return proj.new_zeros(t, 0, h, dtype=torch.float32)
        ctx.designs = (route(b, h, dtype, variant) if proj.is_cuda
                       else {"forward": "cluster", "backward": "cluster"})
        ys = gru_forward(proj, wh, bn, dtype, ctx.designs["forward"])
        ctx.save_for_backward(proj, ys, wh, bn)
        return ys

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        if len(saved) == 3:                # no rows
            return tuple(torch.zeros_like(t) for t in saved) + (None, None)
        proj, ys, wh, bn = saved
        design = ctx.designs["backward"]
        if ctx.variant is None:
            dproj, dwh, dbn = gru_backward(proj, ys, gy, wh, bn, ctx.dtype,
                                           design)
        else:
            dproj, dwh, dbn = gru_backward_hoisted(proj, ys, gy, wh, bn,
                                                   ctx.variant, design)
        return dproj, dwh.to(wh.dtype), dbn.to(bn.dtype), None, None


def bigru_trainable(proj: torch.Tensor, wh: torch.Tensor, bn: torch.Tensor,
                    dtype: torch.dtype = torch.float32,
                    variant: str | None = None) -> torch.Tensor:
    """f32 ``proj [T, 2B, 3H]`` → ``ys [T, 2B, H]``, differentiable in all
    three inputs; ``dtype`` is the recurrence's operand type, ``variant``
    the f32 backward's (None, ``"v2"`` or ``"v3"``).  On the card each
    half runs the design :func:`route` gives the shape."""
    return BiGRUFunction.apply(proj, wh, bn, dtype, variant)
