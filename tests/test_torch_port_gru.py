"""The port's BiGRU recurrence against the JAX package's Pallas GRU.

``texttoaudiogrounding_tpu_torch/ops/kernels/gru.py`` holds the plain
PyTorch versions of the forward and backward kernels (``csrc/gru.cu``);
for CPU tensors the wrappers run them.  The same inputs, made with numpy
from a seed, go through the JAX kernels in interpret mode and the port:

* f32 forward and the backward (``dproj``, ``dwh``, ``dbn``) against
  ``bigru_pallas_trainable(..., interpret=True)`` and its ``jax.grad``:
  rtol 2e-4, atol 2e-5 (``tests/test_pallas_gru.py``'s tolerance);
* the bf16-carry forward against ``bigru_pallas(dtype=bf16)``: rtol 1e-5,
  atol 1e-5 (same bf16 roundings, f32 sums in another order);
* the bf16 trainable recurrence (bf16 carry forward, bf16-operand
  backward) against ``bigru_pallas_trainable_bf16(..., interpret=True)``
  and its ``jax.grad``: rtol 1e-5 / atol 1e-5 (the same bf16 roundings;
  measured at most 5e-7 apart on these cases);
* the hoisted backwards (the walk without dWh / dbn, then one product)
  against ``bigru_pallas_trainable_v2`` / ``_v3(..., interpret=True)`` and
  their ``jax.grad``: rtol 2e-4, atol 2e-5, as the f32 backward (measured
  at most 6.0e-7 apart); v1, v2 and v3 against one another: rtol 1e-5,
  atol 1e-6 (f32 sums in three orders; measured at most 9.5e-7 apart);
* the port's ``autograd.Function`` against torch autograd through the
  plain forward: rtol 1e-5, atol 1e-6;
* the ``BiGRU`` module through the kernel path against its grouped loop,
  with each f32 backward.
The kernels themselves run only on a CUDA card; ``chip_smoke.py`` holds
them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texttoaudiogrounding_tpu.ops.pallas.gru import (
    bigru_pallas,
    bigru_pallas_trainable,
    bigru_pallas_trainable_bf16,
    bigru_pallas_trainable_v2,
    bigru_pallas_trainable_v3,
)
from texttoaudiogrounding_tpu_torch.models.layers import BiGRU
from texttoaudiogrounding_tpu_torch.ops.kernels import gru

T, B, H = 10, 3, 8


def _case(seed):
    rng = np.random.default_rng(seed)
    proj = (rng.normal(size=(T, 2 * B, 3 * H)) * 0.5).astype(np.float32)
    wh = (rng.normal(size=(2, H, 3 * H)) * 0.4).astype(np.float32)
    bn = (rng.normal(size=(2, H)) * 0.2).astype(np.float32)
    gy = rng.normal(size=(T, 2 * B, H)).astype(np.float32)
    return proj, wh, bn, gy


def test_forward_and_backward_match_the_jax_kernel():
    proj, wh, bn, gy = _case(5)

    def loss(p, w, c):
        return jnp.sum(bigru_pallas_trainable(p, w, c, interpret=True) * gy)

    ref_ys = bigru_pallas_trainable(jnp.asarray(proj), jnp.asarray(wh),
                                    jnp.asarray(bn), interpret=True)
    ref_grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(proj), jnp.asarray(wh), jnp.asarray(bn))

    tp, tw, tb, tg = (torch.from_numpy(a) for a in (proj, wh, bn, gy))
    ys = gru.gru_forward(tp, tw, tb)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ref_ys),
                               rtol=2e-4, atol=2e-5)
    grads = gru.gru_backward(tp, ys, tg, tw, tb)
    for name, got, ref in zip(("dproj", "dwh", "dbn"), grads, ref_grads):
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_bf16_carry_forward_matches_the_jax_kernel():
    proj, wh, bn, _ = _case(7)
    ref = bigru_pallas(jnp.asarray(proj), jnp.asarray(wh), jnp.asarray(bn),
                       dtype=jnp.bfloat16, interpret=True)
    got = gru.gru_forward(torch.from_numpy(proj), torch.from_numpy(wh),
                          torch.from_numpy(bn), torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    f32 = gru.gru_forward(torch.from_numpy(proj), torch.from_numpy(wh),
                          torch.from_numpy(bn))
    assert float((got - f32).abs().max()) > 1e-4   # the carry is bf16


def test_bf16_trainable_matches_the_jax_kernel():
    proj, wh, bn, gy = _case(11)

    def loss(p, w, c):
        return jnp.sum(bigru_pallas_trainable_bf16(p, w, c, interpret=True)
                       * gy)

    args = [jnp.asarray(a) for a in (proj, wh, bn)]
    ref_ys = bigru_pallas_trainable_bf16(*args, interpret=True)
    ref_grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (proj, wh, bn)]
    ys = gru.bigru_trainable(*leaves, torch.bfloat16)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ref_ys),
                               rtol=1e-5, atol=1e-5)
    (ys * torch.from_numpy(gy)).sum().backward()
    for name, x, ref in zip(("dproj", "dwh", "dbn"), leaves, ref_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # the bf16 operands make a difference the tolerance can see
    f32 = gru.gru_backward(*(torch.from_numpy(a) for a in (proj,)),
                           ys.detach(), torch.from_numpy(gy),
                           *(torch.from_numpy(a) for a in (wh, bn)))
    assert float((f32[1] - leaves[1].grad).abs().max()) > 1e-3


@pytest.mark.parametrize("variant", gru.VARIANTS)
def test_hoisted_backward_matches_the_jax_kernel(variant):
    proj, wh, bn, gy = _case(13)
    fn = {"v2": bigru_pallas_trainable_v2,
          "v3": bigru_pallas_trainable_v3}[variant]

    def loss(p, w, c):
        return jnp.sum(fn(p, w, c, interpret=True) * gy)

    args = [jnp.asarray(a) for a in (proj, wh, bn)]
    ref_grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (proj, wh, bn)]
    ys = gru.bigru_trainable(*leaves, variant=variant)
    np.testing.assert_allclose(ys.detach().numpy(),
                               np.asarray(fn(*args, interpret=True)),
                               rtol=2e-4, atol=2e-5)
    (ys * torch.from_numpy(gy)).sum().backward()
    for name, x, ref in zip(("dproj", "dwh", "dbn"), leaves, ref_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_v1_v2_v3_backwards_agree():
    proj, wh, bn, gy = (torch.from_numpy(a) for a in _case(17))
    ys = gru.gru_forward(proj, wh, bn)
    v1 = gru.gru_backward(proj, ys, gy, wh, bn)
    walks = {}
    for variant in gru.VARIANTS:
        got = gru.gru_backward_hoisted(proj, ys, gy, wh, bn, variant)
        for name, a, b in zip(("dproj", "dwh", "dbn"), got, v1):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=(variant, name))
        walks[variant] = gru.gru_walk(proj, ys, gy, wh, bn, variant)
        # drznn is the n third of dcol, da_n r, not dproj's da_n
        assert not torch.equal(walks[variant][1], walks[variant][0][..., 16:])
    # the two dh chains differ only in their f32 summation order
    np.testing.assert_allclose(walks["v2"][0].numpy(),
                               walks["v3"][0].numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="variant"):
        gru.gru_walk(proj, ys, gy, wh, bn, "v4")


def test_autograd_function_matches_autograd_of_the_plain_forward():
    proj, wh, bn, gy = _case(9)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (proj, wh, bn)]
    (gru.bigru_trainable(*leaves) * torch.from_numpy(gy)).sum().backward()
    got = [x.grad.clone() for x in leaves]
    for x in leaves:
        x.grad = None
    (gru.gru_forward_plain(*leaves) * torch.from_numpy(gy)).sum().backward()
    for name, g, x in zip(("proj", "wh", "bn"), got, leaves):
        np.testing.assert_allclose(g.numpy(), x.grad.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_bigru_initialises_like_the_jax_tree():
    torch.manual_seed(0)
    rnn = BiGRU(512, 64)
    for sfx in ("", "_reverse"):
        wi = getattr(rnn, f"weight_ih_l0{sfx}").detach()
        assert abs(float(wi.std()) * 512 ** 0.5 - 1.0) < 0.05   # lecun
        wh = getattr(rnn, f"weight_hh_l0{sfx}").detach()
        for g in range(3):
            blk = wh[g * 64:(g + 1) * 64]
            np.testing.assert_allclose((blk @ blk.T).numpy(), np.eye(64),
                                       atol=1e-5)           # orthogonal
        for name in ("bias_ih_l0", "bias_hh_l0"):
            assert not getattr(rnn, name + sfx).any()


@pytest.mark.parametrize("dtype,bwd", [(torch.float32, None),
                                       (torch.float32, "v2"),
                                       (torch.float32, "v3"),
                                       (torch.bfloat16, None)])
def test_bigru_kernel_path_matches_the_grouped_loop(dtype, bwd):
    rng = np.random.default_rng(3)
    loop = BiGRU(12, H, dtype=dtype, kernel=False)
    sd = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)
                              * 0.3) for k, v in loop.state_dict().items()}
    loop.load_state_dict(sd)
    assert BiGRU(12, H, dtype=dtype, bwd=bwd).route() == (
        dtype, dtype == torch.float32, dtype, bwd)
    assert BiGRU(12, H, bwd=bwd).route(torch.bfloat16) == (
        torch.bfloat16, False, torch.bfloat16, None)      # serving: loop
    kern = BiGRU(12, H, dtype=dtype, kernel=True, bwd=bwd)
    kern.load_state_dict(sd)
    x = torch.from_numpy(rng.normal(size=(B, T, 12)).astype(np.float32))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = loop(xa), kern(xb)
    np.testing.assert_allclose(yb.detach().numpy(), ya.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    if dtype == torch.bfloat16:
        return
    g = torch.from_numpy(rng.normal(size=ya.shape).astype(np.float32))
    (ya * g).sum().backward()
    (yb * g).sum().backward()
    np.testing.assert_allclose(xb.grad.numpy(), xa.grad.numpy(), rtol=1e-4,
                               atol=1e-5)
    for (name, pa), pb in zip(loop.named_parameters(), kern.parameters()):
        np.testing.assert_allclose(pb.grad.numpy(), pa.grad.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # the r/z recurrent biases are folded in detached: no gradient
    assert not kern.bias_hh_l0.grad[:2 * H].any()
    assert kern.bias_hh_l0.grad[2 * H:].any()
