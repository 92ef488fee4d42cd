"""Row 10's second design (``csrc/logmel_v4_v2.cu``) emulated on the CPU in
its own schedule, and row 7 (``fused_block1``) at mel counts other than 64.

The card's kernels cannot run here, so this file repeats the new
schedule in PyTorch and holds it to row 1's second-design emulation
(``tests/test_torch_port_block1_logmel_v2.py``), which the kernel must
equal bit for bit, and to the JAX kernel:

* the persistent walk: block k of ``grid`` takes tiles k, k + grid, ...,
  which covers every (clip, 128-frame tile) exactly once;
* the ring, pw and their mbarriers: a simulation of the producer warp,
  the two consumer warpgroups and the epilogue warps under random
  interleavings and copies landing in any order, with the kernel's slot
  count and barrier parities, never reads a stage or a pass that is not
  the one it expects and never deadlocks;
* the stage images: the basis laid out as the ring holds each stage, so
  that one bulk copy brings a stage's B in;
* the deferred epilogue: each pass's power seen alone (the single pw
  buffer), each mel's in-band bins of the pass added into running sums
  in ascending f, equals the full f32 projection bit for bit;
* the output equals row 1's second-design emulation bit for bit and lies
  within 2e-3 dB (row 1's tolerance) of JAX
  ``fused_log_mel_spectrogram_v4(interpret=True)``.

Row 7 at M = 32 and 48 (the JAX kernel answers at any even M, so the port
must): the port's wrapper (its plain
version on the CPU) against JAX ``fused_block1`` in interpret mode, f32
within 1e-4, bf16 within 1e-2 relative RMS, int8 at equal ``tc`` within
2e-3 (``ROADMAP.md`` Queue 3) and < 0.05 of the f32 XLA block; the second
design's blocking at M = 8 and 32 bit for bit against the plain version;
an odd M raises.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pallas_conv_block_small import xla_ref
from tests.test_torch_port_block1_logmel3_v2 import emulate_block1_small
from tests.test_torch_port_block1_logmel_v2 import (
    emulate_logmel,
    full_mel,
    wave_pad,
)
from tests.test_torch_port_kernels import (
    _bf16,
    _block_case,
    _jab,
    _rel_rms,
    _tab,
    _to_np,
)
from texttoaudiogrounding_tpu.ops import frontend as jfront
from texttoaudiogrounding_tpu.ops.pallas import conv_block_small as jbs
from texttoaudiogrounding_tpu.ops.pallas import logmel as jlm
from texttoaudiogrounding_tpu_torch.ops import frontend as tfront
from texttoaudiogrounding_tpu_torch.ops.kernels import block1_small as tb7
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block as tcb
from texttoaudiogrounding_tpu_torch.ops.kernels import logmel as tlm
from texttoaudiogrounding_tpu_torch.ops.kernels import logmel_v4 as tv4

CFG = tfront.cnn8rnn_mel_config(32000)
TILE, NPASS, PBIN = 128, 4, 128
STAGES, KST = 4, 32                  # csrc/logmel_v4_v2.cu


# ---------------------------------------------------- the persistent walk

def persistent_tiles(ntiles: int, grid: int) -> list:
    """The tiles each of ``grid`` persistent blocks walks, in its order
    (``logmel_v4_v2_kernel``): block k takes tiles k, k + grid, k + 2
    grid, ... below ``ntiles``; tile i is clip ``i // tpc``, frames from
    ``(i % tpc) 128``."""
    return [list(range(k, ntiles, grid)) for k in range(grid)]


@pytest.mark.parametrize("clips", [1, 3, 32])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_row10_walk_covers_each_tile_once(clips, sms):
    """At 10 s clips (T = 1001, 8 tiles a clip) every (clip, tile) is
    walked exactly once, each block's tiles in ascending, clip-major
    order, and no block is idle."""
    tpc = -(-1001 // TILE)
    ntiles = clips * tpc
    grid = min(sms, ntiles)
    walks = persistent_tiles(ntiles, grid)
    assert len(walks) == grid and all(walks)
    seen = [divmod(i, tpc) for walk in walks for i in walk]
    assert sorted(seen) == [(c, j) for c in range(clips) for j in range(tpc)]
    assert all(walk == sorted(walk) for walk in walks)
    assert max(map(len, walks)) == -(-ntiles // grid)


# ----------------------------------------- the ring and pw, as a protocol

class _Bar:
    """An mbarrier: a phase completes after ``count`` arrivals; a wait on
    parity P passes once the phase of parity P has completed."""

    def __init__(self, count):
        self.count, self.pending, self.done = count, 0, 0

    def arrive(self):
        self.pending += 1
        if self.pending == self.count:
            self.pending, self.done = 0, self.done + 1

    def passes(self, parity):
        return (self.done & 1) != parity


class _When:
    """A wait on a condition of the simulation."""

    def __init__(self, cond):
        self.cond = cond

    def passes(self, _):
        return self.cond()


def _simulate(ntiles: int, grid: int, seed: int) -> int:
    """One block's roles as coroutines, stepped in a random order: each
    yields the (barrier, parity) it waits on, or None to be rescheduled.
    Returns the steps taken; raises on a wrong read or a deadlock."""
    mine = len(persistent_tiles(ntiles, grid)[0])
    total = mine * NPASS * KST
    full = [_Bar(1) for _ in range(STAGES)]     # the producer warp
    empty = [_Bar(2) for _ in range(STAGES)]    # two consumer warpgroups
    pw_full, pw_empty = _Bar(2), _Bar(1)
    slot = [None] * STAGES
    pw = [None]
    out = []
    flying = []
    rng = random.Random(seed)

    def producer():
        for g in range(total):
            s = g % STAGES
            yield empty[s], ((g // STAGES) & 1) ^ 1
            assert slot[s] is None or slot[s] == ("ready", g - STAGES)
            slot[s] = ("in flight", g)
            flying.append(g)
            yield None

    def copies():
        # each stage's copies land in any order and arrive on its slot's
        # full barrier (cp.async.mbarrier.arrive.noinc, complete_tx)
        for _ in range(total):
            yield _When(lambda: bool(flying)), 0
            g = flying.pop(rng.randrange(len(flying)))
            s = g % STAGES
            assert slot[s] == ("in flight", g)
            slot[s] = ("ready", g)
            full[s].arrive()

    def consumer():
        for g in range(total):
            s, kc = g % STAGES, g % KST
            yield full[s], (g // STAGES) & 1
            assert slot[s] == ("ready", g)
            yield None                          # the wgmma reads the slot
            if kc > 0:
                assert slot[(g - 1) % STAGES] == ("ready", g - 1)
                empty[(g - 1) % STAGES].arrive()
            if kc != KST - 1:
                continue
            q = g // KST
            assert slot[s] == ("ready", g)
            empty[s].arrive()
            yield pw_empty, (q & 1) ^ 1
            assert pw[0] in (None, q - 1, q)
            pw[0] = q
            pw_full.arrive()

    def epilogue():
        for q in range(mine * NPASS):
            yield pw_full, q & 1
            assert pw[0] == q
            yield None                          # the mel sums read pw
            assert pw[0] == q
            pw_empty.arrive()
            if q % NPASS == NPASS - 1:
                out.append(q // NPASS)

    roles = {name: (fn(), None) for name, fn in (
        ("producer", producer), ("copies", copies), ("wg0", consumer),
        ("wg1", consumer), ("epilogue", epilogue))}
    steps = 0
    while roles:
        ready = [k for k, (_, w) in roles.items()
                 if w is None or w[0].passes(w[1])]
        if not ready:
            raise AssertionError(f"deadlock: {sorted(roles)} wait")
        name = rng.choice(ready)
        try:
            roles[name] = (roles[name][0], next(roles[name][0]))
        except StopIteration:
            del roles[name]
        steps += 1
    assert out == list(range(mine))
    assert all(s is None or s[0] == "ready" for s in slot)
    return steps


@pytest.mark.parametrize("ntiles,grid", [(1, 1), (3, 2), (17, 4)])
def test_row10_ring_and_pw_protocol(ntiles, grid):
    """The kernel's barrier counts and parities over a block's whole walk,
    under random interleavings of its roles and of the copies' landing."""
    for seed in range(3):
        assert _simulate(ntiles, grid, seed) > 0


# -------------------------------------------------- the deferred epilogue

def deferred_mel(pw: torch.Tensor, p: int, sums: torch.Tensor, band,
                 weights) -> torch.Tensor:
    """The epilogue warps on pass p: ``pw [frames, 128]`` holds only
    the pass's bins; each mel's in-band bins of the pass are added into
    ``sums [frames, 64]`` in ascending f, ``m + p w`` in f32."""
    sums = sums.clone()
    w = torch.from_numpy(weights)
    lo_p = p * PBIN
    for m, (lo, hi, off) in enumerate(band.tolist()):
        for f in range(max(lo, lo_p), min(hi, lo_p + PBIN)):
            sums[:, m] = sums[:, m] + pw[:, f - lo_p] * w[off + f - lo]
    return sums


def test_row10_deferred_mel_sums_equal_full_projection_bit_for_bit():
    fb = tlm._trimmed_basis(CFG)[2]
    band, weights = tlm.mel_bands(fb)
    assert weights.size <= tv4.MAX_WEIGHTS
    rng = np.random.default_rng(1)
    power = torch.from_numpy(
        (rng.standard_exponential((16, fb.shape[0])) * 10.0 ** rng.uniform(
            -6, 2, (16, 1))).astype(np.float32))
    sums = torch.zeros(16, fb.shape[1])
    for p in range(NPASS):
        sums = deferred_mel(power[:, p * PBIN:(p + 1) * PBIN].clone(), p,
                            sums, band, weights)
    assert torch.equal(sums, full_mel(power, fb))


def test_row10_stage_images_hold_each_stage_as_the_ring_does():
    """Stage (pass p, K chunk kc) of the image is the 16 KB the ring's
    slot holds: the 16-byte piece (row r, chunk c) of basis rows 256 p +
    r, values 32 kc + 8 c .. + 8, at byte r 64 + (c ^ ((r >> 1) & 3)) 16
    (``conv_igemm_sm90.cuh piece_offset``)."""
    real, imag, _ = tlm._trimmed_basis(CFG)
    basis = tlm.interleaved_basis(real, imag)
    images = tv4.stage_images(basis)
    assert images.shape == (NPASS * KST, 256, 32)
    for p, kc in ((0, 0), (1, 7), (3, 31)):
        flat = images[p * KST + kc].reshape(-1)
        for r in range(256):
            for c in range(4):
                at = (r * 64 + ((c ^ ((r >> 1) & 3)) << 4)) // 2
                np.testing.assert_array_equal(
                    flat[at:at + 8],
                    basis[256 * p + r, 32 * kc + 8 * c:32 * kc + 8 * c + 8])


def emulate_logmel_v4(wave: torch.Tensor, sms: int) -> torch.Tensor:
    """The second design's log-mel on ``wave [B, N]`` f32: the persistent
    walk over ``min(sms, tiles)`` blocks, each tile's four passes of
    products and power, each pass's power handed alone to the deferred
    mel sums, the dB after the fourth."""
    b, n = wave.shape
    t = tfront.num_frames(n, CFG.hop_length)
    tpc = -(-t // TILE)
    xpad = wave_pad(wave, tlm.npad_v2(t, CFG)).float()
    real, imag, fb = tlm._trimmed_basis(CFG)
    basis = torch.from_numpy(tlm.interleaved_basis(real, imag)).to(
        torch.bfloat16).float()
    band, weights = tlm.mel_bands(fb)
    out = torch.full((b, t, 64), float("nan"))
    for walk in persistent_tiles(b * tpc, min(sms, b * tpc)):
        for tile in walk:
            clip, f0 = tile // tpc, tile % tpc * TILE
            frames = xpad[clip].unfold(0, 1024, 320)[f0:f0 + TILE]
            sums = torch.zeros(TILE, 64)
            for p in range(NPASS):
                acc = frames @ basis[256 * p:256 * p + 256].T
                re, im = acc[:, 0::2], acc[:, 1::2]
                sums = deferred_mel(re * re + im * im, p, sums, band,
                                    weights)
            db = tlm._DB * torch.log(torch.clamp(sums, min=1e-10))
            out[clip, f0:f0 + TILE] = db[:min(TILE, t - f0)]
    assert not out.isnan().any()
    return out


@pytest.mark.parametrize("n", [8000, 12345])
def test_row10_emulation_equals_row1_and_pallas(n):
    wave = (np.random.default_rng(n).normal(size=(3, n)) * 0.1).astype(
        np.float32)
    x = torch.from_numpy(wave)
    row1 = emulate_logmel(x)
    for sms in (1, 2):
        assert torch.equal(emulate_logmel_v4(x, sms), row1)
    ref = np.asarray(jlm.fused_log_mel_spectrogram_v4(
        jnp.asarray(wave), jfront.cnn8rnn_mel_config(32000), interpret=True))
    assert ref.shape == tuple(row1.shape) == (3, n // 320 + 1, 64)
    assert np.max(np.abs(row1.numpy() - ref)) <= 2e-3
    assert torch.equal(tv4.fused_log_mel_spectrogram_v4(x, CFG),
                       tlm.log_mel_plain(x, CFG))


def test_row10_first_design_takes_cuda_tensors_only():
    with pytest.raises(ValueError):
        tv4._fused_log_mel_spectrogram_v4_v1(torch.zeros(1, 4000), CFG)
    assert tv4.launches_v1 == 0 and tv4.launches == 0


# ------------------------------------------- row 7 at other mel counts

INT8_TOL, BF16_TOL, F32_TOL = 2e-3, 1e-2, 1e-4
MODES = {"f32": (False, jnp.float32, torch.float32),
         "bf16": (False, jnp.bfloat16, torch.bfloat16),
         "int8": (True, jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("m", [32, 48])
def test_row7_matches_pallas_at_other_mel_counts(m, mode):
    """M = 32 takes the second design on the card, M = 48 the first."""
    quantize, jdt, tdt = MODES[mode]
    t = 37                                  # 3 chunks of tc = 16, odd T
    x, w1, ab1, w2, ab2 = _block_case(t, m, 1, 64, seed=t + m)
    if mode == "f32":
        jx, tx = jnp.asarray(x[..., 0]), torch.from_numpy(x[..., 0])
    else:
        jx, tx = _bf16(x[..., 0])
    ref = jbs.fused_block1(jx, jnp.asarray(w1), _jab(ab1), jnp.asarray(w2),
                           _jab(ab2), quantize=quantize, tc=16,
                           compute_dtype=jdt, interpret=True)
    got = tb7.fused_block1(tx, torch.from_numpy(w1), _tab(ab1),
                           torch.from_numpy(w2), _tab(ab2),
                           quantize=quantize, tc=16, compute_dtype=tdt)
    assert got.shape == ref.shape == (2, t // 2, m // 2, 64)
    got, ref = _to_np(got), _to_np(ref)
    if mode == "f32":
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
        return
    assert _rel_rms(got, ref) <= (INT8_TOL if quantize else BF16_TOL)
    if quantize:
        f32 = xla_ref(jnp.asarray(jx, jnp.float32)[..., None],
                      jnp.asarray(w1), _jab(ab1), jnp.asarray(w2),
                      _jab(ab2))
        assert _rel_rms(got, np.asarray(f32)) < 0.05
    assert tcb.v2_takes(m, (2, 2)) is (m == 32)


@pytest.mark.parametrize("m", [8, 32])
def test_row7_second_design_blocking_at_m_equals_plain(m):
    """The second design's conv1 blocks (threads past the last mel only
    stage) and its GEMM at M = 8 and 32, int8 bit for bit."""
    x, w1, ab1, w2, ab2 = _block_case(21, m, 1, 64, seed=m)
    tx = torch.from_numpy(x[..., 0]).to(torch.bfloat16)
    args = (tx, torch.from_numpy(w1), _tab(ab1), torch.from_numpy(w2),
            _tab(ab2))
    got = emulate_block1_small(*args, quantize=True, tc=8)
    ref = tb7.block1_small_plain(*args, quantize=True, tc=8)
    assert got.shape == (2, 10, m // 2, 64) and torch.equal(got, ref)


@pytest.mark.parametrize("m", [63, 1])
def test_row7_odd_mel_count_raises(m):
    x, w1, ab1, w2, ab2 = _block_case(8, 2, 1, 64)
    with pytest.raises(ValueError, match="M even"):
        tb7.fused_block1(torch.zeros(1, 8, m), torch.from_numpy(w1),
                         _tab(ab1), torch.from_numpy(w2), _tab(ab2))
