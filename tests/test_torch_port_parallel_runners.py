"""Sentence-level WSTAG (word- and phrase-wise), self-supervision and both
class-mapping runners on two ranks, against one rank and against JAX's
jitted step on a mesh.

One world of two gloo ranks (``tests/torch_ranks.py:runners``) runs every
case in turn; the one-rank references run the same function in this
process without a group.  The narrow model is ``torch_ranks.model``'s:
``Cnn8Rnn`` on 0.2 s clips, text width 64, weights made with numpy from
a seed; the sentence models with ``AlignDotProduct`` and
``AudioMeanTextMean``, the class-mapping model ``AudioTagging`` over 5
classes.  Tolerances:

* dp2 against one rank, two train steps of each runner's step as ``fit``
  feeds it (dropout on; SpecAugment and mixup on in the weak
  class-mapping step; the phrase-wise step with ``RandomTripletLoss``,
  whose negatives are drawn for the global batch, and ΣN = 6 then 5
  phrases: divisible by the ranks and not): losses within 2e-4
  relative, the first step's gradients within 1e-5 relative RMS a
  parameter, its running statistics within 1e-5 relative (1e-6
  absolute), and the statistics after bit for bit across the ranks
  (``tests/test_torch_port_parallel.py``'s limits, BatchNorm sums in
  float64 on both sides);
* the evaluation forward of 3 clips, padded to the ranks and gathered
  (``eval_forward``; the phrase batch has ΣN = B = 3): the sentence
  runner's diagonal tracks and the class-mapping outputs within 1e-6
  absolute of one rank's;
* the word-wise step on dp2 against JAX's jitted step on a dp2 mesh of
  the CPU devices, dropout off on both sides, weights made for JAX and
  carried across with ``from_jax_variables``: loss 1e-5 relative,
  gradients 1e-4 relative RMS after the conv trunk and 2e-2 in it
  (``tests/test_torch_port_train.py``'s limits), running statistics 1e-5
  absolute or 1e-6 relative;
* the ragged phrase feed (``parallel/mesh.py:rank_batch``), SpecAugment's
  stripes and the self-supervision teacher's weights after its broadcast
  (each rank drew its own): exact;
* mixup whose pairs span the two ranks, against one rank: a train-mode
  forward of 2 clips (one a rank; one rank then holds the mixed row, the
  other none) within 1e-6 absolute, and the weak class-mapping step at
  B = 6 (three rows a rank) to the dp2 limits above;
* the strong step on dp2 under ``trainer.remat`` against dp2 without it:
  bit for bit.
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from tests import torch_ranks as ranks
from tests.test_torch_port_align import jax_variables
from texttoaudiogrounding_tpu.losses import MaxMarginRankingLoss as JMMR
from texttoaudiogrounding_tpu.parallel import mesh as jmesh
from texttoaudiogrounding_tpu.training.runner_weak_phrase import (
    weak_output_transform as j_weak_transform,
)
from texttoaudiogrounding_tpu.utils import registry as jregistry
from texttoaudiogrounding_tpu_torch import from_jax_variables
from texttoaudiogrounding_tpu_torch.models.align_models import pack_phrases
from texttoaudiogrounding_tpu_torch.parallel.mesh import rank_batch

STEPS = ("sentence_word", "sentence_phrase", "selfsup", "mapping_weak",
         "mapping_strong")
WORD_MODEL = {
    "type": "AudioTextAlignByWord",
    "args": {"shared_dim": ranks.EMBED, "add_proj": True},
    "audio_encoder": {"type": "Cnn8Rnn", "args": {"sample_rate": 32000}},
    "text_encoder": {"type": "EmbeddingAgg",
                     "args": {"vocab_size": ranks.VOCAB,
                              "embed_dim": ranks.EMBED}},
    "match_fn": {"type": "AlignDotProduct", "args": {}},
    "sim_pooling": {"type": "AudioMeanTextMean", "args": {}}}


def _word_batch() -> dict:
    return ranks._word_batches(4, 1, seed=21)[0]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The world of this module, started with its first test (after the
    word-wise model's weights are made for JAX and saved for the ranks),
    in the background while the references compute here."""
    out = tmp_path_factory.mktemp("ranks")
    jmodel = jregistry.instantiate(WORD_MODEL)
    port = ranks._align("word", (0.0, 0.0))
    variables = jax_variables(jmodel, _word_batch(), port, seed=5)
    torch.save(port.state_dict(), out / "word.pt")
    proc = ranks.start(out, [{"name": "runners", "fn": "runners", "world": 2,
                              "args": {"mesh_shape": {"data": 2},
                                       "word_weights": str(out / "word.pt")},
                              "timeout": 120}])
    with ranks.sharing_the_cpu():
        yield proc, out, jmodel, variables
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def dp2(launched) -> list:
    return ranks.results(*launched[:2], "runners", 2)


@pytest.fixture(scope="module")
def one_rank(launched) -> dict:
    return ranks.runners(None)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / max(np.sqrt(np.mean(b ** 2)), 1e-30))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", STEPS)
def test_dp2_runner_step_matches_one_rank(dp2, one_rank, case):
    ref = one_rank[case]
    for rank in dp2:
        got = rank[case]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-4)
        assert set(got["grads"]) == set(ref["grads"])
        for name, g in ref["grads"].items():
            assert _rel(got["grads"][name], g) <= 1e-5, name
        for name, s in ref["first_stats"].items():
            np.testing.assert_allclose(got["first_stats"][name], s,
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    for name in ref["stats"]:
        assert torch.equal(dp2[0][case]["stats"][name],
                           dp2[1][case]["stats"][name]), name


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case,key", [
    ("sentence_word", "tracks"), ("sentence_phrase", "tracks"),
    ("mapping_weak", "eval"), ("mapping_strong", "eval")])
def test_dp2_evaluation_matches_one_rank(dp2, one_rank, case, key):
    ref = one_rank[case][key]
    for rank in dp2:
        got = rank[case][key]
        if key == "tracks":
            assert len(got) == len(ref) == 3
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:
            assert set(got) == set(ref)
            for name, value in ref.items():
                assert got[name].shape == value.shape
                np.testing.assert_allclose(got[name], value, rtol=0,
                                           atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def jax_dp2_word_step(launched):
    """JAX's jitted word-wise step on a dp2 mesh (dropout the identity)
    from the weights the ranks load."""
    jmodel, variables = launched[2:]
    batch = _word_batch()
    mesh = jmesh.get_mesh(jax.devices()[:2])
    rep = jmesh.replicate(mesh)

    def step(params, batch_stats, batch):
        def loss_of(p):
            out, mut = jmodel.apply({"params": p,
                                     "batch_stats": batch_stats}, batch,
                                    train=True, mutable=["batch_stats"])
            return JMMR()(j_weak_transform(out, batch)), mut

        (loss, mut), grads = jax.value_and_grad(loss_of, has_aux=True)(
            params)
        return loss, grads, mut["batch_stats"]

    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        loss, grads, stats = jax.jit(
            step, in_shardings=(rep, rep, jmesh.batch_sharding(mesh)),
            out_shardings=(rep, rep, rep))(
                jax.device_put(variables["params"], rep),
                jax.device_put(variables["batch_stats"], rep),
                jmesh.shard_batch(batch, mesh))
    finally:
        mp.undo()
    ref = from_jax_variables(jax.tree.map(
        np.asarray, {"params": grads, "batch_stats": stats}),
        ranks._align("word", (0.0, 0.0)))
    return float(loss), ref


@pytest.mark.timeout(300)
def test_word_wise_dp2_step_matches_jax(dp2, jax_dp2_word_step):
    jloss, ref = jax_dp2_word_step
    for rank in dp2:
        got = rank["word_jax"]
        assert got["losses"][0] == pytest.approx(jloss, rel=1e-5)
        assert set(got["grads"]) <= set(ref)
        for name, g in got["grads"].items():
            trunk = "conv_block" in name or "bn0" in name
            assert _rel(g, ref[name]) <= (2e-2 if trunk else 1e-4), name
        for name, s in got["first_stats"].items():
            np.testing.assert_allclose(s, ref[name], rtol=1e-6, atol=1e-5,
                                       err_msg=name)


class _Mesh:
    """The part of ``parallel.mesh.Mesh`` that ``rank_batch`` reads."""

    def __init__(self, size: int, index: int):
        self.size, self.index = size, index

    def axis_size(self, name):
        return self.size if name == "data" else 1

    def coordinate(self, name):
        return self.index if name == "data" else 0


@pytest.mark.parametrize("nums", [[1, 2, 1, 2], [2, 1, 1, 1], [1, 1, 1]],
                         ids=["sum6", "sum5", "sum_is_b_padded"])
def test_ragged_phrase_feed_keeps_every_phrase(nums):
    """Each rank gets every phrase and its own clips' gather maps, so that
    its clips' packed phrases and the whole packed batch are one rank's,
    whether ΣN divides the ranks or not, and the padding of a batch of 3
    repeats a clip but never a phrase (ΣN = B there)."""
    batch = ranks.phrase_batch(nums, seed=3)
    flat = torch.from_numpy(batch["phrases"]).float()
    whole = pack_phrases(flat, torch.from_numpy(batch["phrases_pad_index"]),
                         torch.from_numpy(batch["phrases_num"]))
    keys = ranks._align("phrase", (0.0, 0.0)).whole_batch_inputs
    rows = []
    for index in range(2):
        local, real = rank_batch(batch, _Mesh(2, index), keys)
        assert real == len(nums)
        np.testing.assert_array_equal(local["phrases"], batch["phrases"])
        np.testing.assert_array_equal(local["phrases_len"],
                                      batch["phrases_len"])
        assert local["waveform"].shape[0] == -(-len(nums) // 2)
        packed = pack_phrases(
            torch.from_numpy(local["phrases"]).float(),
            torch.from_numpy(local["phrases_pad_index"]),
            torch.from_numpy(local["phrases_num"]))
        assert packed.shape[0] == len(nums) + len(nums) % 2
        torch.testing.assert_close(packed[:len(nums)], whole, rtol=0, atol=0)
        own, _ = rank_batch(batch, _Mesh(2, index))
        rows.append(pack_phrases(
            torch.from_numpy(own["phrases"]).float(),
            torch.from_numpy(own["phrases_pad_index"]),
            torch.from_numpy(own["phrases_num"])))
    torch.testing.assert_close(torch.cat(rows)[:len(nums)], whole, rtol=0,
                               atol=0)


@pytest.mark.timeout(300)
def test_specaugment_stripes_on_dp2_are_one_ranks(dp2, one_rank):
    for kind in ("time", "freq"):
        for i in range(2):
            got = torch.cat([rank["stripes"][kind][i] for rank in dp2])
            assert torch.equal(got, one_rank["stripes"][kind][i])


@pytest.mark.timeout(300)
def test_teacher_weights_are_rank_zeros_on_every_rank(dp2, one_rank):
    """Rank 1 drew its teacher from another seed; after the broadcast both
    ranks hold rank 0's, which the one-rank run (rank 0's seed) draws."""
    ref = one_rank["selfsup"]["teacher"]
    for rank in dp2:
        assert set(rank["selfsup"]["teacher"]) == set(ref)
        for name, value in ref.items():
            assert torch.equal(rank["selfsup"]["teacher"][name], value), name


def _steps_match(got: dict, ref: dict) -> None:
    """dp2's train steps against one rank's, to the dp2 limits."""
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-4)
    assert set(got["grads"]) == set(ref["grads"])
    for name, g in ref["grads"].items():
        assert _rel(got["grads"][name], g) <= 1e-5, name
    for name, s in ref["first_stats"].items():
        np.testing.assert_allclose(got["first_stats"][name], s, rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.timeout(300)
def test_mixup_of_a_pair_across_ranks_raises(dp2, one_rank):
    """The name is the one of the check it replaces (a pair spanning two
    ranks used to raise): such a pair is now mixed as one rank mixes it.
    The 2-clip forward: rank 0 holds the one mixed row, rank 1 none; the
    weak class-mapping step at B = 6: two mixed rows on rank 0, one on
    rank 1."""
    ref = one_rank["odd_mixup"]
    assert ref["clip_sim"].shape == (1, ranks.CLASSES)
    assert [rank["odd_mixup"]["clip_sim"].shape[0] for rank in dp2] == [1, 0]
    for key, value in ref.items():
        got = torch.cat([rank["odd_mixup"][key] for rank in dp2])
        np.testing.assert_allclose(got, value, rtol=0, atol=1e-6,
                                   err_msg=key)
    for rank in dp2:
        _steps_match(rank["mapping_weak_b6"], one_rank["mapping_weak_b6"])
    for name in one_rank["mapping_weak_b6"]["stats"]:
        assert torch.equal(dp2[0]["mapping_weak_b6"]["stats"][name],
                           dp2[1]["mapping_weak_b6"]["stats"][name]), name


@pytest.mark.timeout(300)
def test_dp2_remat_step_matches_dp2(dp2):
    """``trainer.remat`` recomputes the forward, its global BatchNorm sums
    and gathers included, in the backward: the losses, first gradients
    and running statistics of dp2 without it, bit for bit."""
    for rank in dp2:
        plain, remat = rank["strong_remat_False"], rank["strong_remat_True"]
        assert remat["losses"] == plain["losses"]
        for key in ("grads", "first_stats", "stats"):
            assert set(remat[key]) == set(plain[key])
            for name, value in plain[key].items():
                assert torch.equal(remat[key][name], value), (key, name)


@pytest.mark.timeout(300)
def test_ranks_import_no_jax(dp2):
    for rank in dp2:
        assert rank["jax_modules"] == []


def test_a_rank_with_no_mixed_row_runs_the_gru():
    """A rank that holds no mixed row (``kernel_shard.mixup_rows``) runs
    the trainable BiGRU on no rows: an empty output and zero gradients
    (exact), in f32 and bf16, so that every rank's gradients sum alike."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import gru
    for dtype in (torch.float32, torch.bfloat16):
        proj = torch.zeros(5, 0, 24, requires_grad=True)
        wh = torch.randn(2, 8, 24, requires_grad=True)
        bn = torch.randn(2, 8, requires_grad=True)
        ys = gru.bigru_trainable(proj, wh, bn, dtype)
        assert ys.shape == (5, 0, 8) and ys.dtype == torch.float32
        ys.sum().backward()
        for t in (proj, wh, bn):
            assert t.grad is not None and not t.grad.any()
