"""The port's public helpers and routing switches against the JAX
package's, on seeded numpy inputs.

* the vocabulary builder (``build_vocab``, ``build_vocab_from_files``,
  ``main`` and ``python -m ...data.vocabulary``): the pickles equal JAX's,
  byte for byte;
* ``mean_by_group``, ``masked_softmax``: within 1e-6 absolute of JAX's;
  ``power_spectrogram`` (both paths): within 1e-6 relative RMS (5.4e-7
  measured for the DFT-basis path: XLA's strided convolution and the
  port's matrix product sum the 1024 taps in other orders);
  ``log_mel_spectrogram_numpy``: equal (the same float64 NumPy);
* ``training.profiling.trace``: a Chrome trace of the block, written also
  when the block raises;
* ``Cnn8Rnn(logmel_kernel=)`` (JAX ``TTG_PALLAS_FRONTEND``): the
  frontend it routes to, and the forced-off f32 log-mel within 1e-3 dB of
  JAX's under ``TTG_PALLAS_FRONTEND=0``;
* ``Cnn8Rnn(block1_pair=False)`` (JAX ``TTG_FUSED_B1=0``): block 1 off its
  pair kernel onto the bf16 plain path, blocks 2-4 on theirs; that block
  against JAX's ``ConvBlock`` under ``TTG_FUSED_B1=0`` within 1e-2
  relative RMS (bf16 convolutions of two libraries; equal on the CPU
  where it was written).
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texttoaudiogrounding_tpu.data import vocabulary as jvocab
from texttoaudiogrounding_tpu.models.layers import ConvBlock as JConvBlock
from texttoaudiogrounding_tpu.ops import frontend as jfront
from texttoaudiogrounding_tpu.ops import masking as jmask
from texttoaudiogrounding_tpu_torch import flagship_model
from texttoaudiogrounding_tpu_torch.data import vocabulary
from texttoaudiogrounding_tpu_torch.models import Cnn8Rnn, audio_encoder
from texttoaudiogrounding_tpu_torch.models import layers
from texttoaudiogrounding_tpu_torch.models.layers import ConvBlock
from texttoaudiogrounding_tpu_torch.ops import frontend, masking
from texttoaudiogrounding_tpu_torch.training.profiling import trace

ROOT = Path(__file__).resolve().parents[1]


def _items(seed: int, n: int = 12) -> list:
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(40)]
    items = []
    for i in range(n):
        text = " ".join(rng.choice(words, rng.integers(1, 6)))
        items.append({"tokens": text} if i % 3 else {"caption": text})
    return items


def test_build_vocab_writes_jaxs_pickle(tmp_path):
    items = _items(0)
    jvocab.build_vocab(items, tmp_path / "jax.pkl")
    vocab = vocabulary.build_vocab(items, tmp_path / "port.pkl")
    assert (tmp_path / "port.pkl").read_bytes() == \
        (tmp_path / "jax.pkl").read_bytes()
    with open(tmp_path / "port.pkl", "rb") as f:
        assert pickle.load(f) == vocab.word2idx
    assert vocabulary.build_vocab(items).word2idx == vocab.word2idx


def test_vocabulary_command_line_writes_jaxs_pickle(tmp_path, capsys):
    files = []
    for seed in (1, 2):
        path = tmp_path / f"label{seed}.json"
        path.write_text(json.dumps(_items(seed)))
        files.append(str(path))
    jvocab.build_vocab_from_files(files, tmp_path / "jax.pkl")
    vocabulary.build_vocab_from_files(files, tmp_path / "files.pkl")
    vocabulary.main(files + [str(tmp_path / "main.pkl")])
    assert "Total vocabulary size" in capsys.readouterr().out
    subprocess.run([sys.executable, "-m",
                    "texttoaudiogrounding_tpu_torch.data.vocabulary",
                    *files, str(tmp_path / "module.pkl")], cwd=ROOT,
                   check=True, capture_output=True)
    want = (tmp_path / "jax.pkl").read_bytes()
    for name in ("files", "main", "module"):
        assert (tmp_path / f"{name}.pkl").read_bytes() == want, name


def test_mean_by_group_matches_jax():
    rng = np.random.default_rng(3)
    arr = rng.normal(size=(9, 4, 5)).astype(np.float32)
    ids = np.array([0, 2, 2, 1, 0, 2, 1, 1, 0])
    sizes = np.bincount(ids, minlength=3)
    ref = jmask.mean_by_group(jnp.asarray(arr), jnp.asarray(ids), 3,
                              jnp.asarray(sizes))
    got = masking.mean_by_group(torch.from_numpy(arr), torch.from_numpy(ids),
                                3, torch.from_numpy(sizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    # exported by the ops package, as JAX's exports it
    import texttoaudiogrounding_tpu.ops as jops
    import texttoaudiogrounding_tpu_torch.ops as ops
    assert ops.__all__ == jops.__all__
    assert ops.mean_by_group is masking.mean_by_group


@pytest.mark.parametrize("dim", [1, -1])
def test_masked_softmax_matches_jax(dim):
    rng = np.random.default_rng(4)
    scores = (rng.normal(size=(3, 7, 6)) * 4).astype(np.float32)
    mask = rng.random((3, 7, 6)) > 0.4
    mask[:, 0, 0] = True
    ref = jmask.masked_softmax(jnp.asarray(scores), jnp.asarray(mask),
                               axis=dim)
    got = masking.masked_softmax(torch.from_numpy(scores),
                                 torch.from_numpy(mask), dim=dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_attention_pooling_takes_masked_softmax(monkeypatch):
    from texttoaudiogrounding_tpu_torch.models import text_encoder
    seen = []
    real = text_encoder.masked_softmax
    monkeypatch.setattr(text_encoder, "masked_softmax",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    pool = text_encoder.AttentionPooling(8)
    out = pool(torch.randn(2, 5, 8), torch.tensor([5, 2]))
    assert seen and out.shape == (2, 8)


@pytest.mark.parametrize("use_fft", [False, True])
def test_power_spectrogram_matches_jax(use_fft):
    cfg = frontend.cnn8rnn_mel_config(32000)
    wave = (np.random.default_rng(5).normal(size=(2, 3200)) * 0.1
            ).astype(np.float32)
    ref = np.asarray(jfront.power_spectrogram(
        jnp.asarray(wave), jfront.cnn8rnn_mel_config(32000),
        use_fft=use_fft))
    got = frontend.power_spectrogram(torch.from_numpy(wave), cfg,
                                     use_fft=use_fft).numpy()
    assert got.shape == ref.shape
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    assert np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)) <= 1e-6


@pytest.mark.parametrize("top_db", [None, 80.0])
def test_log_mel_numpy_golden_is_jaxs(top_db):
    wave = np.random.default_rng(6).normal(size=(2, 4000))
    for make, jmake in ((frontend.cnn8rnn_mel_config,
                         jfront.cnn8rnn_mel_config),
                        (frontend.cdur_mel_config, jfront.cdur_mel_config)):
        cfg = frontend.LogMelConfig(**{**make(32000).__dict__,
                                       "top_db": top_db})
        jcfg = jfront.LogMelConfig(**{**jmake(32000).__dict__,
                                      "top_db": top_db})
        np.testing.assert_array_equal(
            frontend.log_mel_spectrogram_numpy(wave, cfg),
            jfront.log_mel_spectrogram_numpy(wave, jcfg))


def test_trace_writes_the_blocks_trace(tmp_path):
    with trace(tmp_path / "a", device="cpu") as path:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)
    with pytest.raises(KeyError):
        with trace(tmp_path / "b", device="cpu") as path:
            torch.ones(3).sum()
            raise KeyError("raised in the block")
    assert path.is_file()


def _frontends(monkeypatch) -> list:
    """Records which frontend each ``Cnn8Rnn`` forward takes."""
    seen = []
    for name in ("log_mel_spectrogram", "fused_log_mel_spectrogram"):
        real = getattr(audio_encoder, name)

        def wrapped(*a, _real=real, _name=name, **k):
            out = _real(*a, **k)
            seen.append((_name, out))
            return out
        monkeypatch.setattr(audio_encoder, name, wrapped)
    return seen


def test_logmel_kernel_forces_the_frontend(monkeypatch):
    seen = _frontends(monkeypatch)
    wave = (np.random.default_rng(7).normal(size=(2, 3200)) * 0.1
            ).astype(np.float32)
    batch = {"waveform": torch.from_numpy(wave),
             "waveform_len": torch.tensor([3200, 3000])}
    routes = {}
    for dtype, kernel in ((torch.float32, None), (torch.bfloat16, None),
                          (torch.float32, True), (torch.bfloat16, False)):
        with torch.no_grad():
            Cnn8Rnn(dtype=dtype, logmel_kernel=kernel).eval()(batch)
        routes[(dtype, kernel)] = seen[-1][0]
    assert routes == {
        (torch.float32, None): "log_mel_spectrogram",
        (torch.bfloat16, None): "fused_log_mel_spectrogram",
        (torch.float32, True): "fused_log_mel_spectrogram",
        (torch.bfloat16, False): "log_mel_spectrogram"}
    monkeypatch.setenv("TTG_PALLAS_FRONTEND", "0")
    ref = jfront.log_mel_spectrogram(jnp.asarray(wave),
                                     jfront.cnn8rnn_mel_config(32000),
                                     compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(seen[-1][1].numpy(), np.asarray(ref), rtol=0,
                               atol=1e-3)


def _block_variables(blk: ConvBlock) -> dict:
    def np_(t):
        return jnp.asarray(t.detach().numpy())
    params, stats = {}, {}
    for i in (1, 2):
        conv, bn = getattr(blk, f"conv{i}"), getattr(blk, f"bn{i}")
        params[f"conv{i}"] = {"kernel": np_(conv.weight.permute(2, 3, 1, 0))}
        params[f"bn{i}"] = {"scale": np_(bn.weight), "bias": np_(bn.bias)}
        stats[f"bn{i}"] = {"mean": np_(bn.running_mean),
                           "var": np_(bn.running_var)}
    return {"params": params, "batch_stats": stats}


def test_block1_pair_off_runs_the_plain_block(monkeypatch):
    torch.manual_seed(0)
    blk = ConvBlock(1, 64, "int8", pair_kernel=False).eval()
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn2):
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_(0, 0.1)
            bn.running_mean.normal_(0, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
    monkeypatch.setattr(layers, "fused_block1_pair", None)   # not called
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 16, 64, 1)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got = blk(x)
        plain = blk._plain(x, (2, 2), bn_train=False)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    monkeypatch.setenv("TTG_FUSED_B1", "0")
    ref = JConvBlock(64, dtype=jnp.bfloat16).apply(
        _block_variables(blk), jnp.asarray(x.float().numpy(), jnp.bfloat16),
        bn_train=False, pool_size=(2, 2), fused="int8")
    ref = np.asarray(ref, np.float32)
    diff = got.float().numpy() - ref
    assert np.sqrt(np.mean(diff ** 2) / np.mean(ref ** 2)) <= 1e-2
    # the model passes the switch to block 1 alone, and the flagship
    # model both switches to its tower
    enc = Cnn8Rnn(dtype=torch.bfloat16, conv_mode="int8", block1_pair=False)
    assert [getattr(enc, f"conv_block{i}").pair_kernel
            for i in range(1, 5)] == [False, True, True, True]
    served = flagship_model(device="cpu", block1_pair=False,
                            logmel_kernel=False).audio_encoder
    assert not served.conv_block1.pair_kernel
    assert served.logmel_kernel is False
    assert flagship_model(serving=False, device="cpu", logmel_kernel=True
                          ).audio_encoder.logmel_kernel is True
    assert jax.devices()[0].platform == "cpu"
