"""The port's other loaders (ROADMAP A9b): the native wav batch decoder
(aas_enhancement_tpu_torch.data.native_audio, utils/native_build.py) and the
worker loader (data/grain_loader.py) against the Python reader, the
in-process iterator and the JAX package, on the CPU.

Everything here is exact: the native decoder equals the Python reader bit for
bit (float32 and int16) and the JAX package's native decoder; the dataset's
batches are the same with ``native_decode`` on and off; the worker loader
serves the in-process batches in their order; a 2-step ``train`` with
``use_grain`` gives the records and parameters of one without, bit for bit.
"""

import logging
import multiprocessing

import numpy as np
import pytest
import torch

from aas_enhancement_tpu.config import (AMConfig, Config, DataConfig,
                                        DiscriminatorConfig, EnhancerConfig, TrainConfig)
from aas_enhancement_tpu.data import native_audio as jax_native_audio
from aas_enhancement_tpu.data.synthetic import generate_corpus
from aas_enhancement_tpu_torch.config import AudioConfig as TAudio
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.config import DataConfig as TData
from aas_enhancement_tpu_torch.data import native_audio
from aas_enhancement_tpu_torch.data.dataset import AudioDataset, _to_int16
from aas_enhancement_tpu_torch.data.grain_loader import grain_batches
from aas_enhancement_tpu_torch.data.wav import read_wav, write_wav
from aas_enhancement_tpu_torch.train.loop import train
from aas_enhancement_tpu_torch.utils import native_build

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    assert native_audio.build(), "the port's native libraries did not build"
    return generate_corpus(str(tmp_path_factory.mktemp("loader")), n_utts=7, seed=3)


def _paths(manifest):
    with open(manifest) as f:
        return [line.split(",")[0] for line in f.read().splitlines()]


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_batch_decode_equals_python_reader_and_jax(corpus, dtype):
    paths = _paths(corpus["noisy"])
    refs = [read_wav(p)[0] for p in paths]
    bucket = max(len(r) for r in refs) - 500            # the longest is cut
    out, lengths = native_audio.batch_decode(paths, bucket, expected_sr=16000, dtype=dtype)
    assert native_audio.batch_decode.route == "native"
    assert out.dtype == np.dtype(dtype) and out.shape == (len(paths), bucket)
    for j, ref in enumerate(refs):
        n = min(len(ref), bucket)
        want = ref[:n] if dtype == "float32" else _to_int16(ref[:n].copy())
        assert lengths[j] == n
        np.testing.assert_array_equal(out[j, :n], want)
        assert not out[j, n:].any()
    assert jax_native_audio.build()
    jout, jlen = jax_native_audio.batch_decode(paths, bucket, expected_sr=16000, dtype=dtype)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(lengths, jlen)


def test_batch_decode_errors(corpus, tmp_path):
    bad = str(tmp_path / "bad_sr.wav")
    write_wav(bad, np.zeros(100, np.float32), 8000)
    with pytest.raises(ValueError, match="sample rate 8000"):
        native_audio.batch_decode(_paths(corpus["noisy"])[:2] + [bad], 2000,
                                  expected_sr=16000)
    junk = tmp_path / "junk.wav"
    junk.write_bytes(b"not a wav file at all")
    with pytest.raises(ValueError, match="RIFF"):
        native_audio.batch_decode([str(junk)], 2000)


@pytest.mark.parametrize("feed", ["float32", "int16"])
def test_dataset_batches_equal_with_native_decode_on_and_off(corpus, feed):
    kw = dict(paired_manifest=corpus["clean"])
    on = AudioDataset(corpus["noisy"], TAudio(), TData(num_buckets=2, feed_dtype=feed), **kw)
    off = AudioDataset(corpus["noisy"], TAudio(),
                       TData(num_buckets=2, feed_dtype=feed, native_decode=False), **kw)
    n = 0
    for a, b in zip(on.batches(3, seed=1, epoch=1), off.batches(3, seed=1, epoch=1)):
        assert native_audio.batch_decode.route == "native"
        for k in ("wav", "wav_lengths", "labels", "label_paddings", "clean_wav"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        assert a.real_size == b.real_size
        n += 1
    assert n == on.num_batches(3)


def test_missing_library_falls_back_with_one_warning(corpus, monkeypatch, caplog):
    ds = AudioDataset(corpus["noisy"], TAudio(), TData(num_buckets=1))
    want = [b.wav for b in ds.batches(4)]
    monkeypatch.setattr(native_build, "BUILD_DIR", str(corpus["noisy"]) + ".none")
    monkeypatch.setattr(native_audio, "_lib", None)
    monkeypatch.setattr(native_audio, "_lib_tried", False)
    with caplog.at_level(logging.WARNING, logger=native_audio.__name__):
        got = [b.wav for b in ds.batches(4)]
    assert native_audio.batch_decode.route == "python"
    assert sum("not built" in r.getMessage() for r in caplog.records) == 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("wav", "wav_lengths", "labels", "label_paddings", "clean_wav"):
            x, y = getattr(a, k), getattr(b, k)
            if y is None:
                assert x is None, k
            else:
                assert isinstance(x, np.ndarray) and x.dtype == y.dtype, k
                np.testing.assert_array_equal(x, y, err_msg=k)
        assert a.real_size == b.real_size


@pytest.mark.parametrize("workers,start,paired,sorted_order", [
    (0, 0, False, False), (2, 0, False, False), (2, 1, True, False), (2, 0, False, True)])
def test_worker_loader_serves_the_in_process_order(corpus, workers, start, paired,
                                                   sorted_order):
    ds = AudioDataset(corpus["noisy"], TAudio(), TData(num_buckets=2),
                      paired_manifest=corpus["clean"] if paired else None)
    want = list(ds.batches(2, seed=4, epoch=1, sorted_order=sorted_order, start=start))
    got = list(grain_batches(ds, 2, seed=4, epoch=1, worker_count=workers,
                             sorted_order=sorted_order, start=start))
    _same_batches(got, want)
    assert len(want) == ds.num_batches(2) - start


def test_train_with_the_worker_loader_equals_in_process(corpus):
    """Two CPU aas steps with use_grain (2 workers) == without, bit for bit;
    the run stops its workers when it stops early (max_steps)."""
    def cfg(use_grain):
        return TConfig.from_json(Config(
            am=AMConfig(rnn_hidden=16, rnn_layers=1, conv_channels=8),
            enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=12,
                                    rnn_layers=1),
            discriminator=DiscriminatorConfig(channels=(8, 16)),
            train=TrainConfig(objective="aas", batch_size=2, log_every=1),
            data=DataConfig(num_buckets=1, use_grain=use_grain,
                            grain_workers=2)).to_json())

    runs = [train(cfg(g), corpus["noisy"], corpus["clean"], max_steps=2, device="cpu")
            for g in (False, True)]
    assert multiprocessing.active_children() == []      # the workers have stopped
    (s0, r0), (s1, r1) = runs
    strip = [{k: v for k, v in r.items() if k != "utts_per_sec"} for r in r0]
    assert strip == [{k: v for k, v in r.items() if k != "utts_per_sec"} for r in r1]
    assert [r["step"] for r in r1] == [1, 2]
    for n in ("g", "d"):
        for (k, a), b in zip(getattr(s0, n).state_dict().items(),
                             getattr(s1, n).state_dict().values()):
            assert torch.equal(a, b), (n, k)
