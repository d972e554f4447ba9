"""Port parity: waveform augmentation (aas_enhancement_tpu_torch/data/
augment.py, a copy of the JAX package's) and the augmenting dataset.

Exact: the same ``np.random.default_rng`` state gives the same arrays; the
port's ``AudioDataset(augment=True)`` batches equal the JAX dataset's (its
Python reader: augmentation bypasses the native decoder) for two epochs, the
clean stream's draws, and after a ``batches(start=)`` skip.
"""

import numpy as np
import pytest

from aas_enhancement_tpu.config import AudioConfig, DataConfig
from aas_enhancement_tpu.data import augment as jaug
from aas_enhancement_tpu.data import dataset as jds
from aas_enhancement_tpu.data.synthetic import generate_corpus
from aas_enhancement_tpu.data.wav import write_wav
from aas_enhancement_tpu_torch.config import AudioConfig as TAudio
from aas_enhancement_tpu_torch.config import DataConfig as TData
from aas_enhancement_tpu_torch.data import augment as taug
from aas_enhancement_tpu_torch.data import dataset as tds

FIELDS = ("wav", "wav_lengths", "labels", "label_paddings", "real_size")


@pytest.fixture(scope="module")
def noise_dir(tmp_path_factory):
    """Three noise wavs: one shorter than the test wav (tiled), two longer."""
    d = tmp_path_factory.mktemp("noise")
    rng = np.random.default_rng(11)
    for i, n in enumerate((3000, 20000, 48000)):
        write_wav(str(d / f"n{i}.wav"), (0.3 * rng.standard_normal(n)).astype(np.float32),
                  16000)
    return str(d)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_corpus(str(tmp_path_factory.mktemp("corpus")), n_utts=6, seed=4)


def _wav(seed=0, n=8000, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("name,kw", [
    ("gain_perturb", {}), ("gain_perturb", {"db_range": (10.0, 20.0)}),
    ("speed_perturb", {}), ("speed_perturb", {"rate_range": (0.5, 0.6)})])
def test_perturbations_match_jax(name, kw):
    for seed in range(4):
        ref = getattr(jaug, name)(_wav(seed), np.random.default_rng(seed), **kw)
        got = getattr(taug, name)(_wav(seed), np.random.default_rng(seed), **kw)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_noise_injector_matches_jax(noise_dir):
    ref_inj = jaug.NoiseInjector(noise_dir)
    got_inj = taug.NoiseInjector(noise_dir)
    for seed, n in ((0, 8000), (1, 30000), (2, 100), (3, 8000)):
        rng_r, rng_g = np.random.default_rng(seed), np.random.default_rng(seed)
        for snr in ((0.0, 15.0), (-5.0, -5.0)):
            ref = ref_inj(_wav(seed, n, scale=0.9), rng_r, snr)
            got = got_inj(_wav(seed, n, scale=0.9), rng_g, snr)
            np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="no noise wavs"):
        taug.NoiseInjector(str(noise_dir) + "_missing")


@pytest.mark.parametrize("speed,gain,noise_prob", [(True, True, 0.4), (False, True, 1.0),
                                                   (True, False, 0.0)])
def test_augment_wav_matches_jax(noise_dir, speed, gain, noise_prob):
    ref_inj, got_inj = jaug.NoiseInjector(noise_dir), taug.NoiseInjector(noise_dir)
    for seed in range(5):
        ref = jaug.augment_wav(_wav(seed), np.random.default_rng(seed), noise=ref_inj,
                               noise_prob=noise_prob, speed=speed, gain=gain)
        got = taug.augment_wav(_wav(seed), np.random.default_rng(seed), noise=got_inj,
                               noise_prob=noise_prob, speed=speed, gain=gain)
        np.testing.assert_array_equal(got, ref)


def _datasets(corpus, noise_dir, paired=False, **kw):
    d = dict(num_buckets=2, augment=True, noise_dir=noise_dir, noise_prob=0.5, **kw)
    manifest = corpus["noisy"]
    pm = corpus["clean"] if paired else None
    ref = jds.AudioDataset(manifest, AudioConfig(), DataConfig(native_decode=False, **d),
                           paired_manifest=pm)
    got = tds.AudioDataset(manifest, TAudio(), TData(**d), paired_manifest=pm)
    return ref, got


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), field)
        assert (a.clean_wav is None) == (b.clean_wav is None)
        if b.clean_wav is not None:
            np.testing.assert_array_equal(a.clean_wav, b.clean_wav)


def test_augmenting_dataset_matches_jax_for_two_epochs_and_a_skip(corpus, noise_dir):
    ref, got = _datasets(corpus, noise_dir)
    assert got.bucket_sizes == ref.bucket_sizes
    assert [it["num_samples"] for it in got.items] == [it["num_samples"] for it in ref.items]
    epochs = []
    for epoch in (0, 1):
        g = list(got.batches(2, seed=3, epoch=epoch))
        _assert_batches_equal(g, list(ref.batches(2, seed=3, epoch=epoch)))
        epochs.append(g)
    # The epochs differ (the draws are keyed on the epoch) ...
    assert not np.array_equal(epochs[0][0].wav, epochs[1][0].wav)
    # ... and a skip (the resume fast-forward) leaves the later batches as they were.
    _assert_batches_equal(list(got.batches(2, seed=3, epoch=1, start=1)), epochs[1][1:])
    _assert_batches_equal(list(got.batches(2, seed=3, epoch=1, start=1)),
                          list(ref.batches(2, seed=3, epoch=1, start=1)))


def test_augmenting_clean_stream_matches_jax(corpus, noise_dir):
    ref, got = _datasets(corpus, noise_dir, augment_speed=False)
    r, g = jds.UnpairedCleanStream(ref, 3, seed=5), tds.UnpairedCleanStream(got, 3, seed=5)
    r.skip(), g.skip()
    for bucket in (48000, 32000):
        _assert_batches_equal([g.next_batch(bucket)], [r.next_batch(bucket)])


def test_paired_targets_stay_unaugmented(corpus, noise_dir):
    """With a paired manifest neither side is augmented (the target must stay
    sample-aligned); the batches equal the JAX dataset's."""
    from aas_enhancement_tpu_torch.data.wav import read_wav
    ref, got = _datasets(corpus, noise_dir, paired=True)
    _assert_batches_equal(list(got.batches(2, seed=1, epoch=1)),
                          list(ref.batches(2, seed=1, epoch=1)))
    items = got.items[:2]
    batch = got.make_batch(items, epoch=3)
    for j, it in enumerate(items):
        for wav, path in ((batch.wav, it["wav"]), (batch.clean_wav, it["clean_wav"])):
            raw = read_wav(path)[0]
            np.testing.assert_array_equal(wav[j, : len(raw)], raw)
