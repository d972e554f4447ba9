"""The port's Python entry points run on the card unless the caller asks for
the CPU: with no device given, and no GPU there, each of them raises instead
of carrying on on the CPU; with ``"cpu"`` each runs the plain versions.

Small widths (8 conv channels, BiLSTM-12, one BiGRU-16), a synthetic corpus of
four utterances; what the CPU runs compute is held to the JAX package by the
other test_torch_* files, here only the device rule is pinned.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from aas_enhancement_tpu_torch.config import (AMConfig, Config, DataConfig,
                                              DiscriminatorConfig, EnhancerConfig,
                                              TrainConfig)
from aas_enhancement_tpu_torch.data import generate_corpus
from aas_enhancement_tpu_torch.enhance import enhance_utterance, init_enhancer
from aas_enhancement_tpu_torch.evaluation import init_am
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.train.loop import init_state, load_state, train
from aas_enhancement_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

CFG = Config(
    am=AMConfig(rnn_hidden=16, rnn_layers=1, conv_channels=8),
    enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=12, rnn_layers=1),
    discriminator=DiscriminatorConfig(channels=(8, 16)),
    train=TrainConfig(objective="aas", batch_size=2, log_every=1),
    data=DataConfig(num_buckets=1))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_corpus(str(tmp_path_factory.mktemp("corpus")), n_utts=4, seed=2,
                           word_len=(2, 6))


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _calls(corpus):
    """name -> fn(*device): each entry point with the device argument left to
    the caller (none: the default)."""
    wav = (0.1 * np.random.default_rng(0).standard_normal(4000)).astype(np.float32)
    return {
        "init_enhancer": lambda *dev: init_enhancer(CFG, 0, *dev),
        "enhance_utterance": lambda *dev: enhance_utterance(
            CFG, init_enhancer(CFG, 0, "cpu"), wav, *dev),
        "init_am": lambda *dev: init_am(CFG, 0, *dev),
        "init_state": lambda *dev: init_state(CFG, 0, *dev),
        "train": lambda *dev: train(CFG, corpus["noisy"], corpus["clean"], 2, None, *dev),
    }


ENTRY_POINTS = ["init_enhancer", "enhance_utterance", "init_am", "init_state", "train"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card_and_raises_without_one(name, corpus, no_gpu):
    fn = {"init_enhancer": init_enhancer, "enhance_utterance": enhance_utterance,
          "init_am": init_am, "init_state": init_state, "train": train}[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _calls(corpus)[name]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _calls(corpus)[name]("cuda")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_runs_on_the_cpu_when_asked(name, corpus, no_gpu):
    out = _calls(corpus)[name]("cpu")
    if name == "enhance_utterance":
        assert out.shape == (4000,) and np.all(np.isfinite(out))
    elif name == "init_state":
        assert {p.device.type for net in (out.g, out.d, out.am)
                for p in net.parameters()} == {"cpu"}
    elif name == "train":
        state, records = out
        assert state.step == 2 and records[-1]["step"] == 2
        assert all(np.isfinite(v) for v in records[-1].values())
    else:
        assert {p.device.type for p in out.parameters()} == {"cpu"}


def test_resolve_device(no_gpu):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")


def test_same_weights_on_every_device():
    """Weights are drawn on the CPU from the seed whatever the device asked."""
    a, b = init_enhancer(CFG, 3, "cpu"), init_enhancer(CFG, 3, torch.device("cpu"))
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    other = init_enhancer(dataclasses.replace(CFG), 4, "cpu")
    assert any(not torch.equal(p, q) for p, q in zip(a.parameters(), other.parameters()))


def test_load_state_defaults_to_the_card(tmp_path, no_gpu):
    """A checkpoint directory loads onto the card unless the caller asks for
    the CPU; without a GPU the default raises."""
    assert inspect.signature(load_state).parameters["device"].default == "cuda"
    (tmp_path / "config.json").write_text(CFG.to_json())
    ckpt.save(str(tmp_path), 1, init_state(CFG, 0, "cpu"))
    for dev in ((), ("cuda",)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_state(str(tmp_path), *dev)
    state, _ = load_state(str(tmp_path), "cpu")
    assert {p.device.type for net in (state.g, state.d, state.am)
            for p in net.parameters()} == {"cpu"}
