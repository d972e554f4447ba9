"""``utils/determinism.py`` on the CPU: two runs of a few AM steps give the
same bits, and a gradient that differs from run to run is found and placed
at the module whose output it reaches first."""

import os

import pytest
import torch

from aas_enhancement_tpu_torch.config import (AMConfig, Config, DataConfig,
                                              DiscriminatorConfig, EnhancerConfig,
                                              TrainConfig)
from aas_enhancement_tpu_torch.data.synthetic import generate_corpus
from aas_enhancement_tpu_torch.train import objectives as obj
from aas_enhancement_tpu_torch.utils import determinism


def _cfg(objective: str) -> Config:
    return Config(
        am=AMConfig(rnn_hidden=16, rnn_layers=2, conv_channels=8),
        enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=12, rnn_layers=1),
        discriminator=DiscriminatorConfig(channels=(8, 16)),
        train=TrainConfig(objective=objective, batch_size=2, epochs=100, log_every=1),
        data=DataConfig(num_buckets=1))


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    return generate_corpus(os.path.join(tmp_path_factory.mktemp("det"), "corpus"), n_utts=4,
                           seed=7, n_words=(2, 3))


@pytest.mark.parametrize("objective", ["am", "aas"])
def test_cpu_runs_are_bit_reproducible(objective, manifests):
    out = determinism.probe(_cfg(objective), manifests, 2, torch.device("cpu"))
    assert out["bit_reproducible"], out
    assert out["records_equal"] and out["params_differ"] == {}
    assert out["step1_grads_differ"] == {}
    assert out["step1_first_forward_diff"] is None
    assert out["step1_first_backward_diff"] is None
    assert out["modules_traced"] > 5
    key = "loss_ctc_am" if objective == "am" else "loss_ctc"
    first, last = out["losses"][key]["first"], out["losses"][key]["last"]
    assert first[0] == first[1] and last[0] == last[1]


class _NoisyGrad(torch.autograd.Function):
    """Identity forward; a backward that adds a fresh draw to the gradient,
    as a sum in float atomics adds its terms in a different order each run."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g + 1e-7 * torch.randn_like(g)


def test_finds_the_loss_whose_backward_differs(manifests, monkeypatch):
    ctc = obj.ctc_loss_mean
    monkeypatch.setattr(obj, "ctc_loss_mean",
                        lambda logits, *a, **kw: ctc(_NoisyGrad.apply(logits), *a, **kw))
    out = determinism.probe(_cfg("am"), manifests, 2, torch.device("cpu"))
    assert not out["bit_reproducible"]
    assert out["params_differ"] and out["step1_grads_differ"]
    assert out["step1_first_forward_diff"] is None         # the forward is the same
    # The first gradient that differs is the one at the AM's output, the logits.
    assert out["step1_first_backward_diff"]["module"].split(".")[0] == "am"
    assert out["losses"]["loss_ctc_am"]["first"][0] == out["losses"]["loss_ctc_am"]["first"][1]
