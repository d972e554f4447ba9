"""Three training steps of the quality protocols' own configurations, the
port's ``train`` against JAX's, on the CPU at small widths:

- blockwise ``aas`` (``quality/streaming_native_train.py::train_config``:
  G's forward through the deployment windowing, chunk 1.0 / lookahead 0.5 /
  history 0.5 s), from ``init_state`` seed 31;
- ``am`` through the frozen enhancer, both blockwise, with the KL anchor
  (``quality/am_streaming_finetune.py::train_config`` with ``--distill
  0.5``: ``am_through_enhancer``, ``streaming_finetune``,
  ``streaming_finetune_am``, ``lr_am`` x 0.1, ``distill_lambda`` 0.5), from
  ``init_state`` seed 17.

The port starts from JAX's own initial state (carried across with
convert.py), optimizer state zero on both sides; the JAX configuration is
the port's read back from its JSON (``tests/test_torch_quality_calls.py``
holds the port's to the JAX script's field for field).  Tolerances are PR
21's (``tests/test_torch_e2e.py``; f32 on both sides, every sum in another
order, so the difference grows with each step):

- every record's losses: rtol 1e-3;
- ``am`` final parameters (SGD + Nesterov: linear in the gradient): atol
  1e-4 of the tensor's largest entry plus 1e-5;
- ``aas`` final parameters (Adam, b1 0.5): within 1e-2 lr of JAX's, but for
  G's conv biases ahead of a GroupNorm of one channel a group (their true
  gradient is 0; Adam scales both sides' rounding noise to steps of about
  lr), held to the most two Adam runs can part in 3 steps, 2 x
  ``adam_travel`` lr.  The blockwise run adds a tail that PR 21's offline
  run did not have: with every loss and G's gradient norm equal to ~4e-7
  relative at each step, 2 of the 123,648 entries of G's first BiLSTM
  ``wx`` ended 0.078 and 0.023 lr apart (their Adam moments of ordinary
  size, so not the zero-gradient case; which step's gradient parts there
  was not traced).  So at most 1e-4 of a tensor's entries may lie past 1e-2
  lr, each within the 2 x ``adam_travel`` lr bound;
- the networks a run keeps frozen (the AM of ``aas``, G of ``am``) equal
  to their start bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.config import Config as JConfig
from aas_enhancement_tpu.train import loop as jloop
from aas_enhancement_tpu_torch.config import (AMConfig, Config, DataConfig,
                                              DiscriminatorConfig, EnhancerConfig, TrainConfig)
from aas_enhancement_tpu_torch.data.synthetic import generate_corpus
from aas_enhancement_tpu_torch.quality import am_streaming_finetune, streaming_native_train
from aas_enhancement_tpu_torch.train import loop as tloop
from torch_recorder import adam_travel, port_params, port_state

torch.set_num_threads(1)

STEPS = 3


def _base_cfg() -> Config:
    """The e2e run's configuration at small widths (what a workdir's
    ``config.json`` holds), batch 2."""
    return Config(
        am=AMConfig(rnn_hidden=16, rnn_layers=2, conv_channels=8),
        enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=12, rnn_layers=1),
        discriminator=DiscriminatorConfig(channels=(8, 16)),
        train=TrainConfig(objective="aas", batch_size=2, epochs=100000, log_every=1,
                          lr_am=6e-4, lr_g=3e-4, lr_d=3e-4, lambda_adv=0.2),
        data=DataConfig(num_buckets=2))


CASES = {
    "blockwise_aas": (streaming_native_train, ["--batch-size", "2"], 31),
    "am_through_blockwise_g_distill": (am_streaming_finetune,
                                       ["--batch-size", "2", "--distill", "0.5"], 17),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 utterances of the protocol's language: 4 batches of 2 an epoch."""
    return generate_corpus(str(tmp_path_factory.mktemp("quality_traj")), n_utts=8, seed=7,
                           n_words=(3, 8), snr_range=(0.0, 10.0), reverb_prob=0.3)


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax(case, corpus):
    module, argv, seed = CASES[case]
    tcfg = module.train_config(_base_cfg(), module.parse_args(["--workdir", "-", *argv]))
    cfg = JConfig.from_json(tcfg.to_json())
    t = tcfg.train
    if case == "blockwise_aas":
        assert t.objective == "aas" and t.streaming_finetune and not t.streaming_finetune_am
        manifests = (corpus["noisy"], corpus["clean"])
    else:
        assert (t.objective, t.am_through_enhancer, t.streaming_finetune,
                t.streaming_finetune_am, t.distill_lambda) == ("am", True, True, True, 0.5)
        manifests = (corpus["noisy"],)
    jstate0 = jloop.init_state(cfg, jax.random.key(seed))
    start = port_params(jstate0)
    jstate, jrecs = jloop.train(cfg, *manifests, max_steps=STEPS, state=jstate0)
    state, recs = tloop.train(tcfg, *manifests, max_steps=STEPS,
                              state=port_state(tcfg, start), device="cpu")

    assert state.step == STEPS
    assert [r["step"] for r in recs] == [r["step"] for r in jrecs] == list(range(1, STEPS + 1))
    for r, j in zip(recs, jrecs):
        losses = {k for k in j if k.startswith("loss")}
        assert losses and losses <= set(r), (losses, r)
        if case != "blockwise_aas":
            assert "loss_distill" in losses
        for k in losses:
            assert r[k] == pytest.approx(j[k], rel=1e-3), (r["step"], k)
    end = port_params(jstate)
    assert set(end) == set(start)
    frozen = "am" if case == "blockwise_aas" else "g"
    travel = 2 * adam_travel(STEPS, t.adam_b1, t.adam_b2) * t.lr_g
    for name, ref in end.items():
        got = getattr(state, name).state_dict()
        assert set(got) == set(ref)
        for k, r in ref.items():
            g, r = got[k].numpy(), r.numpy()
            if name == frozen:
                assert torch.equal(got[k], start[name][k]), (name, k)
            if t.objective == "am" or name == "am":
                np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max() + 1e-5,
                                           err_msg=f"{name}.{k}")
            elif name == "g" and k.startswith("convs.") and k.endswith(".bias"):
                assert np.abs(g - r).max() <= travel, (name, k)
            else:
                apart = np.abs(g - r) > 1e-2 * t.lr_g
                assert apart.sum() <= 1e-4 * apart.size, (name, k, apart.sum())
                assert np.abs(g - r).max() <= travel, (name, k)
