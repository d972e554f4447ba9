"""The quality protocols with a workdir of their own, chained for real on the
CPU: ``cli.e2e`` at small widths (8 / 4 / 4 utterances, 2 AM and 2 AAS
steps), then ``trigram_fusion_eval`` at the 1000-word, -7...-2 dB condition
(its ``am_config`` cut to the same small AM; 8 / 4 / 4 utterances, 2 AM
steps through the train CLI, 300 LM sentences), ``trigram_bigtest`` on its
workdir (4 fresh utterances) and ``biglex_hard_pipeline`` with the e2e
checkpoint as the flagship stack, all three patching one result file.

Each result has exactly the keys of the JAX script's run (``chip_smoke.py``'s
FUSION_KEYS, which tests/test_torch_quality_fusion_calls.py holds to the
scripts) with finite numbers; ``ckpt_am`` opens under ``load_state`` as
objective ``am`` at its step; the two ARPA files read back at orders 2 and
3; ``cli_evaluate_word_lm_tri`` is ``cli.evaluate``'s JSON line.
"""

import json
import math
import os

import pytest
import torch

import chip_smoke
from aas_enhancement_tpu_torch.cli import e2e
from aas_enhancement_tpu_torch.config import AMConfig
from aas_enhancement_tpu_torch.decode.arpa import ArpaWordLM
from aas_enhancement_tpu_torch.quality import (biglex_hard_pipeline, trigram_bigtest,
                                               trigram_fusion_eval)
from aas_enhancement_tpu_torch.train.loop import load_state
from torch_recorder import small_e2e_config

torch.set_num_threads(1)

E2E = ["--n-utts", "8", "--n-dev-utts", "4", "--n-test-utts", "4", "--am-steps", "2",
       "--aas-steps", "2", "--batch-size", "4", "--skip-streaming", "--device", "cpu"]
TRIGRAM = ["--n-utts", "8", "--n-dev-utts", "4", "--n-test-utts", "4", "--am-steps", "2",
           "--batch-size", "4", "--lexicon-size", "1000", "--lm-sentences", "300",
           "--snr-low", "-7", "--snr-high", "-2", "--beam-width", "4"]
SMALL = ["--batch-size", "4", "--beam-width", "4"]


def _small_am(am_config=trigram_fusion_eval.am_config):
    return am_config().replace(am=AMConfig(rnn_hidden=16, rnn_layers=2, conv_channels=8))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """-> (the fusion workdir, the result file, {module: its result})."""
    root = tmp_path_factory.mktemp("fusion_chain")
    e2e_wd, wd, out = str(root / "e2e"), str(root / "fusion"), str(root / "fusion.json")
    mp = pytest.MonkeyPatch()
    mp.setattr(e2e, "cfg_for", small_e2e_config)
    mp.setattr(trigram_fusion_eval, "am_config", _small_am)
    try:
        e2e.run(e2e.parse_args([*E2E, "--workdir", e2e_wd]))
        results = {}
        for module, argv in (
                (trigram_fusion_eval, [*TRIGRAM, "--out", out]),
                (trigram_bigtest, [*SMALL, "--n-utts", "4", "--result", out]),
                (biglex_hard_pipeline, [*SMALL, "--flagship",
                                        os.path.join(e2e_wd, "checkpoint"), "--result", out])):
            name = module.__name__.rsplit(".", 1)[-1]
            results[name] = module.run(module.parse_args([*argv, "--workdir", wd,
                                                          "--device", "cpu"]))
    finally:
        mp.undo()
    return wd, out, results


def _check(results: dict, *names: str) -> dict:
    result = results[names[-1]]
    assert set(result) == chip_smoke.fusion_keys(*names), names[-1]
    bad = [k for k, v in chip_smoke._numbers(result) if not math.isfinite(v)]
    assert not bad, (names[-1], bad)
    return result


def test_trigram_fusion_eval(chain):
    wd, _, results = chain
    tri = _check(results, "trigram_fusion_eval")
    assert (tri["lexicon_size"], tri["snr_range"]) == (1000, [-7.0, -2.0])
    state, cfg = load_state(os.path.join(wd, "ckpt_am"), "cpu")
    assert (cfg.train.objective, state.step, cfg.am.rnn_hidden) == ("am", 2, 16)
    assert state.am is not None
    for order in (2, 3):
        assert ArpaWordLM.load_arpa(os.path.join(wd, f"word{order}.arpa")).order == order
    line = json.loads(tri["cli_evaluate_word_lm_tri"])
    assert line["noisy"]["utterances"] == 4


def test_trigram_bigtest(chain):
    _, _, results = chain
    big = _check(results, "trigram_fusion_eval", "trigram_bigtest")
    assert big["n_big_test_utts"] == big["big_paired"]["n"] == 4


def test_biglex_hard_pipeline(chain):
    _, out, results = chain
    hard = _check(results, "trigram_fusion_eval", "trigram_bigtest", "biglex_hard_pipeline")
    assert hard["pipeline_paired"]["n"] == 4
    assert hard["pipeline_flagship"].endswith("checkpoint")
    with open(out) as f:
        assert json.load(f) == hard
