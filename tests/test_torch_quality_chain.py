"""The quality protocols chained for real on the CPU, on a ``cli.e2e``
workdir: ``cli.e2e`` (8 / 4 / 4 utterances, 2 AM and 2 AAS steps, batch 4)
-> ``streaming_native_train --init trained`` -> ``live_pipeline_eval
--g-checkpoint`` on its G -> ``hybrid_fusion_eval`` on it; and
``am_streaming_finetune --offline`` -> ``coadapt_alternate`` on that AM ->
``hybrid_fusion_eval --g-checkpoint --am-checkpoint`` on the pair, beside
the streamed adaptation, the sweep and the short fine-tune.  The networks
are the protocol's cut to small widths (AM 2 x BiGRU-16, 8 channels;
enhancer 1 conv layer, 1 x BiLSTM-12; discriminator (8, 16)) through
``cli.e2e.cfg_for``, so that the whole chain runs in well under a minute;
the protocols read every width from the workdir's checkpoint.

Each result has exactly the keys of the JAX script's (``chip_smoke.py``'s
QUALITY_KEYS, which tests/test_torch_quality_calls.py holds to the scripts)
with finite numbers; every checkpoint opens under ``load_state`` with its
objective, step and the networks the next protocol takes; the two G
checkpoints serve through ``cli.serve --streaming-checkpoint`` as the
streaming weights at their operating point.
"""

import json
import math
import os

import pytest
import torch

import chip_smoke
from aas_enhancement_tpu_torch.cli import e2e
from aas_enhancement_tpu_torch.cli import serve as serve_cli
from aas_enhancement_tpu_torch.quality import (am_streaming_finetune, coadapt_alternate,
                                               hybrid_fusion_eval, live_pipeline_eval,
                                               streaming_finetune_eval,
                                               streaming_native_train, streaming_sweep)
from aas_enhancement_tpu_torch.train.loop import load_state
from torch_recorder import small_e2e_config as _small

torch.set_num_threads(1)

E2E = ["--n-utts", "8", "--n-dev-utts", "4", "--n-test-utts", "4", "--am-steps", "2",
       "--aas-steps", "2", "--batch-size", "4", "--device", "cpu"]
GRIDS = ["--alpha-grid", "0.6", "--beta-grid", "0.5", "--word-alpha-grid", "0.3",
         "--word-beta-grid", "0.0"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("quality_chain") / "wd"
    mp = pytest.MonkeyPatch()
    mp.setattr(e2e, "cfg_for", _small)
    try:
        e2e.run(e2e.parse_args([*E2E, "--workdir", str(wd), "--skip-streaming"]))
    finally:
        mp.undo()
    return str(wd)


def _run(module, label: str, wd: str, *argv: str) -> dict:
    result = module.run(module.parse_args([*argv, "--workdir", wd, "--device", "cpu"]))
    assert set(result) == chip_smoke.QUALITY_KEYS[label], label
    bad = [k for k, v in chip_smoke._numbers(result) if not math.isfinite(v)]
    assert not bad, (label, bad)
    return result


def _opens(ck: str, objective: str, step: int, nets: tuple) -> None:
    state, cfg = load_state(ck, "cpu")
    assert (cfg.train.objective, state.step) == (objective, step), ck
    for name in nets:
        assert getattr(state, name) is not None, (ck, name)


def _serves(wd: str, ck: str, point) -> None:
    chunk, lookahead, history = (str(x) for x in point)
    server, line = serve_cli.start_server(
        ["--checkpoint", os.path.join(wd, "checkpoint"), "--streaming-checkpoint", ck,
         "--transcribe", "--weights", "streaming", "--port", "0", "--max-streams", "1",
         "--chunk", chunk, "--lookahead", lookahead, "--history", history, "--device", "cpu"])
    server.stop()
    assert line["weights"] == "streaming", line


def test_native_live_hybrid(workdir):
    wd = workdir
    native = _run(streaming_native_train, "streaming_native_train", wd, "--init", "trained",
                  "--steps", "2", "--batch-size", "4")
    ck = native["checkpoint_dir"]
    assert ck == os.path.join(wd, "ck_g_stream_native")
    _opens(ck, "aas", 2, ("g", "d", "am"))
    _serves(wd, ck, (1.0, 0.5, 0.5))
    with open(os.path.join(wd, "streaming_native_train.json")) as f:
        assert json.load(f) == native
    live = _run(live_pipeline_eval, "live_pipeline_eval", wd, "--g-checkpoint", ck,
                "--lookahead", "0.5", "--out", os.path.join(wd, "live.json"), *GRIDS)
    assert live["utterances"] == 4 and live["g_checkpoint"] == ck
    assert live["live_hybrid_test"] >= 0.0 and live["latency_s"] == 1.5
    hybrid = _run(hybrid_fusion_eval, "hybrid_fusion_eval", wd, "--g-checkpoint", ck)
    assert hybrid["utterances_test"] == 4


def test_am_coadapt_hybrid_sweep_finetune(workdir):
    wd = workdir
    streamed = _run(am_streaming_finetune, "am_streaming_finetune", wd, "--steps", "2",
                    "--batch-size", "4", "--distill", "0.5")
    _opens(streamed["checkpoint_dir"], "am", 2, ("am", "g"))
    offline = _run(am_streaming_finetune, "am_streaming_finetune_offline", wd, "--steps", "2",
                   "--batch-size", "4", "--offline")
    am_ck = offline["checkpoint_dir"]
    assert am_ck == os.path.join(wd, "ck_am_offline_ft")
    _opens(am_ck, "am", 2, ("am", "g"))
    coadapt = _run(coadapt_alternate, "coadapt_alternate", wd, "--steps", "2",
                   "--batch-size", "4")
    assert coadapt["am_checkpoint"] == am_ck
    g_ck = coadapt["checkpoint_dir"]
    _opens(g_ck, "acoustic", 2, ("g", "am"))
    _run(hybrid_fusion_eval, "hybrid_fusion_eval", wd, "--g-checkpoint", g_ck,
         "--am-checkpoint", am_ck)
    sweep = _run(streaming_sweep, "streaming_sweep", wd, "--chunks", "1.0", "--lookaheads",
                 "0.2", "--histories", "0.5,1.0")
    assert [r["history_s"] for r in sweep["grid"]] == [0.5, 1.0]
    ft = _run(streaming_finetune_eval, "streaming_finetune_eval", wd, "--steps", "2",
              "--batch-size", "4")
    _opens(ft["checkpoint_dir"], "aas", 2 + 2, ("g", "d", "am"))
    _serves(wd, ft["checkpoint_dir"], (1.0, 0.2, 1.0))
