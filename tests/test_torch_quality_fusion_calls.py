"""The port's fusion protocols (quality/trigram_fusion_eval.py,
trigram_bigtest.py, biglex_hard_pipeline.py) against the JAX repo's
scripts of the same names, on the CPU, with the shared recorder
(tests/torch_recorder.py) standing in for the train CLI, ``load_state``,
``evaluate_wer``, ``grid_search_lm`` and the evaluate CLI.

Both sides run the same argv on a workdir that starts the same: empty, but
for the flagship stack as tagged stand-ins (the JAX script's
``trained_params.pkl``, the port's ``checkpoint/config.json`` that its
stubbed ``load_state`` opens).  The corpora, the language, ``fit_arpa``,
the held-out log-p and the export sizes are real.  Each condition chains
the protocols on one workdir and one result file, as the scripts are run:
trigram at 100 words (0-10 dB) then the big test; trigram at 1000 words
and -7...-2 dB, the big test, then the pipeline.  After each protocol:

- the calls come in the same order with the same arguments: the train CLI's
  argv (paths relative to the workdir, the port's ``--device`` aside) and
  its config file field for field, the checkpoint directories, manifests,
  configurations and networks by name, decoders, beam widths, each LM by
  its file and order, fusion weights, ``per_utt``; the evaluate CLI's argv;
- every file both sides wrote is equal: corpora, ``config.json``, both
  ARPA files byte for byte, the result file (``wall_minutes`` and
  ``pipeline_wall_minutes`` aside);
- the result is equal to the JAX script's, its keys those ``chip_smoke.py``
  holds the card's run to (FUSION_KEYS), and what the port prints is what
  the script prints.

Each module raises without a GPU by default and with ``--device cuda``.
"""

import contextlib
import importlib
import io
import json
import os
import pickle

import pytest
import torch

import chip_smoke
from aas_enhancement_tpu_torch.cli import e2e
from torch_recorder import (Recorder, install_jax, install_port, jax_net, load_jax_script,
                            norm_paths, run_jax_script, written_files)

MODULES = ("trigram_fusion_eval", "trigram_bigtest", "biglex_hard_pipeline")
WALLS = ("wall_minutes", "pipeline_wall_minutes")
SMALL = ["--n-utts", "3", "--n-dev-utts", "2", "--n-test-utts", "2", "--am-steps", "4",
         "--batch-size", "2", "--lm-sentences", "200"]
# condition: [(module, argv; {wd} the workdir, {result} the result file)]
CHAINS = {
    "100_words": [
        ("trigram_fusion_eval", [*SMALL, "--out", "{result}"]),
        ("trigram_bigtest", ["--n-utts", "3", "--seed", "11", "--beam-width", "8",
                             "--result", "{result}"])],
    "1000_words_hard": [
        ("trigram_fusion_eval", [*SMALL, "--lexicon-size", "1000", "--snr-low", "-7",
                                 "--snr-high", "-2", "--beam-width", "16", "--tri-classes",
                                 "2", "--out", "{result}"]),
        ("trigram_bigtest", ["--n-utts", "2", "--result", "{result}"]),
        ("biglex_hard_pipeline", ["--batch-size", "4", "--beam-width", "8",
                                  "--result", "{result}"])],
}
STEPS = [(c, i) for c, chain in CHAINS.items() for i in range(len(chain))]


def _flagships(jwd, twd) -> tuple[str, str]:
    """The flagship stack on either side, of the same content."""
    cfg = e2e.cfg_for("aas", 16, 0.2)
    os.makedirs(jwd)
    os.makedirs(os.path.join(twd, "checkpoint"))
    pkl = os.path.join(jwd, "trained_params.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"cfg_json": cfg.to_json(), "am_params": jax_net("checkpoint.am"),
                     "g_params": jax_net("checkpoint.g")}, f)
    with open(os.path.join(twd, "checkpoint", "config.json"), "w") as f:
        f.write(cfg.to_json())
    return pkl, os.path.join(twd, "checkpoint")


def _stdout(out: str, wd: str) -> list:
    """The printed JSON lines, walls aside, the workdir's path written WD."""
    lines = []
    for line in out.splitlines():
        obj = json.loads(line) if line.startswith("{") else line
        if isinstance(obj, dict):
            for key in (*WALLS, "pipeline_flagship"):
                obj.pop(key, None)
        lines.append(norm_paths(obj, wd))
    return lines


def _run_both(root, condition: str) -> list:
    """The chain on either side -> one entry a protocol: {side: (its calls,
    its stdout, its result, the files under the workdir)}."""
    jwd, twd = str(root / "jax"), str(root / "port")
    flagship = dict(zip(("jax", "port"), _flagships(jwd, twd)))
    recs = {"jax": Recorder(jwd), "port": Recorder(twd)}
    steps = [{} for _ in CHAINS[condition]]
    mp = pytest.MonkeyPatch()
    try:
        for side, wd in (("jax", jwd), ("port", twd)):
            rec = recs[side]
            for i, (name, argv) in enumerate(CHAINS[condition]):
                argv = [a.format(wd=wd, result=os.path.join(wd, "result.json"))
                        for a in argv] + ["--workdir", wd]
                if name == "biglex_hard_pipeline":
                    argv += ["--flagship", flagship[side]]
                n_calls = len(rec.calls)
                buf = io.StringIO()
                with mp.context() as m, contextlib.redirect_stdout(buf):
                    if side == "jax":
                        install_jax(m, rec)
                        run_jax_script(m, root, load_jax_script(name), argv)
                        result = None
                    else:
                        module = importlib.import_module(
                            f"aas_enhancement_tpu_torch.quality.{name}")
                        install_port(m, rec, module)
                        result = module.main([*argv, "--device", "cpu"])
                with open(os.path.join(wd, "result.json")) as f:
                    saved = json.load(f)
                steps[i][side] = (rec.calls[n_calls:], _stdout(buf.getvalue(), wd),
                                  result if result is not None else saved,
                                  written_files(wd, {"trained_params.pkl",
                                                     "checkpoint/config.json"},
                                                (*WALLS, "pipeline_flagship")))
    finally:
        mp.undo()
    return steps


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    cache = {}

    def get(condition):
        if condition not in cache:
            cache[condition] = _run_both(tmp_path_factory.mktemp(condition), condition)
        return cache[condition]
    return get


@pytest.mark.parametrize("condition, step", STEPS,
                         ids=[f"{c}-{CHAINS[c][i][0]}" for c, i in STEPS])
def test_protocol_matches_jax_script(condition, step, chains):
    """The same calls, files, prints and result as the JAX script."""
    name = CHAINS[condition][step][0]
    jax_calls, jax_out, jax_result, jax_files = chains(condition)[step]["jax"]
    calls, out, result, files = chains(condition)[step]["port"]
    assert calls == jax_calls
    assert out == jax_out
    assert files == jax_files
    assert set(result) == chip_smoke.fusion_keys(*(n for n, _ in CHAINS[condition][:step + 1]))
    for key in WALLS:
        assert result.pop(key, 0) >= 0
        jax_result.pop(key, None)
    if name == "biglex_hard_pipeline":
        assert result.pop("pipeline_flagship").endswith(os.path.join("port", "checkpoint"))
        assert jax_result.pop("pipeline_flagship").endswith("trained_params.pkl")
    assert result == jax_result

    kinds = [c[0] for c in calls]
    if name == "trigram_fusion_eval":
        assert kinds == ["cli.train", "load_state", "evaluate_wer", "evaluate_wer",
                         "grid_search_lm", "evaluate_wer", "grid_search_lm", "evaluate_wer",
                         "cli.evaluate"]
        assert calls[0][1][:2] == ["--objective", "am"] and calls[1][1] == "ckpt_am"
        assert [c[4] for c in calls if c[0] == "grid_search_lm"] == [
            "word2.arpa (order 2)", "word3.arpa (order 3)"]
        assert [c[7] for c in calls if c[0] == "grid_search_lm"] == [16, 16]
        assert all(b"\\data\\" in files[f"word{n}.arpa"] for n in (2, 3))
        assert result["heldout_logp_per_word_tri"] != result["heldout_logp_per_word_bi"]
        assert json.loads(result["cli_evaluate_word_lm_tri"])["noisy"]["utterances"] == 9
    elif name == "trigram_bigtest":
        assert kinds == ["load_state", "evaluate_wer", "evaluate_wer"]
        assert [c[-1] for c in calls[1:]] == [True, True]             # per_utt
        assert result["big_paired"]["n"] == 5
    else:
        assert kinds == ["load_workdir", "evaluate_wer", "evaluate_wer", "grid_search_lm",
                         "evaluate_wer", "grid_search_lm", "evaluate_wer"]
        assert [c[4] for c in calls if c[0] == "evaluate_wer"] == [None, *["checkpoint.g"] * 3]
        assert [c[5] for c in calls if c[0] == "grid_search_lm"] == ["checkpoint.g"] * 2
        assert result["pipeline_paired"]["n"] == 5


@pytest.mark.parametrize("explicit", [False, True], ids=["default", "cuda"])
@pytest.mark.parametrize("name", MODULES)
def test_without_gpu_raises(name, explicit, tmp_path, monkeypatch):
    """On the card by default; without a GPU that raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"aas_enhancement_tpu_torch.quality.{name}")
    argv = ["--workdir", str(tmp_path / "none")] + (["--device", "cuda"] if explicit else [])
    args = module.parse_args(argv)
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.run(args)
    assert not os.path.exists(tmp_path / "none")


def test_biglex_refuses_a_pickle(tmp_path):
    """--flagship takes cli.e2e's checkpoint directory, not the JAX pickle."""
    from aas_enhancement_tpu_torch.quality import biglex_hard_pipeline
    args = biglex_hard_pipeline.parse_args(
        ["--flagship", str(tmp_path / "trained_params.pkl"), "--device", "cpu"])
    with pytest.raises(ValueError, match="checkpoint directory"):
        biglex_hard_pipeline.run(args)


def test_output_paths_are_the_ports():
    """The defaults never name the JAX results kept in the repo."""
    from aas_enhancement_tpu_torch.quality import (biglex_hard_pipeline, trigram_bigtest,
                                                   trigram_fusion_eval)
    assert trigram_fusion_eval.parse_args([]).out == "trigram_fusion_torch.json"
    assert trigram_bigtest.parse_args([]).result == "trigram_fusion_torch.json"
    hard = biglex_hard_pipeline.parse_args([])
    assert hard.result == "biglex_hard_fusion_torch.json"
    assert hard.flagship.endswith(os.path.join("aas_e2e_full_hard", "checkpoint"))
