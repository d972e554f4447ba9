"""The port's quality protocols (aas_enhancement_tpu_torch/quality/) against
the JAX repo's scripts/*.py they port, on the CPU, with every package
function they call replaced by the shared recorder (tests/torch_recorder.py).

Both sides run the same argv on a workdir of the same content: the JAX
script's ``sweep_state.json`` + ``trained_params.pkl`` (networks as tagged
stand-ins, the saved train state's optimizers tagged "saved"), the port's
``sweep_state.json`` + ``checkpoint/config.json`` (``load_state`` and
``utils/checkpoint.py::restore`` stubbed to the same stand-ins); the
corpora are real (the streamed manifests read and write wavs).  The calls
must come in the same order with the same arguments: configurations as
dicts (each training configuration field for field), networks by name (so
every hand-off of weights, the train state's step and whether its
optimizers are fresh or the saved ones), manifests and checkpoint
directories relative to the workdir, seeds, steps, batch sizes, operating
points, beam widths, fusion weights and grids.  The results must be equal
(the same stubs combined the same way; paths under the workdir compared
relative to it, ``wall_minutes`` aside), their keys those ``chip_smoke.py``
holds the card's run to (QUALITY_KEYS), and every file the two sides write
(streamed wavs and manifests, checkpoint configs, results) equal.  Each
module raises without a GPU by default and with ``--device cuda``.
"""

import importlib
import json
import os
import pickle

import pytest
import torch

import chip_smoke
from aas_enhancement_tpu_torch.cli import e2e
from aas_enhancement_tpu_torch.data.synthetic import generate_corpus
from torch_recorder import (FakeJaxState, Recorder, install_jax, install_port, jax_net,
                            load_jax_script, run_jax_script)
from torch_recorder import norm_paths as _norm
from torch_recorder import written_files as _written

MODULES = ("streaming_native_train", "live_pipeline_eval", "hybrid_fusion_eval",
           "am_streaming_finetune", "coadapt_alternate", "streaming_sweep",
           "streaming_finetune_eval")
NO_CK = {"checkpoint_dir"}

# id: (module, QUALITY_KEYS label, keys it lacks, argv ({wd}: the workdir),
#      the train call's state: (step, G, D, AM, optimizers) or None)
CASES = {
    "native_trained": ("streaming_native_train", "streaming_native_train", set(),
                       ["--init", "trained", "--steps", "3", "--batch-size", "4"],
                       (0, "checkpoint.g", "checkpoint.d", "checkpoint.am", "fresh")),
    "native_scratch_no_save": ("streaming_native_train", "streaming_native_train", NO_CK,
                               ["--steps", "2", "--seed", "5", "--chunk", "0.5",
                                "--lookahead", "0.1", "--history", "1.0",
                                "--save-checkpoint", "-"],
                               (0, "init5.g", "init5.d", "checkpoint.am", "fresh")),
    "live": ("live_pipeline_eval", "live_pipeline_eval", set(),
             ["--out", "{wd}/live.json", "--beam-width", "8", "--prune-k", "4",
              "--feed-seconds", "0.25", "--alpha-grid", "0.3,1.5", "--beta-grid", "0.0,1.0",
              "--word-alpha-grid", "0.3,1.0", "--word-beta-grid", "0.0,0.5,1.0"], None),
    "live_checkpoints": ("live_pipeline_eval", "live_pipeline_eval", set(),
                         ["--out", "{wd}/live.json", "--g-checkpoint",
                          "{wd}/ck_g_stream_native", "--am-checkpoint",
                          "{wd}/ck_am_stream_ft", "--order", "3", "--chunk", "0.5",
                          "--lookahead", "0.5", "--history", "1.0", "--feed-seconds", "0.3",
                          "--alpha-grid", "1.0", "--beta-grid", "0.5",
                          "--word-alpha-grid", "0.6", "--word-beta-grid", "0.5"], None),
    "hybrid": ("hybrid_fusion_eval", "hybrid_fusion_eval", set(), ["--out", "{wd}/h.json"],
               None),
    "hybrid_checkpoints": ("hybrid_fusion_eval", "hybrid_fusion_eval", set(),
                           ["--out", "{wd}/h.json", "--g-checkpoint", "{wd}/ck_g_coadapt",
                            "--am-checkpoint", "{wd}/ck_am_offline_ft", "--order", "3",
                            "--beam-width", "4", "--prune-k", "2", "--batch-size", "2"], None),
    "am_ft_streamed": ("am_streaming_finetune", "am_streaming_finetune", set(),
                       ["--steps", "3", "--batch-size", "4", "--distill", "0.5",
                        "--g-checkpoint", "{wd}/ck_stream_ft", "--lr-scale", "0.2"],
                       (0, "ck_stream_ft.g", None, "checkpoint.am", "fresh")),
    "am_ft_offline_am_init": ("am_streaming_finetune", "am_streaming_finetune_offline",
                              set(), ["--offline", "--steps", "2", "--am-init",
                                      "{wd}/ck_am_stream_ft"],
                              (0, "checkpoint.g", None, "ck_am_stream_ft.am", "fresh")),
    "am_ft_no_save": ("am_streaming_finetune", "am_streaming_finetune", NO_CK,
                      ["--steps", "2", "--chunk", "0.5", "--save-checkpoint", "-"],
                      (0, "checkpoint.g", None, "checkpoint.am", "fresh")),
    "coadapt": ("coadapt_alternate", "coadapt_alternate", set(),
                ["--steps", "3", "--batch-size", "4"],
                (0, "checkpoint.g", None, "ck_am_offline_ft.am", "fresh")),
    "coadapt_flags": ("coadapt_alternate", "coadapt_alternate", set(),
                      ["--am-checkpoint", "{wd}/ck_am_stream_ft", "--g-init",
                       "{wd}/ck_g_stream_native", "--lr-scale", "0.3", "--save-checkpoint",
                       "{wd}/g_out"],
                      (0, "ck_g_stream_native.g", None, "ck_am_stream_ft.am", "fresh")),
    "coadapt_no_save": ("coadapt_alternate", "coadapt_alternate", NO_CK,
                        ["--steps", "2", "--save-checkpoint", "-"],
                        (0, "checkpoint.g", None, "ck_am_offline_ft.am", "fresh")),
    "sweep": ("streaming_sweep", "streaming_sweep", set(),
              ["--chunks", "0.5,1.0", "--lookaheads", "0.2", "--histories", "0.5",
               "--batch-size", "2"], None),
    "finetune": ("streaming_finetune_eval", "streaming_finetune_eval", set(),
                 ["--steps", "3", "--batch-size", "4"],
                 (5, "checkpoint.g", "checkpoint.d", "checkpoint.am", "saved")),
    "finetune_no_save": ("streaming_finetune_eval", "streaming_finetune_eval", NO_CK,
                         ["--save-checkpoint", "-", "--lr-scale", "0.25", "--lookahead",
                          "0.5"], (5, "checkpoint.g", "checkpoint.d", "checkpoint.am",
                                   "saved")),
}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("quality_corpora")
    return {split: generate_corpus(str(root / split), n_utts=2, seed=seed, n_words=(2, 3),
                                   snr_range=(0.0, 10.0))
            for split, seed in (("train", 3), ("dev", 4), ("test", 5))}


def _workdirs(tmp_path, corpora):
    """The JAX script's workdir (pickle) and the port's (checkpoint dir), of
    the same content."""
    cfg = e2e.cfg_for("aas", 16, 0.2)
    meta = {"test_noisy": corpora["test"]["noisy"], "test_clean": corpora["test"]["clean"],
            "dev_noisy": corpora["dev"]["noisy"], "train_noisy": corpora["train"]["noisy"],
            "train_clean": corpora["train"]["clean"]}
    jwd, twd = tmp_path / "jax", tmp_path / "port"
    jwd.mkdir()
    (twd / "checkpoint").mkdir(parents=True)
    nets = {f"{k}_params": jax_net(f"checkpoint.{k}") for k in ("g", "d", "am")}
    with open(jwd / "trained_params.pkl", "wb") as f:
        pickle.dump({"cfg_json": cfg.to_json(), "am_params": nets["am_params"],
                     "g_params": nets["g_params"],
                     "state": FakeJaxState(step=5, opt="saved", **nets)}, f)
    with open(jwd / "sweep_state.json", "w") as f:
        json.dump({"params_pkl": str(jwd / "trained_params.pkl"), **meta}, f)
    (twd / "checkpoint" / "config.json").write_text(cfg.to_json())
    with open(twd / "sweep_state.json", "w") as f:
        json.dump({"checkpoint": str(twd / "checkpoint"), **meta}, f)
    return jwd, twd


@pytest.mark.parametrize("case", list(CASES))
def test_protocol_matches_jax_script(case, corpora, tmp_path, monkeypatch, capsys):
    """The same calls, configurations, hand-offs, files and result as the JAX
    script."""
    name, label, lacks, argv, train_state = CASES[case]
    jwd, twd = _workdirs(tmp_path, corpora)
    jrec, trec = Recorder(str(jwd)), Recorder(str(twd))
    with monkeypatch.context() as m:
        install_jax(m, jrec)
        run_jax_script(m, tmp_path, load_jax_script(name),
                       [*(a.format(wd=jwd) for a in argv), "--workdir", str(jwd)])
    capsys.readouterr()
    module = importlib.import_module(f"aas_enhancement_tpu_torch.quality.{name}")
    with monkeypatch.context() as m:
        install_port(m, trec, module)
        port = module.main([*(a.format(wd=twd) for a in argv), "--workdir", str(twd),
                            "--device", "cpu"])
    last = capsys.readouterr().out.splitlines()[-1]
    if name == "streaming_sweep":          # the summary line, the grid in the file
        assert json.loads(last) == {k: v for k, v in port.items() if k != "grid"}
    else:
        assert json.loads(last) == port

    assert trec.calls == jrec.calls
    trains = [c for c in trec.calls if c[0] == "train"]
    if train_state is None:
        assert not trains
    else:
        assert len(trains) == 1 and trains[0][-1] == train_state
    assert set(port) == chip_smoke.QUALITY_KEYS[label] - lacks
    written = _written(twd, {"sweep_state.json", "checkpoint/config.json"})
    assert written == _written(jwd, {"sweep_state.json", "trained_params.pkl"})
    result_files = [k for k in written if k.endswith(".json") and "/" not in k]
    assert len(result_files) == 1
    port = _norm(port, str(twd))
    assert port.pop("wall_minutes", 0) >= 0
    assert written[result_files[0]] == json.loads(json.dumps(port))


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


def test_no_jax_imports():
    """The port's quality modules import neither JAX, the JAX package nor
    scripts/ (read from their sources: this process has JAX loaded)."""
    import ast

    from aas_enhancement_tpu_torch import quality
    root = os.path.dirname(quality.__file__)
    for name in sorted(os.listdir(root)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(root, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "flax", "optax", "aas_enhancement_tpu",
                                                 "scripts"), (name, mod)
