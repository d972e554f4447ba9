"""The port's entry point and packaging: the enhance CLI on a synthetic corpus
(CPU), the host-side config and data modules against the JAX package's, the
no-JAX import rule, device errors, and the kernel build."""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aas_enhancement_tpu.config import AudioConfig, Config, EnhancerConfig
from aas_enhancement_tpu.data.synthetic import generate_corpus
from aas_enhancement_tpu.data.wav import read_wav
from aas_enhancement_tpu_torch import config as tconfig
from aas_enhancement_tpu_torch import data as tdata
from aas_enhancement_tpu_torch.cli import enhance as cli
from aas_enhancement_tpu_torch.utils import kernel_build, profiling, rnn_bench

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small_config(path):
    cfg = Config().replace(enhancer=EnhancerConfig(conv_channels=8, rnn_hidden=16))
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return str(path)


def test_cli_enhances_a_corpus_on_cpu(tmp_path, capsys):
    manifests = generate_corpus(str(tmp_path / "corpus"), n_utts=2, seed=3)
    out_dir = tmp_path / "out"
    cli.main(["--manifest", manifests["noisy"], "--out-dir", str(out_dir),
              "--config", _small_config(tmp_path / "cfg.json"), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["utterances"] == 2 and line["rtf"] > 0
    for name in ("utt0000.wav", "utt0001.wav"):
        x, _ = read_wav(str(tmp_path / "corpus" / "noisy" / name))
        y, sr = read_wav(str(out_dir / name))
        assert sr == 16000 and len(y) == len(x) and np.all(np.isfinite(y))
    assert abs(line["audio_seconds"] - sum(
        len(read_wav(str(out_dir / n))[0]) for n in os.listdir(out_dir)) / 16000) < 1e-3


def test_config_reads_a_jax_config_json():
    cfg = Config().replace(
        audio=AudioConfig(window="hamming", center=False, normalize=False),
        enhancer=EnhancerConfig(conv_channels=8, rnn_hidden=16, mode="mapping"))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=7))
    got = tconfig.Config.from_json(cfg.to_json())
    for section in ("audio", "enhancer"):
        ported = dataclasses.asdict(getattr(got, section))
        assert ported == {k: v for k, v in dataclasses.asdict(getattr(cfg, section)).items()
                          if k in ported}, section
    assert got.train.seed == 7
    assert (got.audio.n_fft, got.audio.hop_length, got.audio.num_bins) == (320, 160, 161)
    assert tconfig.Config.from_json(got.to_json()) == got


def _jax_fields_the_port_lacks():
    """{section: {field: JAX default}} read from the two packages' dataclasses."""
    ported = {f.name: {g.name for g in dataclasses.fields(f.default_factory)}
              for f in dataclasses.fields(tconfig.Config)}
    lacking = {}
    for f in dataclasses.fields(Config):
        for g in dataclasses.fields(f.default_factory):
            if g.name not in ported.get(f.name, ()):
                lacking.setdefault(f.name, {})[g.name] = getattr(f.default_factory(), g.name)
    return lacking


def test_config_fields_the_port_lacks_are_an_explicit_list():
    """Every field of the JAX config that the port's dataclasses lack stands
    in the port's ``UNPORTED`` table with the JAX default and the ROADMAP item
    that ports its consumer: dropping a field is a decision, never silent."""
    listed = {s: {k: default for k, (default, _) in v.items()}
              for s, v in tconfig.UNPORTED.items()}
    assert listed == _jax_fields_the_port_lacks()
    items = {item for v in tconfig.UNPORTED.values() for _, item in v.values()}
    assert items == {"A12", "A15"}
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    for item in items:
        assert f"**{item}" in roadmap or f"{item}." in roadmap, item


# Train fields that stood in UNPORTED until checkpoints, validation, prefetch
# and profiling were ported (ROADMAP A9a, A9b), the paired objective's
# MR-STFT weight (A8) and streaming fine-tuning's operating point (A11):
# they now load at any value.
PORTED_TRAIN_FIELDS = ("checkpoint_dir", "checkpoint_every", "eval_every",
                       "eval_batch_size", "prefetch", "profile_start", "profile_steps",
                       "lambda_mrstft", "stream_chunk_s", "stream_lookahead_s",
                       "stream_history_s")


@pytest.mark.parametrize("section,name", [(s, k) for s, v in tconfig.UNPORTED.items()
                                          for k in v]
                         + [("train", k) for k in PORTED_TRAIN_FIELDS])
def test_config_refuses_a_non_default_value_of_an_unported_field(section, name):
    """A JAX config JSON with such a field off its default raises, naming the
    field and the ROADMAP item; the same JSON with the default loads.  A
    field ported since loads off its default into the port's dataclass."""
    d = json.loads(Config().to_json())
    if name in PORTED_TRAIN_FIELDS:
        assert name not in tconfig.UNPORTED.get(section, {})
        d[section][name] = d[section][name] + "x" if name == "checkpoint_dir" \
            else d[section][name] + 1
        assert getattr(tconfig.Config.from_dict(d).train, name) == d[section][name]
        return
    default, item = tconfig.UNPORTED[section][name]
    assert d[section][name] == default and tconfig.Config.from_dict(d) == tconfig.Config()
    d[section][name] = default + "x" if isinstance(default, str) else default + 1
    with pytest.raises(NotImplementedError, match=rf"{section}\.{name} .*ROADMAP {item}\b"):
        tconfig.Config.from_dict(d)


def test_config_defaults_match_jax():
    got, ref = tconfig.Config(), Config()
    for section in ("audio", "enhancer", "train"):
        for k, v in dataclasses.asdict(getattr(got, section)).items():
            assert v == getattr(getattr(ref, section), k), (section, k)


def test_synthetic_corpus_matches_jax(tmp_path):
    """The port's corpus is the JAX package's plain-mode corpus, file for file."""
    ref = generate_corpus(str(tmp_path / "jax"), n_utts=4, seed=5, word_len=(2, 6))
    got = tdata.generate_corpus(str(tmp_path / "torch"), n_utts=4, seed=5)
    for kind in ("clean", "noisy"):
        ref_rows, got_rows = tdata.read_manifest(ref[kind]), tdata.read_manifest(got[kind])
        assert len(got_rows) == len(ref_rows) == 4
        for (rw, rt), (gw, gt) in zip(ref_rows, got_rows):
            assert os.path.basename(gw) == os.path.basename(rw)
            assert open(gw, "rb").read() == open(rw, "rb").read()
            assert open(gt).read() == open(rt).read()


def test_wav_io_matches_jax(tmp_path):
    x = np.sin(np.arange(1000) / 7.0).astype(np.float32) * 1.2    # clips at 1
    path = str(tmp_path / "a.wav")
    tdata.write_wav(path, x, 8000)
    got, sr = tdata.read_wav(path)
    ref, ref_sr = read_wav(path)
    assert sr == ref_sr == 8000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    # PCM16 writes x * 32767 rounded and reads q / 32768: 1.5 LSB at most.
    np.testing.assert_allclose(got, np.clip(x, -1, 1), rtol=0, atol=1.5 / 32768)


def test_package_and_cli_import_no_jax():
    code = ("import sys, pkgutil, importlib, aas_enhancement_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import aas_enhancement_tpu_torch.cli.enhance\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'aas_enhancement_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _port_sources():
    pkg = os.path.join(REPO, "aas_enhancement_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_no_source_of_the_port_imports_jax():
    """Every import statement (top-level or inside a function) of every file
    of the port and of chip_smoke.py, read from the syntax tree."""
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "aas_enhancement_tpu"}
    paths = _port_sources()
    assert len(paths) > 40 and any(p.endswith("conv_dw.py") for p in paths)
    bad = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} imports {n}"
                    for n in names if n.split(".")[0] in banned]
    assert not bad, bad


@pytest.mark.parametrize("module,argv", [
    ("enhance", ["--input", "x.wav", "--out-dir", "out"]),
    ("evaluate", ["--manifest", "m.csv", "--am-checkpoint", "seed:0"]),
    ("train", ["--objective", "am", "--noisy-manifest", "m.csv"])])
def test_every_cli_defaults_to_the_card(module, argv, monkeypatch):
    """Without --device each entry point asks for the GPU, and without one it
    raises instead of running on the CPU."""
    import importlib
    mod = importlib.import_module(f"aas_enhancement_tpu_torch.cli.{module}")
    with open(mod.__file__) as f:
        assert 'add_argument("--device", default="cuda"' in f.read()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


def test_cuda_device_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--input", "x.wav", "--out-dir", str(tmp_path), "--device", "cuda"])


@pytest.mark.parametrize("flag", [["--checkpoint", "ckpt"], ["--streaming"]])
def test_unported_options_raise(tmp_path, flag, monkeypatch):
    """Both options are ported.  --checkpoint: a directory without
    config.json raises as the JAX CLI's load_state does.  --streaming (ROADMAP
    A11): each wav goes through ``enhance_stream`` with the chunk, lookahead
    and history flags, on the device asked for."""
    argv = ["--input", "x.wav", "--out-dir", str(tmp_path), "--device", "cpu"]
    if flag[0] == "--checkpoint":
        with pytest.raises(FileNotFoundError, match="no config.json"):
            cli.main([*argv, "--checkpoint", str(tmp_path / flag[1])])
        return
    seen = []

    def fake_stream(cfg, model, wav, *args, **kw):
        seen.append((len(wav), args, kw))
        yield wav

    x = (0.1 * np.random.default_rng(0).standard_normal(4000)).astype(np.float32)
    tdata.write_wav(str(tmp_path / "x.wav"), x, 16000)
    monkeypatch.setattr(cli, "enhance_stream", fake_stream)
    argv[1] = str(tmp_path / "x.wav")
    argv[3] = str(tmp_path / "out")
    cli.main([*argv, "--config", _small_config(tmp_path / "cfg.json"), *flag,
              "--chunk-seconds", "0.5", "--lookahead-seconds", "0.3",
              "--history-seconds", "0.4"])
    assert seen == [(4000, (0.5, 0.3, 0.4), {"device": torch.device("cpu")})]
    assert os.path.exists(tmp_path / "out" / "x.wav")


def test_streaming_cli_matches_jax(tmp_path, capsys, monkeypatch):
    """``cli.enhance --streaming`` of both packages on 2 synthetic utterances
    (random-init enhancers from the same seed do not agree across packages,
    so both read one converted checkpoint): the same wavs to the PCM16 step
    on unit-scale audio."""
    import importlib.util

    import jax
    from aas_enhancement_tpu.cli import enhance as jax_cli
    from aas_enhancement_tpu.train.loop import init_state as jax_init_state
    from aas_enhancement_tpu.utils import checkpoint as jckpt
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(REPO, "scripts", "orbax_to_torch.py"))
    orbax_to_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(orbax_to_torch)

    monkeypatch.setattr("aas_enhancement_tpu.utils.jax_cache.enable", lambda *a: None)
    cfg = Config().replace(enhancer=EnhancerConfig(conv_channels=8, conv_layers=1,
                                                   rnn_hidden=16, rnn_layers=1))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, objective="paired"))
    src, dst = str(tmp_path / "jax"), str(tmp_path / "torch")
    mgr = jckpt.make_manager(src)
    jckpt.save(mgr, 1, jax.device_get(jax_init_state(cfg, jax.random.key(3))))
    mgr.wait_until_finished()
    mgr.close()
    with open(os.path.join(src, "config.json"), "w") as f:
        f.write(cfg.to_json())
    orbax_to_torch.convert(src, dst)
    corpus = generate_corpus(str(tmp_path / "corpus"), n_utts=2, seed=5)
    flags = ["--streaming", "--chunk-seconds", "0.5", "--lookahead-seconds", "0.1",
             "--history-seconds", "0.5"]
    jax_cli.main(["--manifest", corpus["noisy"], "--out-dir", str(tmp_path / "j"),
                  "--checkpoint", src, *flags])
    cli.main(["--manifest", corpus["noisy"], "--out-dir", str(tmp_path / "t"),
              "--checkpoint", dst, "--device", "cpu", *flags])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["utterances"] == 2
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 2
    for name in names:
        ref, _ = read_wav(str(tmp_path / "j" / name))
        got, _ = read_wav(str(tmp_path / "t" / name))
        noisy, _ = read_wav(str(tmp_path / "corpus" / "noisy" / name))
        assert got.shape == ref.shape == noisy.shape
        assert np.abs(got - ref).max() <= 1.0 / 32767 + 1e-7, name


@pytest.mark.parametrize("objective,flag", [("aas", "--streaming-finetune"),
                                            ("am", "--streaming-finetune-am")])
def test_train_cli_streaming_finetune_on_cpu(tmp_path, capsys, objective, flag):
    """One step of each streaming fine-tuning objective through the train CLI
    on the CPU, at a small width and a 0.2 / 0.05 / 0.1 s operating point."""
    from aas_enhancement_tpu.config import (AMConfig, DataConfig, DiscriminatorConfig,
                                            TrainConfig)
    corpus = generate_corpus(str(tmp_path / "corpus"), n_utts=2, seed=2, vocab_chars=6)
    cfg = Config(am=AMConfig(rnn_hidden=16, rnn_layers=1, conv_channels=8),
                 enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=12,
                                         rnn_layers=1),
                 discriminator=DiscriminatorConfig(channels=(8, 16)),
                 train=TrainConfig(batch_size=2, log_every=1), data=DataConfig(num_buckets=1))
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    from aas_enhancement_tpu_torch.cli import train as train_cli
    argv = ["--objective", objective, "--steps", "1", "--config", str(path),
            "--am-checkpoint", "seed:0", "--device", "cpu", flag, "--stream-chunk", "0.2",
            "--stream-lookahead", "0.05", "--stream-history", "0.1"]
    if objective == "am":
        argv += ["--noisy-manifest", corpus["clean"]]
    else:
        argv += ["--noisy-manifest", corpus["noisy"], "--clean-manifest", corpus["clean"]]
    train_cli.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["final_step"] == 1
    assert ("loss_ctc_am" if objective == "am" else "loss_g") in line
    assert all(np.isfinite(v) for v in line.values())


def test_bucket_lengths():
    buckets = [32000, 64000, 128000, 256000]
    assert cli._bucket_length(100, buckets) == 32000
    assert cli._bucket_length(64000, buckets) == 64000
    assert cli._bucket_length(256001, buckets) == 512000


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "a.cu").write_text("int x;\n")
    first = kernel_build.library_path()
    assert first == kernel_build.library_path()
    (tmp_path / "a.cu").write_text("int y;\n")
    assert kernel_build.library_path() != first


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernel_build, "find_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernel_build.build()
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".so")]


def test_every_entry_point_has_a_source():
    text = "".join(open(p).read() for p in kernel_build.sources())
    for name in kernel_build.SIGNATURES:
        assert f'extern "C" int {name}(' in text, name


def test_kernel_routing_and_input_checks():
    from aas_enhancement_tpu_torch.ops.dispatch import check_kernel_inputs, uses_kernel
    assert uses_kernel("k", torch.zeros(1)) is False
    with pytest.raises(ValueError, match="no implementation"):
        uses_kernel("k", torch.zeros(1, device="meta"))
    with pytest.raises(TypeError, match="float32"):
        check_kernel_inputs("k", (torch.zeros(2, dtype=torch.float64),))
    with pytest.raises(ValueError, match="inputs on"):
        check_kernel_inputs("k", (torch.zeros(2), torch.zeros(2, device="meta")))
    check_kernel_inputs("k", (torch.zeros(2), torch.zeros(2, requires_grad=True)))


def test_trace_summary_merges_device_intervals():
    ev = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 10},    # overlaps a
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "cpu_op", "name": "host", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 50, "dur": 30}]
    s = profiling.summarize_trace({"traceEvents": ev}, calls=2)
    assert s["busy_ms"] == pytest.approx((15 + 20 + 30) / 1e3 / 2)
    assert s["span_ms"] == pytest.approx(80 / 1e3 / 2)
    assert s["idle_share"] == pytest.approx(1 - 65 / 80)
    assert s["events"] == 2.0
    assert s["by_name"][0] == ("a", pytest.approx(0.02), 1.0)
    with pytest.raises(RuntimeError, match="no device events"):
        profiling.summarize_trace({"traceEvents": ev[3:4]})


@pytest.mark.parametrize("dropped", [False, True])
def test_device_time_reads_no_session_that_dropped_events(monkeypatch, dropped):
    """A profiler session in which a kernel did not run the same number of
    times in each call (here 4 of 5 calls: 0.8 a call) or that recorded no
    device event is not read; after two such sessions the time comes from
    CUDA events around the call that launches only the kernel to time."""
    bad = [{"busy_ms": 0.9, "by_name": [("void k<1>()", 0.8, 0.8), ("copy", 0.1, 1.0)]},
           RuntimeError("the trace holds no device events")]
    good = {"busy_ms": 1.1, "by_name": [("void k<1>()", 1.0, 1.0), ("copy", 0.1, 2.0)]}
    sessions = iter(bad if dropped else [bad[0], good])

    def profile_call(*_):
        s = next(sessions)
        if isinstance(s, Exception):
            raise s
        return s

    class Event:
        def __init__(self, **_):
            pass

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, _):
            return 1.25

    monkeypatch.setattr(profiling, "profile_call", profile_call)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    alone = []
    got = profiling.device_time(lambda: None, "k<1>", alone=lambda: alone.append(1))
    if dropped:
        assert got == (1.25, "events on a busy stream") and len(alone) == 6
    else:
        assert got == (1.0, "profiler") and not alone


@pytest.mark.parametrize("setup,want", [
    ("calls = []", []),
    ("import aas_enhancement_tpu_torch.ops.cuda.gn\nraise SystemExit('setup failed')",
     RuntimeError)])
def test_kernel_names_in_fresh_process(setup, want):
    """The child imports the package from this checkout and returns one entry
    per call; a setup that fails raises with the child's stderr."""
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="setup failed"):
            profiling.kernel_names_in_fresh_process(setup, timeout=120)
    else:
        assert profiling.kernel_names_in_fresh_process(setup, timeout=120) == want


def test_profiler_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.main(["--batch", "1", "--seconds", "0.1"])


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_bench_needs_a_gpu(monkeypatch, cell, backward):
    """The timing script measures on the card or raises, forward and
    backward: no CPU numbers."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rnn_bench.main(["--cell", cell, "--hidden", "16", "--frames", "3", "--batch", "1"]
                       + ["--backward"] * backward)
