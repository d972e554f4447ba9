"""Port parity: the live server (aas_enhancement_tpu_torch.serve) and the serve
CLI (.cli.serve) against the JAX package, on the CPU.

Small widths as ``tests/test_serve.py`` (one conv layer of 8 channels,
BiLSTM-16; AM BiGRU-16), weights carried across from the flax parameters by
``convert.py``.  Tolerances:
- a session's audio against the port's single-stream ``StreamingEnhancer``:
  2e-5 absolute, the JAX serve test's limit (the server batches its slots
  into one call, the reference runs one row: the products' sums may part in
  the last bits);
- against the JAX ``StreamingEnhancer``: 1e-5 absolute,
  ``test_torch_streaming.py``'s whole-stream limit (the two frameworks' f32
  sums over up to ~36,000 cells);
- transcripts equal.
Every socket has a timeout and every join a limit: a hung server fails a
test instead of holding the suite.
"""

import dataclasses
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.cli import serve as jax_cli
from aas_enhancement_tpu.config import AMConfig, Config, EnhancerConfig
from aas_enhancement_tpu.data.synthetic import synth_utterance
from aas_enhancement_tpu.models.am import AcousticModel as JaxAM
from aas_enhancement_tpu.models.enhancer import Enhancer as JaxEnhancer
from aas_enhancement_tpu.streaming import StreamingEnhancer as JaxStreaming
from aas_enhancement_tpu.streaming_asr import StreamingRecognizer as JaxRecognizer
from aas_enhancement_tpu_torch import streaming as tstreaming
from aas_enhancement_tpu_torch.cli import serve as cli
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.convert import am_params_from_flax, enhancer_params_from_flax
from aas_enhancement_tpu_torch.models.am import AcousticModel
from aas_enhancement_tpu_torch.models.enhancer import Enhancer
from aas_enhancement_tpu_torch.serve import (EnhanceServer, enhance_via_server, recv_frame,
                                             send_frame, transcribe_via_server)
from aas_enhancement_tpu_torch.streaming import StreamingEnhancer
from aas_enhancement_tpu_torch.streaming_asr import StreamingRecognizer
from aas_enhancement_tpu_torch.train.loop import init_state
from aas_enhancement_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

KW = dict(chunk_seconds=0.25, lookahead_seconds=0.05, history_seconds=0.25)
ASR_KW = dict(chunk_seconds=0.5, lookahead_seconds=0.2, history_seconds=0.5)
CFG = Config(enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=16,
                                     rnn_layers=1),
             am=AMConfig(rnn_hidden=16, rnn_layers=1, conv_channels=8))
TCFG = TConfig.from_json(CFG.to_json())
F_BINS = 161
SERVER_ATOL = 2e-5
JAX_ATOL = 1e-5
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def nets():
    """(flax enhancer params, flax AM params, torch enhancer, torch AM)."""
    x = jnp.zeros((1, 64, F_BINS), jnp.float32)
    n = jnp.array([64], jnp.int32)
    g_p = JaxEnhancer(CFG.enhancer).init(jax.random.key(0), x, n)
    am_p = JaxAM(CFG.am).init(jax.random.key(2), x, n)
    g = Enhancer(TCFG.enhancer, F_BINS)
    g.load_state_dict(enhancer_params_from_flax(g_p))
    am = AcousticModel(TCFG.am, F_BINS)
    am.load_state_dict(am_params_from_flax(am_p))
    return g_p, am_p, g.eval(), am.eval()


def _in_threads(fn, n: int) -> list:
    """Run fn(i) for i < n in threads, each joined with a limit."""
    results = [None] * n

    def run(i):
        results[i] = fn(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive(), "a client did not finish"
    return results


def _port_reference(model, wav):
    eng = StreamingEnhancer(TCFG, model, device="cpu", **KW)
    return np.concatenate([eng.feed(wav), eng.flush()])


def test_concurrent_clients_match_single_stream(nets):
    """Two concurrent sessions through the batched server: each is the
    port's single-stream engine's audio, and the JAX one's."""
    g_p, _, g, _ = nets
    wavs = [synth_utterance("SERVER STREAM ONE", seed=30),
            synth_utterance("A SECOND CLIENT TALKING LONGER", seed=31)]
    server = EnhanceServer(TCFG, g, max_streams=4, device="cpu", **KW).start()
    try:
        results = _in_threads(
            lambda i: enhance_via_server(server.address, wavs[i], timeout=TIMEOUT), 2)
    finally:
        server.stop()
    for got, wav in zip(results, wavs):
        assert got is not None and got.shape == wav.shape
        np.testing.assert_allclose(got, _port_reference(g, wav), rtol=0, atol=SERVER_ATOL)
        jeng = JaxStreaming(CFG, g_p, **KW)
        ref = np.concatenate([jeng.feed(wav), jeng.flush()])
        np.testing.assert_allclose(got, ref, rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("with_enhancer", [True, False])
def test_transcribe_mode_matches_recognizer(nets, with_enhancer):
    """A transcribe-mode session returns the StreamingRecognizer transcript
    (UTF-8 deltas concatenated), the port's and the JAX package's."""
    g_p, am_p, g, am = nets
    wav = synth_utterance("TRANSCRIBE THIS LIVE", seed=40)
    server = EnhanceServer(TCFG, g if with_enhancer else None, max_streams=2, am=am,
                           device="cpu", **ASR_KW).start()
    try:
        got = _in_threads(
            lambda i: transcribe_via_server(server.address, wav, timeout=TIMEOUT), 1)[0]
    finally:
        server.stop()
    ref = StreamingRecognizer(TCFG, am, g if with_enhancer else None, device="cpu", **ASR_KW)
    ref.feed(wav)
    ref.flush()
    jref = JaxRecognizer(CFG, am_p, g_params=g_p if with_enhancer else None, **ASR_KW)
    jref.feed(wav)
    jref.flush()
    assert got == ref.transcript() == jref.transcript()


def test_server_full_refuses_politely(nets):
    _, _, g, _ = nets
    wav = synth_utterance("ONLY ROOM FOR ONE", seed=32)
    server = EnhanceServer(TCFG, g, max_streams=1, device="cpu", **KW).start()
    try:
        # Occupy the only slot with a half-open session.
        first = socket.create_connection(server.address, timeout=TIMEOUT)
        send_frame(first, wav[:1000])
        # Second connection must get immediate end-of-stream.
        second = socket.create_connection(server.address, timeout=TIMEOUT)
        assert recv_frame(second) is None
        second.close()
        first.close()
    finally:
        server.stop()


def test_wire_format_is_the_jax_servers():
    """Frames byte for byte: <I length, f32 little-endian samples; 0 = end."""
    from aas_enhancement_tpu import serve as jax_serve

    from aas_enhancement_tpu_torch import serve as tserve
    x = np.array([0.5, -1.25, 3.0], np.float32)
    got = []
    for mod in (jax_serve, tserve):
        a, b = socket.socketpair()
        a.settimeout(TIMEOUT)
        b.settimeout(TIMEOUT)
        try:
            mod.send_frame(a, x)
            mod.send_eos(a)
            a.shutdown(socket.SHUT_WR)
            data = b""
            while chunk := b.recv(1024):
                data += chunk
            got.append(data)
        finally:
            a.close()
            b.close()
    assert got[0] == got[1] == b"\x0c\x00\x00\x00" + x.tobytes() + b"\x00\x00\x00\x00"


def test_ticker_failure_ends_sessions_and_is_reraised(nets):
    """An exception in the ticker's device work: the session gets the
    end-of-stream frame (its client returns), a later connection is not
    served, and stop() and check() re-raise the exception."""
    _, _, g, _ = nets
    server = EnhanceServer(TCFG, g, max_streams=2, device="cpu", **KW)
    step = server._eng.step

    def boom():
        if step():                          # the first tick with a session's block
            raise RuntimeError("device call failed")
        return {}

    server._eng.step = boom
    server.start()
    wav = synth_utterance("NOBODY WAITS FOREVER", seed=33)
    try:
        got = _in_threads(lambda i: enhance_via_server(server.address, wav,
                                                       timeout=TIMEOUT), 1)[0]
        assert got.size == 0
        with pytest.raises(RuntimeError, match="device call failed"):
            server.check()
        with pytest.raises(OSError):        # the listening socket is closed
            socket.create_connection(server.address, timeout=TIMEOUT).close()
    finally:
        with pytest.raises(RuntimeError, match="device call failed"):
            server.stop()


def test_warm_failure_raises_from_the_constructor(nets, monkeypatch):
    """The constructor's first device call (idle rows) runs in the caller's
    thread: a failure there raises before any session is taken."""
    _, _, g, _ = nets

    def fail(*args, **kwargs):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(tstreaming, "_run_block", fail)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        EnhanceServer(TCFG, g, max_streams=2, device="cpu", **KW)


def test_server_defaults_to_the_card(nets, monkeypatch):
    _, _, g, _ = nets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnhanceServer(TCFG, g, **KW)


# --------------------------------------------------------------- the CLI's rules
def test_cli_defaults_encode_measured_recipe():
    assert cli.resolve_operating_point(True, None, None, None) == (1.0, 0.5, 0.5)
    assert cli.resolve_operating_point(False, None, None, None) == (1.0, 0.2, 0.5)
    assert cli.resolve_operating_point(True, 2.0, 0.1, 0.3) == (2.0, 0.1, 0.3)
    assert cli.pick_weights("auto", True, True) == "streaming"
    assert cli.pick_weights("auto", True, False) == "offline"
    assert cli.pick_weights("auto", False, True) == "offline"
    assert cli.pick_weights("offline", True, True) == "offline"
    assert cli.pick_weights("streaming", True, True) == "streaming"
    with pytest.raises(SystemExit):
        cli.pick_weights("streaming", False, False)


def _ft_cfgs(chunk, lookahead, history, g_ft, am_ft):
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, streaming_finetune=g_ft, streaming_finetune_am=am_ft,
        am_through_enhancer=am_ft, stream_chunk_s=chunk, stream_lookahead_s=lookahead,
        stream_history_s=history))
    return cfg, TConfig.from_json(cfg.to_json())


POINTS = [(1.0, 0.5, 0.5), (1.0, 0.2, 0.5), (0.5, 0.5, 0.5), (1.0, 0.5, 1.0)]
TRAINED = [(1.0, 0.5, 0.5, True, False), (1.0, 0.2, 0.5, True, True),
           (1.0, 0.5, 0.5, False, True), (1.0, 0.5, 0.5, False, False),
           (0.5, 0.5, 0.5, True, True)]


def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except SystemExit as e:
        return ("exit", str(e))


def test_cli_helpers_equal_the_jax_clis():
    """The five helpers of the JAX CLI over a grid of inputs: the same
    results, warnings and SystemExit messages."""
    for transcribe in (True, False):
        for chunk in (None, 2.0):
            for look in (None, 0.1):
                for hist in (None, 0.3):
                    args = (transcribe, chunk, look, hist)
                    assert (cli.resolve_operating_point(*args)
                            == jax_cli.resolve_operating_point(*args))
        for weights in ("auto", "offline", "streaming"):
            for have in (True, False):
                args = (weights, transcribe, have)
                assert _outcome(cli.pick_weights, *args) == _outcome(jax_cli.pick_weights,
                                                                     *args)
    for trained in TRAINED:
        jcfg, tcfg = _ft_cfgs(*trained)
        for point in POINTS:
            for flag in ("streaming_finetune", "streaming_finetune_am"):
                assert (cli.ft_point_matches(tcfg, *point, flag=flag)
                        == jax_cli.ft_point_matches(jcfg, *point, flag=flag))
            for requested in ("auto", "streaming"):
                assert (cli.guard_streaming_pick(requested, tcfg, *point)
                        == jax_cli.guard_streaming_pick(requested, jcfg, *point))
    for which in ("offline", "streaming"):
        for am_weights in ("base", "adapted", ""):
            assert (cli.deployment_advisories(which, am_weights)
                    == jax_cli.deployment_advisories(which, am_weights))


def test_deployment_advisories():
    assert cli.deployment_advisories("offline", "base") == []
    adv = cli.deployment_advisories("offline", "adapted")
    assert len(adv) == 1 and "rescore" in adv[0] and "5.88%" in adv[0]
    adv = cli.deployment_advisories("streaming", "base")
    assert len(adv) == 1 and "continuation" in adv[0] and "2.1%" in adv[0]
    assert len(cli.deployment_advisories("streaming", "adapted")) == 2


# ------------------------------------------------------------ the CLI, end to end
def _checkpoint(path, objective, point=None, am_ft=False):
    """A train-CLI directory of the port at step 1: config.json + state."""
    train = dict(objective=objective)
    if point is not None:
        train.update(streaming_finetune=not am_ft, streaming_finetune_am=am_ft,
                     stream_chunk_s=point[0], stream_lookahead_s=point[1],
                     stream_history_s=point[2])
    cfg = TCFG.replace(train=dataclasses.replace(TCFG.train, **train))
    state = init_state(cfg, 0, "cpu")
    path.mkdir()
    (path / "config.json").write_text(cfg.to_json())
    ckpt.save(str(path), 1, state)
    return str(path)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_cli")
    return {"aas": _checkpoint(root / "aas", "aas"),
            "am": _checkpoint(root / "am", "am"),
            "paired": _checkpoint(root / "paired", "paired"),
            "ft": _checkpoint(root / "ft", "aas", point=(1.0, 0.5, 0.5)),
            "ft_off": _checkpoint(root / "ft_off", "aas", point=(1.0, 0.2, 0.5)),
            "am_ft": _checkpoint(root / "am_ft", "am", point=(1.0, 0.5, 0.5), am_ft=True)}


def _expected_line(argv_flags: dict, ft_cfg=None, am_weights="base") -> dict:
    """The JSON line by the JAX CLI's rules (its helpers, its keys)."""
    transcribe = argv_flags.get("transcribe", False)
    chunk, look, hist = jax_cli.resolve_operating_point(transcribe, None, None, None)
    which = jax_cli.pick_weights(argv_flags.get("weights", "auto"), transcribe,
                                 ft_cfg is not None)
    if which == "streaming":
        which, _ = jax_cli.guard_streaming_pick(argv_flags.get("weights", "auto"), ft_cfg,
                                                chunk, look, hist)
    return {"mode": "transcribe" if transcribe else "enhance", "weights": which,
            **({"am_weights": am_weights} if transcribe else {}),
            "chunk_s": chunk, "lookahead_s": look, "history_s": hist, "max_streams": 2,
            "latency_s": chunk + look,
            "advisories": jax_cli.deployment_advisories(which,
                                                        am_weights if transcribe else "")}


def _serve_once(argv, wav, transcribe):
    server, line = cli.start_server(argv)
    try:
        host, port = line["serving"].split(":")
        assert (host, int(port)) == tuple(server.address) and int(port) > 0
        client = transcribe_via_server if transcribe else enhance_via_server
        out = _in_threads(lambda i: client(server.address, wav, timeout=TIMEOUT), 1)[0]
    finally:
        server.stop()
    return line, out


@pytest.mark.parametrize("case", ["enhance", "transcribe", "streaming_matched",
                                  "streaming_off_point", "adapted_am"])
def test_cli_start_server(dirs, case, capsys):
    """``start_server`` with --port 0 --device cpu on checkpoint directories:
    the JSON line's keys and values by the JAX CLI's rules, and a session
    through the started server."""
    base = ["--port", "0", "--device", "cpu", "--max-streams", "2"]
    jcfg = lambda d: Config.from_json(open(f"{d}/config.json").read())   # noqa: E731
    if case == "enhance":
        argv, flags, ft, amw = ["--checkpoint", dirs["aas"]], {}, None, "base"
    elif case == "transcribe":
        argv, flags, ft, amw = (["--checkpoint", dirs["aas"], "--transcribe"],
                                {"transcribe": True}, None, "base")
    elif case == "streaming_matched":
        argv = ["--checkpoint", dirs["aas"], "--transcribe", "--streaming-checkpoint",
                dirs["ft"]]
        flags, ft, amw = {"transcribe": True}, jcfg(dirs["ft"]), "base"
    elif case == "streaming_off_point":
        argv = ["--checkpoint", dirs["aas"], "--transcribe", "--streaming-checkpoint",
                dirs["ft_off"]]
        flags, ft, amw = {"transcribe": True}, jcfg(dirs["ft_off"]), "base"
    else:
        argv = ["--checkpoint", dirs["aas"], "--transcribe", "--am-checkpoint",
                dirs["am_ft"]]
        flags, ft, amw = {"transcribe": True}, None, "adapted"
    wav = synth_utterance("SERVE FROM A DIRECTORY", seed=50)
    line, out = _serve_once(argv + base, wav, flags.get("transcribe", False))
    want = _expected_line(flags, ft, amw)
    assert set(line) == {"serving", *want}
    assert {k: v for k, v in line.items() if k != "serving"} == want
    printed = capsys.readouterr().out
    if case == "streaming_off_point":
        assert "falls back to offline" in printed
    for a in want["advisories"]:
        assert f"serve advisory: {a}" in printed
    if flags.get("transcribe"):
        assert isinstance(out, str)
    else:
        assert out.shape == wav.shape and np.isfinite(out).all()


def test_cli_refuses_as_the_jax_cli(dirs):
    base = ["--port", "0", "--device", "cpu", "--max-streams", "2"]
    with pytest.raises(SystemExit, match="checkpoint has no enhancer"):
        cli.start_server(["--checkpoint", dirs["am"]] + base)
    with pytest.raises(SystemExit, match="--transcribe needs acoustic-model params"):
        cli.start_server(["--checkpoint", dirs["paired"], "--transcribe"] + base)
    with pytest.raises(SystemExit, match="needs --streaming-checkpoint"):
        cli.start_server(["--checkpoint", dirs["aas"], "--weights", "streaming"] + base)
    with pytest.raises(SystemExit, match="carries no base AM"):
        cli.start_server(["--checkpoint", dirs["paired"], "--transcribe", "--am-checkpoint",
                          dirs["aas"]] + base)


def test_cli_defaults_to_the_card(dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.start_server(["--checkpoint", dirs["aas"], "--port", "0"])
