"""Port parity: streaming enhancement (aas_enhancement_tpu_torch.models.enhancer.
blockwise_apply, .enhance.make_streaming_enhance_fn, .streaming) and the
generator objectives' streaming fine-tuning against the JAX package, with the
flax parameter tree carried over by convert.py, on the CPU.

Small widths as the JAX streaming tests use (8 conv channels, one conv
layer, BiLSTM-16).  Tolerances:
- forwards 1e-5 absolute: the enhancer's output (a mask in (0, 1)), the
  enhanced waveform of unit-scale audio and the running-moment increments
  relative to their size (sums over up to ~36,000 cells in another order);
- whole streams: the emitted samples to 1e-5, every chunk's normalization
  having been fed by the previous chunks' increments (f64 on both hosts,
  f32 on the devices);
- one ``aas`` / ``paired`` step with ``streaming_finetune``: the train
  tests' limits, metrics rtol 1e-4, gradients rtol 1e-4 plus 2e-5 * max|g|
  over the network (``tests/test_torch_train.py`` gives the reasons).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.config import Config, EnhancerConfig
from aas_enhancement_tpu.enhance import make_streaming_enhance_fn as jax_streaming_fn
from aas_enhancement_tpu.models.enhancer import Enhancer as JaxEnhancer
from aas_enhancement_tpu.models.enhancer import blockwise_apply as jax_blockwise_apply
from aas_enhancement_tpu.models.enhancer import enhanced_log_mag as jax_enhanced_log_mag
from aas_enhancement_tpu.streaming import BatchedStreamingEnhancer as JaxBatched
from aas_enhancement_tpu.streaming import StreamingEnhancer as JaxStreaming
from aas_enhancement_tpu.streaming import enhance_stream as jax_enhance_stream
from aas_enhancement_tpu.train.loop import init_state as jax_init_state
from aas_enhancement_tpu.train.steps import make_train_step as jax_make_train_step
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.convert import enhancer_params_from_flax
from aas_enhancement_tpu_torch.enhance import make_streaming_enhance_fn
from aas_enhancement_tpu_torch.models.enhancer import (Enhancer, blockwise_apply,
                                                       enhanced_log_mag)
from aas_enhancement_tpu_torch.streaming import (BatchedStreamingEnhancer,
                                                 StreamingEnhancer, enhance_stream)
from aas_enhancement_tpu_torch.train.steps import make_train_step

from test_torch_train import CONVERT, METRIC_RTOL, _assert_grads_close, _batch, _cfg
from test_torch_train import _to_torch, _torch_state

torch.set_num_threads(1)

SMALL = EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=16, rnn_layers=1)
CFG = Config(enhancer=SMALL)
F_BINS = 161
FWD_ATOL = 1e-5


@pytest.fixture(scope="module")
def nets():
    """(flax params with non-zero biases, the converted torch Enhancer)."""
    params = JaxEnhancer(SMALL).init(jax.random.key(0), jnp.zeros((1, 24, F_BINS)),
                                     jnp.array([24], jnp.int32))
    rng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else np.array(a), params)
    model = Enhancer(SMALL, F_BINS)
    model.load_state_dict(enhancer_params_from_flax(params))
    return params, model.eval()


def _wav(n, seed):
    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 330.0 * t) + 0.1 * rng.standard_normal(n)
            ).astype(np.float32)


@pytest.mark.parametrize("chunk_f,look_f,hist_f", [(16, 4, 8), (10, 0, 6), (48, 0, 0),
                                                   (7, 3, 5)])
def test_blockwise_apply_matches_jax(nets, chunk_f, look_f, hist_f):
    """Ragged rows: the short row's trailing windows have length 0 (and the
    (48, 0, 0) case is one window covering each row)."""
    params, model = nets
    rng = np.random.default_rng(chunk_f)
    t = 53
    x = rng.standard_normal((3, t, F_BINS)).astype(np.float32)
    lengths = np.array([t, 20, 9], np.int32)
    ref = np.asarray(jax_blockwise_apply(SMALL, params, jnp.asarray(x), jnp.asarray(lengths),
                                         chunk_f, look_f, hist_f))
    with torch.no_grad():
        got = blockwise_apply(model, torch.from_numpy(x), torch.from_numpy(lengths),
                              chunk_f, look_f, hist_f).numpy()
    assert got.shape == ref.shape == (3, t, F_BINS)
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_ATOL)
    assert np.all(got[1, 20:] == 0.0) and np.all(got[2, 9:] == 0.0)


@pytest.mark.parametrize("mode", ["mask", "mapping"])
def test_enhanced_log_mag_matches_jax(mode):
    rng = np.random.default_rng(3)
    out = rng.uniform(0.0, 1.0, (2, 9, F_BINS)).astype(np.float32)
    noisy = rng.uniform(0.0, 4.0, (2, 9, F_BINS)).astype(np.float32)
    cfg = dataclasses.replace(SMALL, mode=mode)
    ref = np.asarray(jax_enhanced_log_mag(cfg, jnp.asarray(out), jnp.asarray(noisy)))
    got = enhanced_log_mag(cfg, torch.from_numpy(out), torch.from_numpy(noisy)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("per_row", [False, True])
def test_streaming_enhance_fn_matches_jax(nets, per_row):
    """Scalar moments broadcast; [B] moments and stats windows address rows
    (the third row is an idle slot: length 0, empty window)."""
    params, model = nets
    n = 9600
    wav = np.stack([_wav(n, 1), _wav(n, 2), np.zeros(n, np.float32)])
    lengths = np.array([n, 7000, 0], np.int32)
    wav[1, 7000:] = 0.0
    if per_row:
        ss, se = np.array([10, 5, 0], np.int32), np.array([50, 40, 0], np.int32)
        run = (np.array([120.5, -3.0, 0.0], np.float32), np.array([900.0, 40.0, 0.0],
                                                                   np.float32),
               np.array([8050.0, 161.0, 0.0], np.float32))
    else:
        ss, se = np.int32(4), np.int32(44)
        run = (np.float32(55.0), np.float32(700.0), np.float32(3220.0))
    ref = jax_streaming_fn(CFG)(params, jnp.asarray(wav), jnp.asarray(lengths),
                                jnp.asarray(ss), jnp.asarray(se),
                                *(jnp.asarray(r) for r in run))
    got = make_streaming_enhance_fn(TConfig.from_json(CFG.to_json()), "cpu")(
        model, torch.from_numpy(wav), torch.from_numpy(lengths),
        torch.as_tensor(ss), torch.as_tensor(se), *(torch.as_tensor(r) for r in run))
    assert len(got) == 4 and got[0].shape == (3, n)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=FWD_ATOL)
    for g, r in zip(got[1:], ref[1:]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=FWD_ATOL)
    assert got[3].numpy()[2] == 0.0          # the idle row adds nothing to its moments


def _kw(history):
    return dict(chunk_seconds=0.5, lookahead_seconds=0.1, history_seconds=history)


@pytest.mark.parametrize("push,history", [(1600, 0.5), (None, 0.5), (1600, 0.0),
                                          (None, 0.3)])
def test_streaming_enhancer_matches_jax(nets, push, history):
    """A whole stream, pushed in 0.1 s pieces or at once, against the JAX
    engine fed at once; the port's pieces equal its bulk run."""
    params, model = nets
    wav = _wav(27000, 4)
    cfg = TConfig.from_json(CFG.to_json())
    ref_eng = JaxStreaming(CFG, params, **_kw(history))
    ref = np.concatenate([ref_eng.feed(wav), ref_eng.flush()])
    eng = StreamingEnhancer(cfg, model, **_kw(history), device="cpu")
    if push is None:
        got = np.concatenate([eng.feed(wav), eng.flush()])
    else:
        outs = [eng.feed(wav[i: i + push]) for i in range(0, len(wav), push)]
        got = np.concatenate(outs + [eng.flush()])
    assert got.shape == ref.shape == wav.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_ATOL)
    assert eng._count == ref_eng._count
    assert eng._sum == pytest.approx(ref_eng._sum, rel=1e-5)
    assert eng._sumsq == pytest.approx(ref_eng._sumsq, rel=1e-5)


def _drain(eng, outs):
    got = eng.step()
    while got:
        for s, y in got.items():
            outs[s].append(y)
        got = eng.step()


def _batched(eng, wavs, push):
    slots = [eng.open() for _ in wavs]
    outs = {s: [] for s in slots}
    pos = [0] * len(wavs)
    while any(p < len(w) for p, w in zip(pos, wavs)):
        for i, (s, w) in enumerate(zip(slots, wavs)):
            if pos[i] < len(w):
                eng.feed(s, w[pos[i]: pos[i] + push])
                pos[i] += push
        _drain(eng, outs)
    for s in slots:
        eng.end_stream(s)
    _drain(eng, outs)
    assert all(eng.is_done(s) for s in slots)
    return [np.concatenate(outs[s]) for s in slots]


@pytest.mark.parametrize("push", [1600, 4000])
def test_batched_streaming_enhancer_matches_jax(nets, push):
    """Three streams of different lengths in four slots (one idle, a length-0
    row in every tick) against the JAX engine and the port's single-stream
    engine; a stream shorter than a chunk flushes alone."""
    params, model = nets
    cfg = TConfig.from_json(CFG.to_json())
    wavs = [_wav(20000, 5), _wav(31000, 6), _wav(3000, 7)]
    ref = _batched(JaxBatched(CFG, params, max_streams=4, **_kw(0.5)), wavs, push)
    got = _batched(BatchedStreamingEnhancer(cfg, model, max_streams=4, **_kw(0.5),
                                            device="cpu"), wavs, push)
    for g, r, w in zip(got, ref, wavs):
        assert g.shape == r.shape == w.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=FWD_ATOL)
        single = StreamingEnhancer(cfg, model, **_kw(0.5), device="cpu")
        np.testing.assert_allclose(g, np.concatenate([single.feed(w), single.flush()]),
                                   rtol=0, atol=FWD_ATOL)


def test_batched_slots_open_close_and_refuse():
    cfg = TConfig.from_json(CFG.to_json())
    eng = BatchedStreamingEnhancer(cfg, None, max_streams=1, device="cpu")
    s = eng.open()
    with pytest.raises(RuntimeError, match="in use"):
        eng.open()
    eng.end_stream(s)
    with pytest.raises(RuntimeError, match="not an open stream"):
        eng.feed(s, np.zeros(10, np.float32))
    assert eng.step() == {} and eng.is_done(s)
    eng.close(s)
    assert eng.open() == s and not eng.is_done(s)


def test_enhance_stream_matches_jax(nets):
    params, model = nets
    wav = _wav(17000, 8)
    ref = list(jax_enhance_stream(CFG, params, wav, **_kw(0.5)))
    got = list(enhance_stream(TConfig.from_json(CFG.to_json()), model, wav, **_kw(0.5),
                              device="cpu"))
    assert [len(g) for g in got] == [len(r) for r in ref]
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(ref), rtol=0,
                               atol=FWD_ATOL)


def test_streaming_classes_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TConfig.from_json(CFG.to_json())
    for make in (lambda: StreamingEnhancer(cfg, None),
                 lambda: BatchedStreamingEnhancer(cfg, None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("objective", ["aas", "paired"])
def test_streaming_finetune_step_matches_jax(objective):
    """One step with ``streaming_finetune`` (chunk 0.1 s, lookahead 0.03 s,
    history 0.05 s: 10 + 3 + 5 frames, so the 26-frame rows make 3 windows
    and the 16-frame row's last one has length 0): metrics and every G (and
    D) gradient against the JAX step."""
    cfg = _cfg(objective, streaming_finetune=True, stream_chunk_s=0.1,
               stream_lookahead_s=0.03, stream_history_s=0.05)
    jstate = jax_init_state(cfg, jax.random.key(0))
    batch = _batch(seed=4, weights=[1, 1, 1, 0], clean_weights=[1, 1, 1, 1])
    jgrads, jaux = jax.jit(jax_make_train_step(cfg).batch_grads)(jstate, batch)

    tcfg, state = _torch_state(cfg, jstate)
    assert tcfg.train.streaming_finetune and tcfg.train.stream_chunk_s == 0.1
    grads, aux = make_train_step(tcfg).batch_grads(state, _to_torch(batch))
    assert set(aux) == set(jaux) and set(grads) == set(jgrads)
    for key, ref in jaux.items():
        assert float(aux[key]) == pytest.approx(float(ref), rel=METRIC_RTOL, abs=1e-6), key
    for net, jg in jgrads.items():
        ref = {n: torch.as_tensor(v) for n, v in CONVERT[net](jax.device_get(jg)).items()}
        _assert_grads_close(grads[net], ref, net)
    # The streaming forward is another function than the offline one.
    off_cfg = _cfg(objective)
    _, off_aux = make_train_step(TConfig.from_json(off_cfg.to_json())).batch_grads(
        _torch_state(off_cfg, jstate)[1], _to_torch(batch))
    key = "loss_paired" if objective == "paired" else "loss_ctc"
    assert float(off_aux[key]) != pytest.approx(float(aux[key]), rel=1e-5)
