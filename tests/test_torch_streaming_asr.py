"""Port parity: streaming recognition (aas_enhancement_tpu_torch.models.am.
am_blockwise_apply, .streaming_asr) and the ``am`` objective's
``streaming_finetune_am`` against the JAX package, with the flax parameter
trees carried over by convert.py, on the CPU.

Small widths as the JAX streaming tests use (AM: 8 conv channels, one
BiGRU-16; enhancer: 8 channels, one conv layer, BiLSTM-8).  Tolerances:
- forwards 1e-5 absolute: logits of O(1) and log-probs, the running-moment
  increments relative to their size (an idle slot's logits, which the
  engines drop, only finite: ``test_streaming_asr_fn_matches_jax`` says why);
- whole streams: the emitted id frames and transcripts equal, the collected
  log-probs to 1e-5, the f32 running moments to 1e-5 relative;
- one ``am`` step with ``streaming_finetune_am`` (with and without the KL
  anchor, and behind the frozen streaming enhancer): the train tests'
  limits, metrics rtol 1e-4, gradients rtol 1e-4 plus 2e-5 * max|g| over the
  network (``tests/test_torch_train.py`` gives the reasons).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.config import AMConfig, Config, EnhancerConfig
from aas_enhancement_tpu.models.am import AcousticModel as JaxAM
from aas_enhancement_tpu.models.am import am_blockwise_apply as jax_am_blockwise_apply
from aas_enhancement_tpu.models.enhancer import Enhancer as JaxEnhancer
from aas_enhancement_tpu.streaming_asr import BatchedStreamingRecognizer as JaxBatched
from aas_enhancement_tpu.streaming_asr import StreamingRecognizer as JaxRecognizer
from aas_enhancement_tpu.streaming_asr import make_streaming_asr_fn as jax_asr_fn
from aas_enhancement_tpu.train.loop import init_state as jax_init_state
from aas_enhancement_tpu.train.steps import make_train_step as jax_make_train_step
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.convert import am_params_from_flax, enhancer_params_from_flax
from aas_enhancement_tpu_torch.models.am import AcousticModel, am_blockwise_apply
from aas_enhancement_tpu_torch.models.enhancer import Enhancer
from aas_enhancement_tpu_torch.streaming_asr import (BatchedStreamingRecognizer,
                                                     StreamingRecognizer,
                                                     make_streaming_asr_fn)
from aas_enhancement_tpu_torch.train.steps import make_train_step

from test_torch_train import _assert_grads_close, _batch, _cfg, _to_torch, _torch_state
from test_torch_train import METRIC_RTOL

torch.set_num_threads(1)

CFG = Config(am=AMConfig(rnn_hidden=16, rnn_layers=1, conv_channels=8),
             enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=8,
                                     rnn_layers=1))
TCFG = TConfig.from_json(CFG.to_json())
F_BINS = 161
FWD_ATOL = 1e-5
KW = dict(chunk_seconds=0.5, lookahead_seconds=0.2, history_seconds=0.5)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else np.array(a), params)


@pytest.fixture(scope="module")
def nets():
    """(flax AM params, flax enhancer params, torch AM, torch enhancer)."""
    x = jnp.zeros((1, 64, F_BINS), jnp.float32)
    n = jnp.array([64], jnp.int32)
    am_p = _perturbed(JaxAM(CFG.am).init(jax.random.key(0), x, n), 10)
    g_p = _perturbed(JaxEnhancer(CFG.enhancer).init(jax.random.key(1), x, n), 11)
    am = AcousticModel(TCFG.am, F_BINS)
    am.load_state_dict(am_params_from_flax(am_p))
    g = Enhancer(TCFG.enhancer, F_BINS)
    g.load_state_dict(enhancer_params_from_flax(g_p))
    return am_p, g_p, am.eval(), g.eval()


def _wav(n, seed):
    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 250.0 * t) * np.sin(2 * np.pi * 3.0 * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("chunk_f,look_f,hist_f", [(16, 4, 8), (10, 0, 6), (64, 0, 0),
                                                   (12, 6, 2)])
def test_am_blockwise_apply_matches_jax(nets, chunk_f, look_f, hist_f):
    """Ragged rows whose trailing windows have length 0; logits on the
    offline ceil(T / 2) grid with the offline out_lengths."""
    am_p, _, am, _ = nets
    rng = np.random.default_rng(chunk_f)
    t = 53
    x = rng.standard_normal((3, t, F_BINS)).astype(np.float32)
    lengths = np.array([t, 20, 9], np.int32)
    ref, ref_ol = jax_am_blockwise_apply(CFG.am, am_p, jnp.asarray(x), jnp.asarray(lengths),
                                         chunk_f, look_f, hist_f)
    with torch.no_grad():
        got, ol = am_blockwise_apply(am, torch.from_numpy(x), torch.from_numpy(lengths),
                                     chunk_f, look_f, hist_f)
    assert got.shape == ref.shape == (3, 27, CFG.am.vocab_size)
    assert ol.tolist() == np.asarray(ref_ol).tolist() == [27, 10, 5]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("what", ["blockwise chunk", "blockwise history", "recognizer",
                                  "batched recognizer"])
def test_odd_windows_raise_as_jax(nets, what):
    am_p, _, am, _ = nets
    x = torch.zeros(1, 20, F_BINS)
    calls = {
        "blockwise chunk": (lambda: jax_am_blockwise_apply(CFG.am, am_p, x.numpy(),
                                                           np.array([20]), 9, 0, 4),
                            lambda: am_blockwise_apply(am, x, torch.tensor([20]), 9, 0, 4)),
        "blockwise history": (lambda: jax_am_blockwise_apply(CFG.am, am_p, x.numpy(),
                                                             np.array([20]), 8, 0, 3),
                              lambda: am_blockwise_apply(am, x, torch.tensor([20]), 8, 0, 3)),
        "recognizer": (lambda: JaxRecognizer(CFG, am_p, chunk_seconds=0.505),
                       lambda: StreamingRecognizer(TCFG, am, chunk_seconds=0.505,
                                                   device="cpu")),
        "batched recognizer": (lambda: JaxBatched(CFG, am_p, history_seconds=0.25),
                               lambda: BatchedStreamingRecognizer(
                                   TCFG, am, history_seconds=0.25, device="cpu")),
    }
    ref_call, call = calls[what]
    with pytest.raises(ValueError) as ref:
        ref_call()
    with pytest.raises(ValueError) as got:
        call()
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("use_enhancer,per_row", [(False, False), (False, True),
                                                  (True, False), (True, True)])
def test_streaming_asr_fn_matches_jax(nets, use_enhancer, per_row):
    """Scalar stats windows broadcast, [B] ones address rows; the third row is
    an idle slot (length 0: one STFT frame), whose logits the engines drop:
    its input is |X|'s eps of 1e-6 over sqrt(1e-5) (empty moments), then
    GroupNorm over one near-constant frame, so rounding there is amplified
    (4.5e-05 measured) and the row is held to finite logits, length 1 and
    zero increments."""
    am_p, g_p, am, g = nets
    n = 9600
    wav = np.stack([_wav(n, 1), _wav(n, 2), np.zeros(n, np.float32)])
    lengths = np.array([n, 6400, 0], np.int32)
    wav[1, 6400:] = 0.0
    if per_row:
        ss, se = np.array([10, 4, 0], np.int32), np.array([50, 36, 0], np.int32)
    else:
        ss, se = np.int32(6), np.int32(44)
    enh_run = np.array([[300.0, -20.0, 0.0], [2100.0, 90.0, 0.0], [8050.0, 322.0, 0.0]],
                       np.float32)
    am_run = np.array([[150.0, 10.0, 0.0], [900.0, 60.0, 0.0], [8050.0, 322.0, 0.0]],
                      np.float32)
    ref = jax_asr_fn(CFG, use_enhancer)(am_p, g_p if use_enhancer else {},
                                        jnp.asarray(wav), jnp.asarray(lengths),
                                        jnp.asarray(ss), jnp.asarray(se),
                                        jnp.asarray(enh_run), jnp.asarray(am_run))
    got = make_streaming_asr_fn(TCFG, use_enhancer, "cpu")(
        am, g if use_enhancer else None, torch.from_numpy(wav), torch.from_numpy(lengths),
        torch.as_tensor(ss), torch.as_tensor(se), torch.from_numpy(enh_run),
        torch.from_numpy(am_run))
    assert got[0].shape == ref[0].shape == (3, 31, CFG.am.vocab_size)
    np.testing.assert_allclose(got[0].numpy()[:2], np.asarray(ref[0])[:2], rtol=0,
                               atol=FWD_ATOL)
    assert torch.isfinite(got[0][2]).all()
    assert got[1].tolist() == np.asarray(ref[1]).tolist() == [31, 21, 1]
    for g_inc, r_inc in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g_inc.numpy(), np.asarray(r_inc), rtol=1e-5,
                                   atol=FWD_ATOL)
    assert np.all(got[2].numpy() == 0.0) != use_enhancer
    assert np.all(got[2].numpy()[:, 2] == 0.0) and np.all(got[3].numpy()[:, 2] == 0.0)


def _assert_same_ids(got, ref, ref_logp):
    """Equal argmax ids, except where JAX's top-2 log-probs tie to 1e-5."""
    assert len(got) == len(ref) == len(ref_logp)
    top2 = np.sort(ref_logp, axis=-1)[:, -2:]
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b or top2[i, 1] - top2[i, 0] < FWD_ATOL, (i, a, b)


@pytest.mark.parametrize("push,use_enhancer", [(1600, True), (None, True), (1600, False),
                                               (None, False)])
def test_streaming_recognizer_matches_jax(nets, push, use_enhancer):
    """A whole stream, pushed in 0.1 s pieces or at once, against the JAX
    recognizer fed at once: ids, transcript, log-probs and both running
    moments (f32 host accumulation on both sides)."""
    am_p, g_p, am, g = nets
    wav = _wav(27100, 3)
    ref = JaxRecognizer(CFG, am_p, g_params=g_p if use_enhancer else None,
                        collect_logits=True, **KW)
    ref_ids = ref.feed(wav) + ref.flush()
    rec = StreamingRecognizer(TCFG, am, g if use_enhancer else None, collect_logits=True,
                              device="cpu", **KW)
    if push is None:
        ids = rec.feed(wav) + rec.flush()
    else:
        ids = [i for k in range(0, len(wav), push) for i in rec.feed(wav[k: k + push])]
        ids += rec.flush()
    assert rec.flush() == []
    _assert_same_ids(ids, ref_ids, ref.log_probs())
    assert len(ids) == 85                    # the offline ceil(170 frames / 2)
    assert rec.transcript() == ref.transcript()
    np.testing.assert_allclose(rec.log_probs(), ref.log_probs(), rtol=0, atol=FWD_ATOL)
    for got_run, ref_run in ((rec._enh_run, ref._enh_run), (rec._am_run, ref._am_run)):
        assert got_run.dtype == np.float32
        np.testing.assert_allclose(got_run, ref_run, rtol=1e-5, atol=FWD_ATOL)


def _drain(eng, ids):
    got = eng.step()
    while got:
        for s, x in got.items():
            ids[s].extend(x)
        got = eng.step()


def _batched(eng, wavs, push):
    slots = [eng.open() for _ in wavs]
    ids = {s: [] for s in slots}
    pos = [0] * len(wavs)
    while any(p < len(w) for p, w in zip(pos, wavs)):
        for i, (s, w) in enumerate(zip(slots, wavs)):
            if pos[i] < len(w):
                eng.feed(s, w[pos[i]: pos[i] + push])
                pos[i] += push
        _drain(eng, ids)
    for s in slots:
        eng.end_stream(s)
    _drain(eng, ids)
    assert all(eng.is_done(s) for s in slots)
    return [ids[s] for s in slots], [eng.transcript(s) for s in slots]


@pytest.mark.parametrize("push", [1600, 5000])
def test_batched_recognizer_matches_jax(nets, push):
    """Three sessions in four slots (one idle), enhancer in front, against the
    JAX engine and the port's single-session recognizer."""
    am_p, g_p, am, g = nets
    wavs = [_wav(20000, 6), _wav(30500, 7), _wav(3000, 8)]
    ref_ids, ref_text = _batched(JaxBatched(CFG, am_p, g_params=g_p, max_streams=4, **KW),
                                 wavs, push)
    ids, text = _batched(BatchedStreamingRecognizer(TCFG, am, g, max_streams=4,
                                                    device="cpu", **KW), wavs, push)
    assert text == ref_text
    for got, ref, w in zip(ids, ref_ids, wavs):
        single = JaxRecognizer(CFG, am_p, g_params=g_p, collect_logits=True, **KW)
        single.feed(w)
        single.flush()
        _assert_same_ids(got, ref, single.log_probs())
        one = StreamingRecognizer(TCFG, am, g, device="cpu", **KW)
        assert got == one.feed(w) + one.flush()


def test_batched_recognizer_slots(nets):
    _, _, am, _ = nets
    eng = BatchedStreamingRecognizer(TCFG, am, max_streams=1, device="cpu", **KW)
    s = eng.open()
    with pytest.raises(RuntimeError, match="in use"):
        eng.open()
    eng.end_stream(s)      # an empty stream still takes a final block: 1 frame past
    assert list(eng.step()) == [s] and eng.is_done(s)      # the history's 25
    assert eng.step() == {}
    with pytest.raises(RuntimeError, match="not an open stream"):
        eng.feed(s, np.zeros(10, np.float32))
    eng.close(s)
    with pytest.raises(RuntimeError, match="not an open stream"):
        eng.transcript(s)


def test_recognizer_log_probs_need_collect_logits(nets):
    _, _, am, _ = nets
    rec = StreamingRecognizer(TCFG, am, device="cpu", **KW)
    with pytest.raises(RuntimeError, match="collect_logits"):
        rec.log_probs()
    fresh = StreamingRecognizer(TCFG, am, collect_logits=True, device="cpu", **KW)
    assert fresh.log_probs().shape == (0, 0)


def test_recognizers_default_to_the_card(nets, monkeypatch):
    _, _, am, _ = nets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (StreamingRecognizer, BatchedStreamingRecognizer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(TCFG, am)


@pytest.mark.parametrize("anchored,through_g", [(False, False), (True, False),
                                                (True, True)])
def test_streaming_finetune_am_step_matches_jax(anchored, through_g):
    """One ``am`` step with ``streaming_finetune_am`` (chunk 0.1 s, lookahead
    0.03 s, history 0.06 s: 10 + 3 + 6 frames; the 16-frame row's last window
    has length 0), with the offline KL anchor and behind the frozen
    enhancer on its streaming forward (``streaming_finetune``): metrics and
    every AM gradient against the JAX step."""
    cfg = _cfg("am", am_layers=2, streaming_finetune_am=True, stream_chunk_s=0.1,
               stream_lookahead_s=0.03, stream_history_s=0.06,
               distill_lambda=0.7 if anchored else 0.0, am_through_enhancer=through_g,
               streaming_finetune=through_g)
    jstate = jax_init_state(cfg, jax.random.key(0))
    anchor = jax_init_state(cfg, jax.random.key(5)).am_params if anchored else None
    batch = {k: v for k, v in _batch(seed=5, weights=[1, 1, 0, 1],
                                     clean_weights=[1, 1, 1, 1]).items()
             if not k.startswith("clean")}
    jgrads, jaux = jax.jit(jax_make_train_step(cfg, anchor_am_params=anchor).batch_grads)(
        jstate, batch)

    tcfg, state = _torch_state(cfg, jstate)
    anchor_am = None
    if anchored:
        anchor_am = AcousticModel(tcfg.am, F_BINS).requires_grad_(False)
        anchor_am.load_state_dict(am_params_from_flax(jax.device_get(anchor)))
    grads, aux = make_train_step(tcfg, anchor_am=anchor_am).batch_grads(state,
                                                                        _to_torch(batch))
    assert set(aux) == set(jaux) and ("loss_distill" in aux) == anchored
    for key, ref in jaux.items():
        assert float(aux[key]) == pytest.approx(float(ref), rel=METRIC_RTOL, abs=1e-6), key
    ref = {n: torch.as_tensor(v) for n, v in
           am_params_from_flax(jax.device_get(jgrads["am"])).items()}
    assert set(grads["am"]) == set(ref)
    _assert_grads_close(grads["am"], ref, "am")
