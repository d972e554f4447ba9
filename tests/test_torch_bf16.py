"""Port parity at bfloat16 on the CPU: the plain versions of the recurrences
(B1, B2, time-major and stacked) and of the GroupNorm (B3), BiRNN,
MaskedGroupNorm, the three models, the enhance and recognition paths and
the streaming engines, against the JAX package with ``dtype="bfloat16"``.

The JAX side runs what its bf16 models run on a TPU: the BiRNN on its Pallas
route (``ops/rnn.py``: ``impl="auto"`` takes it on a TPU; on the CPU it would
take the XLA scan, whose carry is bf16), here the Pallas kernels in
interpret mode, through a subclass whose ``impl`` defaults to "pallas" put in
the models' modules for the duration of this file; the GroupNorm on its XLA
route (``impl="auto"`` everywhere).  Nothing in the JAX package changes.

Limits (written into PERF.md first): single modules and the models rtol 2e-2 with atol
2e-2 x max|ref| (the JAX package's bf16 limit, ``tests/test_gn_kernel.py``);
the enhance path's wave, the recognition path's logits and the streaming
engines' outputs atol 5e-2 x max|ref| (a path sums the mask's bf16 error over
161 bins and two overlapping frames, the logits' through every layer);
greedy ids equal wherever JAX's top-2 log-probs part by more than that.
Also: a bf16 config trains (``init_state``, ``make_train_step`` and
``train`` take it; the steps themselves are held to JAX's in
``tests/test_torch_bf16_steps.py``), a bf16 config loads alike in both
packages, the operators' fakes give bf16 for bf16, and an exported bf16
enhancer equals the live one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import aas_enhancement_tpu.models.am as jax_am_mod
import aas_enhancement_tpu.models.enhancer as jax_enh_mod
from aas_enhancement_tpu import config as jconfig
from aas_enhancement_tpu import evaluation as jax_eval
from aas_enhancement_tpu.enhance import make_enhance_fn as jax_make_enhance_fn
from aas_enhancement_tpu.models.discriminator import Discriminator as JaxDisc
from aas_enhancement_tpu.ops.norm import MaskedGroupNorm as JaxGN
from aas_enhancement_tpu.ops.pallas.gn_kernel import masked_group_norm_act as jax_gn_pallas
from aas_enhancement_tpu.ops.pallas.rnn_kernel import (gru_scan_pallas, gru_scan_tm,
                                                       lstm_scan_pallas, lstm_scan_tm)
from aas_enhancement_tpu.ops.rnn import BiRNN as JaxBiRNN
from aas_enhancement_tpu.streaming import StreamingEnhancer as JaxStreamingEnhancer
from aas_enhancement_tpu.streaming_asr import StreamingRecognizer as JaxRecognizer
from aas_enhancement_tpu_torch import config as tconfig
from aas_enhancement_tpu_torch import evaluation as teval
from aas_enhancement_tpu_torch.convert import (am_params_from_flax, disc_params_from_flax,
                                               enhancer_params_from_flax)
from aas_enhancement_tpu_torch.decode import greedy as tgreedy
from aas_enhancement_tpu_torch.enhance import make_enhance_fn
from aas_enhancement_tpu_torch.models.am import AcousticModel, am_blockwise_apply
from aas_enhancement_tpu_torch.models.discriminator import Discriminator
from aas_enhancement_tpu_torch.models.enhancer import Enhancer, blockwise_apply
from aas_enhancement_tpu_torch.ops import library
from aas_enhancement_tpu_torch.ops.cuda import gn as kgn
from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
from aas_enhancement_tpu_torch.ops.dispatch import check_kernel_inputs, compute_dtype
from aas_enhancement_tpu_torch.ops.norm import MaskedGroupNorm
from aas_enhancement_tpu_torch.ops.rnn import BiRNN
from aas_enhancement_tpu_torch.streaming import StreamingEnhancer
from aas_enhancement_tpu_torch.streaming_asr import StreamingRecognizer

torch.set_num_threads(1)

BF16 = jnp.bfloat16
F_BINS = 161
MODULE_RTOL, MODULE_ATOL = 2e-2, 2e-2      # x max|ref|
PATH_ATOL = 5e-2                           # x max|ref|
CFG = jconfig.Config(
    am=jconfig.AMConfig(rnn_hidden=16, rnn_layers=2, conv_channels=8, dtype="bfloat16"),
    enhancer=jconfig.EnhancerConfig(conv_channels=8, conv_layers=2, rnn_hidden=16,
                                    rnn_layers=2, dtype="bfloat16"),
    discriminator=jconfig.DiscriminatorConfig(channels=(8, 16), dtype="bfloat16"))
TCFG = tconfig.Config.from_json(CFG.to_json())
KW = dict(chunk_seconds=0.5, lookahead_seconds=0.2, history_seconds=0.5)


class _PallasBiRNN(JaxBiRNN):
    """The JAX BiRNN with the route its bf16 models take on a TPU."""
    impl: str = "pallas"


@pytest.fixture(scope="module", autouse=True)
def pallas_birnn():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_enh_mod, "BiRNN", _PallasBiRNN)
        mp.setattr(jax_am_mod, "BiRNN", _PallasBiRNN)
        yield


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, ref, atol=MODULE_ATOL, rtol=MODULE_RTOL):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * float(np.abs(ref).max()))


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 values rounded through bfloat16 (the parameters' cast)."""
    return np.array(jnp.asarray(a, BF16).astype(jnp.float32))


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else np.array(a), params)


def _wav(n, seed):
    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 250.0 * t) * np.sin(2 * np.pi * 3.0 * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    """(flax enhancer, AM and discriminator params; the torch models)."""
    x = jnp.zeros((1, 64, F_BINS), jnp.float32)
    n = jnp.array([64], jnp.int32)
    g_p = _perturbed(jax_enh_mod.Enhancer(CFG.enhancer).init(jax.random.key(1), x, n), 11)
    am_p = _perturbed(jax_am_mod.AcousticModel(CFG.am).init(jax.random.key(0), x, n), 10)
    d_p = _perturbed(JaxDisc(CFG.discriminator).init(jax.random.key(2), x, n), 12)
    g = Enhancer(TCFG.enhancer, F_BINS)
    g.load_state_dict(enhancer_params_from_flax(g_p))
    am = AcousticModel(TCFG.am, F_BINS)
    am.load_state_dict(am_params_from_flax(am_p))
    d = Discriminator(TCFG.discriminator, F_BINS)
    d.load_state_dict(disc_params_from_flax(d_p))
    return g_p, am_p, d_p, g.eval(), am.eval(), d.eval()


# ----------------------------------------------- the plain kernels (B1, B2, B3, B7, B7')

def _scan_inputs(cell, t, b, h, seed):
    g = (4 if cell == "lstm" else 3) * h
    rng = np.random.default_rng(seed)
    gxf, gxb = (0.6 * rng.standard_normal((2, t, b, g))).astype(np.float32)
    wh = _bf16_round((0.3 * rng.standard_normal((2, h, g))).astype(np.float32))
    bh = _bf16_round((0.1 * rng.standard_normal((2, g))).astype(np.float32))
    lengths = np.array([t, 10, 0, t - 3][:b])            # ragged, one of length 0
    m = (np.arange(t)[:, None] < lengths[None]).astype(np.float32)
    return gxf, gxb, m, wh, bh


@pytest.mark.parametrize("cell,h", [("lstm", 16), ("gru", 16), ("lstm", 8), ("gru", 12)])
def test_plain_time_major_scan_matches_pallas(cell, h):
    """B1 / B2: bf16 gx and y, f32 wh and bh rounded through bf16."""
    t, b = 21, 4
    gxf, gxb, m, wh, bh = _scan_inputs(cell, t, b, h, seed=h + len(cell))
    pallas = lstm_scan_tm if cell == "lstm" else gru_scan_tm
    ref = pallas(jnp.asarray(gxf, BF16), jnp.asarray(gxb, BF16), jnp.asarray(m),
                 jnp.asarray(wh), jnp.asarray(bh), True)
    fn = krnn.lstm_scan_tm if cell == "lstm" else krnn.gru_scan_tm
    got = fn(torch.from_numpy(gxf).bfloat16(), torch.from_numpy(gxb).bfloat16(),
             torch.from_numpy(m), torch.from_numpy(wh), torch.from_numpy(bh))
    for a, r in zip(got, ref):
        assert a.dtype == torch.bfloat16 and r.dtype == BF16
        _close(a, r)
    assert np.all(_f32(got[0])[:, 2] == 0) and np.all(_f32(got[1])[:, 2] == 0)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_plain_stacked_scan_matches_pallas(cell):
    """B7 / B7': the stacked layout, direction 1 flipped by the caller."""
    t, b, h = 17, 3, 16
    gxf, gxb, m, wh, bh = _scan_inputs(cell, t, b, h, seed=5)
    gx = np.stack([gxf, gxb[::-1]], axis=1)
    ms = np.stack([m, m[::-1]], axis=1)
    pallas = lstm_scan_pallas if cell == "lstm" else gru_scan_pallas
    ref = pallas(jnp.asarray(gx, BF16), jnp.asarray(ms), jnp.asarray(wh), jnp.asarray(bh),
                 True)
    fn = krnn.lstm_scan_stacked if cell == "lstm" else krnn.gru_scan_stacked
    got = fn(torch.from_numpy(np.ascontiguousarray(gx)).bfloat16(), torch.from_numpy(ms),
             torch.from_numpy(wh), torch.from_numpy(bh))
    assert got.dtype == torch.bfloat16
    _close(got, ref)


def test_plain_scan_rounds_h_before_the_product():
    """The bf16 step differs from an f32 run of the same inputs (h is rounded
    before the recurrent product, y on the store), and the f32 route is
    untouched by the bf16 code."""
    gxf, gxb, m, wh, bh = (torch.from_numpy(a) for a in _scan_inputs("gru", 30, 2, 16, 9))
    y32 = krnn.gru_scan_tm(gxf, gxb, m, wh, bh)
    y16 = krnn.gru_scan_tm(gxf.bfloat16(), gxb.bfloat16(), m, wh, bh)
    assert y32[0].dtype == torch.float32
    assert not torch.equal(y16[0].float(), y32[0].bfloat16().float())
    _close(y16[0], y32[0])


def _gn_inputs(seed, shape=(3, 19, 10, 16)):
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal(shape) + 0.3).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, scale, bias, np.array([shape[1], 7, 0], np.int32)


@pytest.mark.parametrize("act", ["leaky_relu", "hardtanh"])
def test_plain_gn_matches_the_jax_module_xla_route(act):
    """B3 at bf16 against the bf16 model's GroupNorm (XLA route: the
    activation after the cast)."""
    x, scale, bias, lengths = _gn_inputs(3)
    mod = JaxGN(num_groups=4, dtype=BF16, act=act, impl="xla")
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    ref = mod.apply(params, jnp.asarray(x, BF16), jnp.asarray(lengths))
    got = kgn.masked_group_norm_act(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                                    torch.from_numpy(bias), torch.from_numpy(lengths),
                                    num_groups=4, act=act)
    assert got.dtype == torch.bfloat16 and ref.dtype == BF16
    _close(got, ref)
    assert np.all(_f32(got)[1, 7:] == 0) and np.all(_f32(got)[2] == 0)


@pytest.mark.parametrize("act", ["leaky_relu", "hardtanh"])
def test_plain_gn_matches_the_pallas_kernel(act):
    """B3 at bf16 against the Pallas kernel (interpret mode), whose apply
    takes the activation before the cast: at most one bf16 ulp apart."""
    x, scale, bias, lengths = _gn_inputs(4)
    ref = jax_gn_pallas(jnp.asarray(x, BF16), jnp.asarray(scale), jnp.asarray(bias),
                        jnp.asarray(lengths), num_groups=4, act=act, out_dtype=BF16,
                        interpret=True)
    got = kgn.masked_group_norm_act(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                                    torch.from_numpy(bias), torch.from_numpy(lengths),
                                    num_groups=4, act=act)
    _close(got, ref)


# -------------------------------------------------------- the modules and the models

@pytest.mark.parametrize("cell,time_major", [("lstm", True), ("gru", True),
                                             ("lstm", False), ("gru", False)])
def test_birnn_matches_jax(cell, time_major):
    t, b, d, hidden = 15, 3, 12, 16
    rng = np.random.default_rng(21)
    shape = (t, b, d) if time_major else (b, t, d)
    x = rng.standard_normal(shape).astype(np.float32)
    lengths = np.array([t, t - 6, 0], np.int32)
    mod = JaxBiRNN(hidden, cell=cell, dtype=BF16, time_major=time_major, impl="pallas")
    params = _perturbed(mod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(lengths)), 4)
    ref = mod.apply(params, jnp.asarray(x), jnp.asarray(lengths))
    p = params["params"]
    tmod = BiRNN(d, hidden, cell=cell, time_major=time_major, dtype=torch.bfloat16)
    tmod.load_state_dict({"wx.kernel": torch.from_numpy(np.asarray(p["wx"]["kernel"])),
                          "wx.bias": torch.from_numpy(np.asarray(p["wx"]["bias"])),
                          "wh": torch.from_numpy(np.asarray(p["wh"])),
                          "bh": torch.from_numpy(np.asarray(p["bh"]))})
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.dtype == torch.bfloat16 and ref.dtype == BF16
    assert tmod.wh.dtype == torch.float32
    _close(got, ref)


def test_masked_group_norm_module_matches_jax():
    x, scale, bias, lengths = _gn_inputs(8)
    ref = JaxGN(num_groups=8, dtype=BF16, act="leaky_relu").apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(x, BF16), jnp.asarray(lengths))
    mod = MaskedGroupNorm(16, num_groups=8, act="leaky_relu", dtype=torch.bfloat16)
    mod.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = mod(torch.from_numpy(x).bfloat16(), torch.from_numpy(lengths))
    _close(got, ref)


def _features(seed, b=2, t=40):
    x = np.random.default_rng(seed).standard_normal((b, t, F_BINS)).astype(np.float32)
    return x, np.array([t, t - 13][:b], np.int32)


def test_enhancer_matches_jax(nets):
    g_p, _, _, g, _, _ = nets
    x, lengths = _features(1)
    ref = jax_enh_mod.Enhancer(CFG.enhancer).apply(g_p, jnp.asarray(x), jnp.asarray(lengths))
    with torch.no_grad():
        got = g(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32   # the mask leaves in f32
    _close(got, ref)
    assert np.all(got.numpy()[1, 27:] == 0)


def test_am_matches_jax(nets):
    _, am_p, _, _, am, _ = nets
    x, lengths = _features(2)
    ref, ref_len = jax_am_mod.AcousticModel(CFG.am).apply(am_p, jnp.asarray(x),
                                                          jnp.asarray(lengths))
    with torch.no_grad():
        got, out_len = am(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32   # the fc head in f32
    assert out_len.tolist() == np.asarray(ref_len).tolist()
    _close(got, ref)


def test_discriminator_matches_jax(nets):
    _, _, d_p, _, _, d = nets
    x, lengths = _features(3, b=2, t=36)
    ref = JaxDisc(CFG.discriminator).apply(d_p, jnp.asarray(x), jnp.asarray(lengths))
    with torch.no_grad():
        got = d(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.dtype == torch.float32
    _close(got, ref)


def test_blockwise_forwards_match_jax(nets):
    g_p, am_p, _, g, am, _ = nets
    x, lengths = _features(4, t=50)
    ref = jax_enh_mod.blockwise_apply(CFG.enhancer, g_p, jnp.asarray(x),
                                      jnp.asarray(lengths), 16, 4, 8)
    ref_am, _ = jax_am_mod.am_blockwise_apply(CFG.am, am_p, jnp.asarray(x),
                                              jnp.asarray(lengths), 16, 4, 8)
    with torch.no_grad():
        got = blockwise_apply(g, torch.from_numpy(x), torch.from_numpy(lengths), 16, 4, 8)
        got_am, _ = am_blockwise_apply(am, torch.from_numpy(x), torch.from_numpy(lengths),
                                       16, 4, 8)
    _close(got, ref)
    _close(got_am, ref_am)


# ------------------------------------------------------------------ the paths

def test_enhance_path_matches_jax(nets):
    """wav -> enhanced wav (STFT, bf16 enhancer, ISTFT), ragged."""
    g_p, _, _, g, _, _ = nets
    n = 12000
    wav = np.stack([_wav(n, 1), _wav(n, 2)])
    lengths = np.array([n, 7000], np.int32)
    wav[1, 7000:] = 0.0
    ref = jax_make_enhance_fn(CFG)(g_p, jnp.asarray(wav), jnp.asarray(lengths))
    got = make_enhance_fn(TCFG, "cpu")(g, torch.from_numpy(wav), torch.from_numpy(lengths))
    assert got.dtype == torch.float32
    _close(got, ref, atol=PATH_ATOL, rtol=0)


def _assert_same_ids(got, ref, ref_logp, limit):
    """Equal argmax ids wherever JAX's top-2 log-probs part by more than the
    logits' limit (at least one frame does)."""
    top2 = np.sort(ref_logp, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > limit
    assert sure.any()
    np.testing.assert_array_equal(np.asarray(got)[sure], np.asarray(ref)[sure])


def test_recognition_path_matches_jax(nets):
    """wav -> (bf16 enhancer) -> bf16 AM -> logits -> greedy ids."""
    g_p, am_p, _, g, am, _ = nets
    rng = np.random.default_rng(5)
    wav = (0.3 * rng.standard_normal((2, 8000))).astype(np.float32)
    lengths = np.array([8000, 5000], np.int32)
    wav[1, 5000:] = 0.0
    ref, ref_pads = jax_eval.make_eval_forward(CFG, use_enhancer=True)(
        am_p, g_p, jnp.asarray(wav), jnp.asarray(lengths))
    got, pads = teval.make_eval_forward(TCFG, use_enhancer=True)(
        am, g, torch.from_numpy(wav), torch.from_numpy(lengths))
    np.testing.assert_array_equal(pads.numpy(), np.asarray(ref_pads))
    assert got.dtype == torch.float32
    _close(got, ref, atol=PATH_ATOL, rtol=0)
    limit = 2 * PATH_ATOL * float(np.abs(np.asarray(ref)).max())
    ids, _ = tgreedy.greedy_decode(got, pads)
    ref_logp = np.asarray(jax.nn.log_softmax(ref, axis=-1))
    ref_ids = np.asarray(jnp.argmax(ref, axis=-1))
    valid = np.asarray(ref_pads) == 0
    _assert_same_ids(got.argmax(-1).numpy()[valid], ref_ids[valid], ref_logp[valid], limit)
    assert ids.shape[0] == 2


def test_streaming_enhancer_matches_jax(nets):
    g_p, _, _, g, _, _ = nets
    wav = _wav(20000, 6)
    ref = JaxStreamingEnhancer(CFG, g_p, **KW)
    ref_out = np.concatenate([ref.feed(wav), ref.flush()])
    eng = StreamingEnhancer(TCFG, g, device="cpu", **KW)
    got = np.concatenate([eng.feed(wav[k: k + 1600]) for k in range(0, len(wav), 1600)]
                         + [eng.flush()])
    assert got.dtype == np.float32 and got.shape == ref_out.shape
    _close(got, ref_out, atol=PATH_ATOL, rtol=0)


def test_streaming_recognizer_matches_jax(nets):
    g_p, am_p, _, g, am, _ = nets
    wav = _wav(17100, 3)
    ref = JaxRecognizer(CFG, am_p, g_params=g_p, collect_logits=True, **KW)
    ref_ids = ref.feed(wav) + ref.flush()
    rec = StreamingRecognizer(TCFG, am, g, collect_logits=True, device="cpu", **KW)
    ids = rec.feed(wav) + rec.flush()
    ref_logp = ref.log_probs()
    assert rec.log_probs().dtype == np.float32
    _close(rec.log_probs(), ref_logp, atol=PATH_ATOL, rtol=0)
    limit = 2 * PATH_ATOL * float(np.abs(ref_logp).max())
    _assert_same_ids(ids, ref_ids, ref_logp, limit)


# ----------------------------------------------------------- what else holds

def test_training_at_bf16_raises_naming_bf16b(tmp_path):
    """Training at bf16 no longer raises (the bf16b item is done): with one
    model at a time at bfloat16, ``init_state`` builds the networks in that
    dtype, ``make_train_step`` a step, and ``train`` runs a step on a small
    corpus; the name is kept from when these raised."""
    from aas_enhancement_tpu_torch.data.synthetic import generate_corpus
    from aas_enhancement_tpu_torch.train.loop import init_state, train
    from aas_enhancement_tpu_torch.train.steps import make_train_step
    corpus = generate_corpus(str(tmp_path / "c"), n_utts=2, seed=3)
    small = dataclasses.replace(TCFG.train, objective="aas", batch_size=2, log_every=1)
    for name in ("enhancer", "am", "discriminator"):
        one = TCFG.replace(train=small, data=dataclasses.replace(TCFG.data, num_buckets=1),
                           **{n: dataclasses.replace(getattr(TCFG, n), dtype="float32")
                              for n in ("enhancer", "am", "discriminator") if n != name})
        state = init_state(one, 0, "cpu")
        net = {"enhancer": state.g, "am": state.am, "discriminator": state.d}[name]
        assert net.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in net.parameters())
        assert callable(make_train_step(one))
        state, records = train(one, corpus["noisy"], corpus["clean"], max_steps=1,
                               device="cpu")
        assert state.step == 1 and np.isfinite(records[-1]["loss_g"])


def test_bf16_config_loads_alike_in_both_packages():
    text = CFG.to_json()
    got = tconfig.Config.from_json(text)
    for section in ("enhancer", "am", "discriminator"):
        assert getattr(got, section).dtype == getattr(CFG, section).dtype == "bfloat16"
    assert dataclasses.asdict(got.enhancer) == dataclasses.asdict(CFG.enhancer)
    assert compute_dtype(got.am.dtype) == torch.bfloat16
    with pytest.raises(NotImplementedError, match="float16"):
        compute_dtype("float16")


def test_operator_fakes_follow_the_stream_dtype():
    with FakeTensorMode():
        x = torch.empty(2, 5, 6, 8, dtype=torch.bfloat16)
        s, lengths = torch.empty(8), torch.empty(2, dtype=torch.int64)
        y = library.masked_group_norm_act(x, s, s, lengths, 4, 1e-5, "leaky_relu", 0.2)
        assert y.dtype == torch.bfloat16 and y.shape == x.shape
        for op, g in ((library.lstm_scan_tm, 4), (library.gru_scan_tm, 3)):
            gx = torch.empty(7, 2, g * 8, dtype=torch.bfloat16)
            yf, yb = op(gx, gx, torch.empty(7, 2), torch.empty(2, 8, g * 8),
                        torch.empty(2, g * 8))
            assert yf.dtype == yb.dtype == torch.bfloat16 and yf.shape == (7, 2, 8)
        wav = torch.empty(2, 4000)
        re, im = library.stft(wav, 320, 160, "hann", True)
        assert re.dtype == torch.float32


def test_kernel_inputs_take_the_stream_dtypes():
    p = torch.zeros(3)
    assert check_kernel_inputs("k", (p,), streams=(torch.zeros(2, dtype=torch.bfloat16),),
                               stream_dtypes=krnn.STREAM_DTYPES) == torch.bfloat16
    with pytest.raises(TypeError, match="streams"):
        check_kernel_inputs("k", (p,), streams=(torch.zeros(2, dtype=torch.float16),),
                            stream_dtypes=krnn.STREAM_DTYPES)
    with pytest.raises(TypeError, match="streams"):
        check_kernel_inputs("k", (p,), streams=(torch.zeros(2), torch.zeros(
            2, dtype=torch.bfloat16)), stream_dtypes=krnn.STREAM_DTYPES)
    with pytest.raises(TypeError, match="float32"):       # parameters stay float32
        check_kernel_inputs("k", (p.bfloat16(),), streams=(torch.zeros(2),))


def test_exported_bf16_enhancer_equals_the_live_call(nets, tmp_path):
    from aas_enhancement_tpu_torch.serving import export_enhancer, load_enhancer
    _, _, _, g, _, _ = nets
    export_enhancer(TCFG, g, str(tmp_path / "art"), batch_sizes=(2,), seconds=(1.0,),
                    device="cpu")
    served = load_enhancer(str(tmp_path / "art"), "cpu")
    wav = np.stack([_wav(16000, 7), _wav(16000, 8)])
    live = make_enhance_fn(TCFG, "cpu")(g, torch.from_numpy(wav),
                                        torch.tensor([16000, 16000]))
    got = served.enhance(wav)
    np.testing.assert_array_equal(np.asarray(got), live.numpy())


def test_serve_cli_runs_a_bf16_checkpoint(tmp_path):
    """``cli.serve`` (enhance mode, --device cpu) on a train-CLI directory
    whose config is bf16: one session's audio is the bf16 StreamingEnhancer's
    over the same weights at the server's operating point."""
    import threading

    from aas_enhancement_tpu_torch.cli import serve as serve_cli
    from aas_enhancement_tpu_torch.serve import enhance_via_server
    from aas_enhancement_tpu_torch.train.loop import init_state, load_state
    from aas_enhancement_tpu_torch.utils import checkpoint as ckpt

    f32 = TCFG.replace(**{n: dataclasses.replace(getattr(TCFG, n), dtype="float32")
                          for n in ("enhancer", "am", "discriminator")})
    def paired(c):
        return c.replace(train=dataclasses.replace(c.train, objective="paired"))

    d = tmp_path / "ck"
    d.mkdir()
    (d / "config.json").write_text(paired(TCFG).to_json())
    ckpt.save(str(d), 1, init_state(paired(f32), 0, "cpu"))
    server, line = serve_cli.start_server(["--checkpoint", str(d), "--port", "0",
                                           "--max-streams", "2", "--device", "cpu"])
    wav, got = _wav(14000, 9), {}
    try:
        client = threading.Thread(target=lambda: got.update(
            y=enhance_via_server(server.address, wav, timeout=60.0)))
        client.start()
        client.join(timeout=60.0)
        assert not client.is_alive()
    finally:
        server.stop()
    g = load_state(str(d), "cpu")[0].g.eval()
    assert g.dtype == torch.bfloat16
    eng = StreamingEnhancer(TCFG, g, chunk_seconds=line["chunk_s"],
                            lookahead_seconds=line["lookahead_s"],
                            history_seconds=line["history_s"], device="cpu")
    ref = np.concatenate([eng.feed(wav), eng.flush()])
    assert got["y"].shape == wav.shape
    _close(got["y"], ref, atol=PATH_ATOL, rtol=0)
