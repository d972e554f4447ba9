"""One train step of every objective at bfloat16 on the CPU against the JAX
package's bf16 step, from the same converted parameters and the same batch:
``aas``, ``acoustic``, ``adversarial``, ``paired`` with the MR-STFT term,
``am`` (alone, with the KL anchor, and through the frozen enhancer) and one
blockwise fine-tuning step (``paired`` with ``streaming_finetune``).  The
metrics and every gradient of every trained network are compared.

The JAX side runs what its bf16 models run on a TPU: the BiRNN on its Pallas
route in interpret mode (a subclass whose ``impl`` defaults to "pallas", put
in the models' modules for this file, as ``tests/test_torch_bf16.py`` does),
the GroupNorm on its XLA route; f32 parameters, losses and optimizer state.
The Pallas recurrences' time chunk is pinned to 4 steps here: a tiling of
the sequential grid (the carry lives in scratch across chunks, padded steps
are masked), which changes no value and cuts interpret mode's compile time.
Nothing in the JAX package changes.

Limits (PERF.md, section 6, PR 17): metrics rtol 2e-2; each gradient
tensor within 1e-1 of the JAX tensor's norm, ||g - ref|| <= 0.1 ||ref||.
The limits first written (5e-2 x max|ref| element by element) proved finer
than JAX's own bf16 rounding: at bf16 the gradients of the layers below the
recurrences (convs, GroupNorms) are JAX's f32 gradients plus rounding noise
of 5-16% of their max (JAX bf16 against JAX f32 on the same weights and
batch: conv2.weight 0.131, gn1.bias 0.164 of max element-wise; 0.05 and 0.15
of the norm), as the port's are; the port's bf16 against JAX's bf16 is 0.03
and 0.07 of the norm there.  Three exceptions:
- conv biases: JAX sums a bf16 conv's bias cotangent in bf16 (off by up to
  ~10% of the tensor; the port sums in f32), so they are held element by
  element to 5e-2 of the network's max|g|;
- a conv bias in front of a one-channel-per-group GroupNorm (the small
  configs' 8 channels in 8 groups) has a true gradient of 0 (the group mean
  removes it); JAX's bf16 sum there is rounding noise (up to 16% of the network's max|g|), and it is
  not compared: the port's f32 sum is held to 1e-2 of the network's max|g|;
- the MR-STFT term: its gradient (sign(.) / (|X| + 1e-7) on near-silent
  bins) is ill-conditioned at bf16: on this batch JAX's own bf16 gradient is
  0.7-3.9 x its max away from its f32 gradient, and the port's the same.
  There the port's bf16 step is held to 0.35 of the norm of JAX's.
"""

import jax
import numpy as np
import pytest
import torch

import aas_enhancement_tpu.models.am as jax_am_mod
import aas_enhancement_tpu.models.enhancer as jax_enh_mod
import aas_enhancement_tpu.ops.pallas.rnn_kernel as jax_rnn_kernel
from aas_enhancement_tpu.ops.rnn import BiRNN as JaxBiRNN
from aas_enhancement_tpu.train.loop import init_state as jax_init_state
from aas_enhancement_tpu.train.steps import make_train_step as jax_make_train_step
from aas_enhancement_tpu_torch.convert import am_params_from_flax
from aas_enhancement_tpu_torch.models.am import AcousticModel
from aas_enhancement_tpu_torch.train.steps import make_train_step

from test_torch_bf16_train import bf16_config
from test_torch_train import CONVERT, _batch, _cfg, _to_torch, _torch_state

torch.set_num_threads(1)

METRIC_RTOL = 2e-2
GRAD_RTOL = 1e-1          # of the JAX tensor's norm
MR_GRAD_RTOL = 0.35       # with the MR-STFT term
NET_FLOOR = 1e-2          # x the network's max|g|: a true gradient of 0
BIAS_ATOL = 5e-2          # x the network's max|g|: conv biases
# Conv biases in front of a GroupNorm of one channel a group (conv_channels 8
# in 8 groups in ``_cfg``): a true gradient of 0.
GN_FED_BIASES = {"g": ("convs.0.bias",), "am": ("conv1.bias", "conv2.bias")}


class _PallasBiRNN(JaxBiRNN):
    """The JAX BiRNN with the route its bf16 models take on a TPU."""
    impl: str = "pallas"


@pytest.fixture(scope="module", autouse=True)
def pallas_birnn():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_enh_mod, "BiRNN", _PallasBiRNN)
        mp.setattr(jax_am_mod, "BiRNN", _PallasBiRNN)
        mp.setattr(jax_rnn_kernel, "_pick_chunk", lambda *a, **k: 4)
        yield


def _assert_step_close(cfg, grads, aux, jgrads, jaux):
    assert cfg.am.conv_channels == cfg.enhancer.conv_channels == 8    # GN_FED_BIASES
    assert set(aux) == set(jaux) and set(grads) == set(jgrads)
    for key, ref in jaux.items():
        assert float(aux[key]) == pytest.approx(float(ref), rel=METRIC_RTOL, abs=1e-6), key
    rtol = MR_GRAD_RTOL if cfg.train.lambda_mrstft > 0 else GRAD_RTOL
    for net, jg in jgrads.items():
        ref = {n: np.asarray(v) for n, v in CONVERT[net](jax.device_get(jg)).items()}
        assert set(grads[net]) == set(ref)
        net_max = max(float(np.abs(v).max()) for v in ref.values())
        assert net_max > 0
        for name, r in ref.items():
            g = grads[net][name].numpy()
            assert grads[net][name].dtype == torch.float32, (net, name)
            if name in GN_FED_BIASES.get(net, ()):
                assert np.abs(g).max() <= NET_FLOOR * net_max, (net, name)
                continue
            if "conv" in name and name.endswith("bias"):
                np.testing.assert_allclose(g, r, rtol=0, atol=BIAS_ATOL * net_max,
                                           err_msg=f"{net} {name}")
                continue
            err = float(np.linalg.norm(g - r) / np.linalg.norm(r))
            assert err <= rtol, (net, name, err)


def _run(cfg, batch, anchored=False):
    """(port grads, port metrics, JAX grads, JAX metrics) of one bf16 step."""
    jstate = jax_init_state(cfg, jax.random.key(0))
    anchor = jax_init_state(cfg, jax.random.key(5)).am_params if anchored else None
    jgrads, jaux = jax.jit(jax_make_train_step(cfg, anchor_am_params=anchor).batch_grads)(
        jstate, batch)
    tcfg, state = _torch_state(cfg, jstate)
    assert tcfg.am.dtype == tcfg.enhancer.dtype == "bfloat16"
    anchor_am = None
    if anchored:
        anchor_am = AcousticModel(tcfg.am, tcfg.audio.num_bins).requires_grad_(False)
        anchor_am.load_state_dict(am_params_from_flax(jax.device_get(anchor)))
    grads, aux = make_train_step(tcfg, anchor_am=anchor_am).batch_grads(state,
                                                                       _to_torch(batch))
    return grads, aux, jgrads, jaux


@pytest.mark.parametrize("objective,extra", [
    ("aas", {}), ("acoustic", {}), ("adversarial", {}), ("paired", {"lambda_mrstft": 0.5}),
    ("paired", {"streaming_finetune": True, "stream_chunk_s": 0.1,
                "stream_lookahead_s": 0.03, "stream_history_s": 0.05})])
def test_generator_step_at_bf16_matches_jax(objective, extra):
    """The G (and D) gradients and the metrics of one bf16 step; the last
    case is the blockwise streaming fine-tuning forward (three windows a row,
    a length-0 trailing window on the short row)."""
    cfg = bf16_config(_cfg(objective, **extra))
    batch = _batch(seed=1, weights=[1, 1, 1, 0], clean_weights=[1, 1, 1, 1])
    _assert_step_close(cfg, *_run(cfg, batch))


@pytest.mark.parametrize("anchored,through_g", [(False, False), (True, False), (False, True)])
def test_am_step_at_bf16_matches_jax(anchored, through_g):
    """One bf16 ``am`` step (2 convs, BiGRU-16, ragged batch with a weight-0
    row): alone, with the KL anchor (another AM's posteriors), and through
    the frozen bf16 enhancer."""
    cfg = bf16_config(_cfg("am", am_through_enhancer=through_g,
                           distill_lambda=0.7 if anchored else 0.0))
    batch = {k: v for k, v in _batch(seed=2, weights=[1, 1, 0, 1],
                                     clean_weights=[1, 1, 1, 1]).items()
             if not k.startswith("clean")}
    grads, aux, jgrads, jaux = _run(cfg, batch, anchored=anchored)
    assert set(grads) == {"am"} and ("loss_distill" in aux) == anchored
    _assert_step_close(cfg, grads, aux, jgrads, jaux)

