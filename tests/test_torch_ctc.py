"""Port parity: CTC loss (aas_enhancement_tpu_torch.ops.ctc) against the JAX
package's ctc_loss / ctc_loss_mean, values and gradients.

Tolerances: values rtol 1e-5 (f32 log-sum-exp over <= 30 frames on both
sides, in the same order); gradients w.r.t. the logits atol 1e-5 (they are
softmax minus posterior occupancies, each in [-1, 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from aas_enhancement_tpu.ops.ctc import ctc_loss_mean as jax_ctc_loss_mean
from aas_enhancement_tpu_torch.ops.ctc import ctc_loss, ctc_loss_mean

torch.set_num_threads(1)


def _case(seed, b=3, t=30, v=7, u=6):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    labels = rng.integers(1, v, size=(b, u)).astype(np.int32)
    logit_pad = np.zeros((b, t), np.float32)
    label_pad = np.zeros((b, u), np.float32)
    return logits, logit_pad, labels, label_pad


def _both(logits, logit_pad, labels, label_pad, **kw):
    """(per-example loss, d sum(loss * w) / d logits) from JAX and from the port."""
    w = np.linspace(0.5, 1.5, logits.shape[0]).astype(np.float32)

    def jax_f(x):
        return jnp.sum(jax_ctc_loss(x, jnp.asarray(logit_pad), jnp.asarray(labels),
                                    jnp.asarray(label_pad), **kw) * w)

    ref = np.asarray(jax_ctc_loss(jnp.asarray(logits), jnp.asarray(logit_pad),
                                  jnp.asarray(labels), jnp.asarray(label_pad), **kw))
    ref_g = np.asarray(jax.grad(jax_f)(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    got = ctc_loss(x, torch.from_numpy(logit_pad), torch.from_numpy(labels),
                   torch.from_numpy(label_pad), **kw)
    (got_g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), x)
    return (got.detach().numpy(), got_g.numpy()), (ref, ref_g)


def _check(got, ref):
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5)


def test_matches_jax_plain():
    _check(*_both(*_case(0)))


def test_padded_frames_and_labels():
    logits, logit_pad, labels, label_pad = _case(1)
    logit_pad[1, 20:] = 1.0
    logit_pad[2, 12:] = 1.0
    label_pad[1, 4:] = 1.0
    label_pad[2, 1:] = 1.0
    got, ref = _both(logits, logit_pad, labels, label_pad)
    _check(got, ref)
    assert np.all(got[1][1, 20:] == 0)         # padded frames get no gradient


def test_repeated_labels_need_a_blank_between():
    logits, logit_pad, labels, label_pad = _case(2, b=2, t=12, u=4)
    labels[:] = [[3, 3, 3, 5], [2, 2, 4, 4]]
    _check(*_both(logits, logit_pad, labels, label_pad))


def test_infeasible_alignment_is_huge_and_finite():
    """6 repeated labels need 11 frames; 5 frames cannot hold them: JAX's
    -1e30 floor gives a huge finite loss and finite gradients, as here."""
    logits, logit_pad, labels, label_pad = _case(3, b=2, t=5, u=6)
    labels[0] = 4
    got, ref = _both(logits, logit_pad, labels, label_pad)
    assert np.all(np.isfinite(got[0])) and got[0][0] > 1e29
    assert np.all(np.isfinite(got[1]))
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5)


def test_other_blank_id():
    logits, logit_pad, labels, label_pad = _case(4)
    labels[labels == 3] = 1
    _check(*_both(logits, logit_pad, labels, label_pad, blank_id=3))


@pytest.mark.parametrize("weights,denom", [(None, None), ([1, 0, 1], None),
                                           ([1, 1, 0], 1.5), (None, 4.0)])
def test_mean_with_weights_and_denom(weights, denom):
    logits, logit_pad, labels, label_pad = _case(5)
    w = None if weights is None else np.array(weights, np.float32)
    ref = jax_ctc_loss_mean(jnp.asarray(logits), jnp.asarray(logit_pad),
                            jnp.asarray(labels), jnp.asarray(label_pad),
                            weights=None if w is None else jnp.asarray(w), denom=denom)
    got = ctc_loss_mean(torch.from_numpy(logits), torch.from_numpy(logit_pad),
                        torch.from_numpy(labels), torch.from_numpy(label_pad),
                        weights=None if w is None else torch.from_numpy(w), denom=denom)
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
