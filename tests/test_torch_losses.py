"""The port's ranking objectives against the JAX package's, on the CPU.

Every case of ``tests/test_losses.py`` runs through both packages on the
same seeded numpy latents, and each loss's gradient with respect to both
inputs is held against ``jax.grad`` of the JAX loss.

Tolerances: values rtol 1e-5 (the kiros sum-form 1e-4, as its numpy test:
a sum of n^2 hinge terms), gradients atol 1e-6 (float32 sums of at most
n^2 = 169 terms of O(1/n^2) each, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu.ops import losses as jl
from audio_sheet_retrieval_tpu_torch.ops import losses as tl

import torch_port_helpers  # noqa: F401  (one torch thread per test process)


def _rand_latents(rng, n=13, d=8, normalize=True):
    a = rng.standard_normal((n, d)).astype(np.float32)
    b = rng.standard_normal((n, d)).astype(np.float32)
    if normalize:
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        b /= np.linalg.norm(b, axis=1, keepdims=True)
    return a, b


def both(name, a, b, **kw):
    """-> (JAX value, port value) of loss ``name`` on numpy ``a``, ``b``."""
    want = float(getattr(jl, name)(jnp.asarray(a), jnp.asarray(b), **kw))
    got = float(getattr(tl, name)(torch.from_numpy(a), torch.from_numpy(b),
                                  **kw))
    return want, got


@pytest.mark.parametrize("symmetric", [False, True])
def test_contrastive_cos_loss_matches_jax(symmetric):
    a, b = _rand_latents(np.random.default_rng(0))
    want, got = both("contrastive_cos_loss", a, b, weight=0.8, gamma=0.7,
                     symmetric=symmetric)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_kiros_loss_matches_jax():
    a, b = _rand_latents(np.random.default_rng(1))
    want, got = both("contrastive_loss_kiros", a, b, gamma=0.7)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_arccos_loss_matches_jax():
    a, b = _rand_latents(np.random.default_rng(2))
    want, got = both("contrastive_arccos_loss", a, b, weight=0.5, gamma=0.7)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_cos2_loss_matches_jax():
    a, b = _rand_latents(np.random.default_rng(3))
    want, got = both("cos2_distance_loss", a, b, weight=0.25)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_perfect_alignment_has_low_loss_in_both():
    rng = np.random.default_rng(4)
    a, _ = _rand_latents(rng, n=16)
    b = rng.standard_normal(a.shape).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    same = both("contrastive_cos_loss", a, a.copy(), gamma=0.7)
    rand = both("contrastive_cos_loss", a, b, gamma=0.7)
    np.testing.assert_allclose(same[1], same[0], rtol=1e-5)
    np.testing.assert_allclose(rand[1], rand[0], rtol=1e-5)
    assert same[1] < rand[1]


@pytest.mark.parametrize("factory, args, name, kw", [
    ("get_contrastive_cos_loss", (1.0, 0.7), "contrastive_cos_loss", {}),
    ("get_contrastive_cos_loss", (0.5, 0.3, True), "contrastive_cos_loss",
     dict(weight=0.5, gamma=0.3, symmetric=True)),
    ("get_contrastive_loss_kiros", (1.0, 0.7), "contrastive_loss_kiros", {}),
    ("get_contrastive_arccos_loss", (0.5, 0.7), "contrastive_arccos_loss",
     dict(weight=0.5)),
    ("get_cos2_distance_loss", (0.25,), "cos2_distance_loss",
     dict(weight=0.25)),
])
def test_factories_match_partials_and_jax(factory, args, name, kw):
    a, b = _rand_latents(np.random.default_rng(5))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = float(getattr(tl, factory)(*args)(ta, tb))
    np.testing.assert_allclose(got, float(getattr(tl, name)(ta, tb, **kw)),
                               rtol=1e-6)
    want = float(getattr(jl, factory)(*args)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("name, kw", [
    ("contrastive_cos_loss", dict(weight=0.8, gamma=0.7)),
    ("contrastive_cos_loss", dict(gamma=0.7, symmetric=True)),
    ("contrastive_loss_kiros", dict(gamma=0.7)),
    ("contrastive_arccos_loss", dict(weight=0.5, gamma=0.7)),
    ("cos2_distance_loss", dict(weight=0.25)),
])
def test_input_gradients_match_jax(name, kw):
    """d loss / d lv1 and d lv2 through autograd against jax.grad, on
    latents scaled off the unit sphere so that the hinge clips are
    exercised (no score lands on a clip edge). The arccos loss gets unit
    latents: where a score leaves [-1, 1], JAX's gradient is NaN (0 times
    arccos' infinite slope at the clip) and the port's is 0."""
    a, b = _rand_latents(np.random.default_rng(6),
                         normalize=name == "contrastive_arccos_loss")
    if name != "contrastive_arccos_loss":
        a *= 0.4
    jg = jax.grad(lambda x, y: getattr(jl, name)(x, y, **kw), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    getattr(tl, name)(ta, tb, **kw).backward()
    for got, want in ((ta.grad, jg[0]), (tb.grad, jg[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-5)
