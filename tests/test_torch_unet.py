"""PyTorch port, the OMR U-Net (``models/unet.py``), held against the JAX
package's ``models/unet.py`` on the CPU from the same numpy arrays.

Tolerances and why:

* float32: both packages run the same float32 operations in another
  summation order (oneDNN against XLA's convolutions), so maps and every
  stage agree to float32 noise: 1e-5 relative to the stage's scale
  (``F32_RTOL``). Random U-Nets carry random BN statistics (identity BN,
  as the JAX package's own test nets use, would hide the BN order).
* bfloat16: both round each conv's output and every BN term to bf16, in
  other orders and, in XLA, with excess precision kept across fused
  elementwise ops, so the two bf16 maps differ by bf16 noise. Held on a
  real page tile with the shipped system weights (random weights are no
  probe: their activations grow several-fold a layer and bf16's error
  with them): the port's bf16 map no farther from JAX's bf16 map than
  JAX's bf16 map is from JAX's float32 one, and nearer JAX's bf16 map
  than JAX's float32 one (the run really is bf16).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu import assets as jassets
from audio_sheet_retrieval_tpu.models import unet as junet
from audio_sheet_retrieval_tpu.omr import inference as jinf
from audio_sheet_retrieval_tpu_torch.models import unet as tunet
from audio_sheet_retrieval_tpu_torch.models.encoder import pin_full_f32
from audio_sheet_retrieval_tpu_torch.utils.image_io import imread_gray
import torch_port_helpers  # noqa: F401  (one torch thread a process)

F32_RTOL = 1e-5
STAGES = [f"enc{i}" for i in range(8)] + [f"dec{j}" for j in range(3)]


def random_unet_arrays(seed):
    """99 arrays in the checkpoint layout, random BN statistics."""
    rng = np.random.default_rng(seed)
    arrays = []

    def bn(c):
        arrays.append(rng.normal(0, 0.1, c).astype("f"))      # beta
        arrays.append(rng.uniform(0.5, 1.0, c).astype("f"))   # gamma
        arrays.append(rng.normal(0, 0.1, c).astype("f"))      # mean
        arrays.append(rng.uniform(0.5, 1.0, c).astype("f"))   # inv_std

    def conv_bn(cin, cout, k=3):
        arrays.append(rng.standard_normal((cout, cin, k, k)).astype("f")
                      * np.float32(1.0 / np.sqrt(cin * k * k)))
        bn(cout)

    for cin, cout in [(1, 8), (8, 8), (8, 16), (16, 16), (16, 32), (32, 32),
                      (32, 64), (64, 64)]:
        conv_bn(cin, cout)
    for cin, cout in [(64, 32), (32, 16), (16, 8)]:
        arrays.append(rng.standard_normal((cin, cout, 2, 2)).astype("f")
                      * np.float32(0.3))
        bn(cout)
        bn(cout)
        conv_bn(cout, cout)
        conv_bn(cout, cout)
    arrays.append(rng.standard_normal((1, 8, 1, 1)).astype("f"))
    arrays.append(rng.normal(0, 0.5, 1).astype("f"))
    assert len(arrays) == tunet.N_ARRAYS
    return arrays


def jax_tree_numpy(params):
    return jax.tree.map(np.asarray, params)


def assert_trees_equal(got, want, path="tree"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.fixture(scope="module", params=[0, 1], ids=["seed0", "seed1"])
def random_pair(request):
    arrays = random_unet_arrays(request.param)
    return (junet.import_unet_params(arrays),
            tunet.import_unet_params(arrays, "cpu"))


@pytest.fixture(scope="module")
def page_tile():
    """A 512 x 512 tile of the tutorial page, [0, 1] float, on the page's
    u16 wire codes (what the U-Net sees in either package)."""
    page = jinf.prepare_image(imread_gray(jassets.tutorial_sheet_path()))
    q = np.round(np.clip(page[100:612, 100:612], 0, 1) * 65535.0)
    return q.astype(np.float32) * np.float32(1.0 / 65535.0)


def test_maps_and_every_stage_match_jax(random_pair):
    jparams, net = random_pair
    x = np.random.default_rng(7).random((2, 64, 96)).astype(np.float32)
    want, want_inter = junet.unet_apply(
        jparams, jnp.asarray(x[..., None]), return_intermediates=True)
    got, got_inter = net(torch.from_numpy(x[:, None]),
                         return_intermediates=True)
    assert got.shape == (2, 64, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_RTOL)
    assert sorted(got_inter) == sorted(STAGES)
    for name in STAGES:
        w = np.asarray(want_inter[name])                     # NHWC
        g = got_inter[name].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=F32_RTOL * np.abs(w).max(),
                                   err_msg=name)


def test_tconv_matches_jax_and_the_manual_expansion():
    rng = np.random.default_rng(1)
    x = rng.random((1, 3, 4, 2)).astype(np.float32)      # NHWC
    w = rng.random((2, 5, 2, 2)).astype(np.float32)      # (Cin, Cout, 2, 2)
    got = tunet.tconv2x2(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                         torch.from_numpy(w)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == (1, 6, 8, 5)
    np.testing.assert_allclose(got, np.asarray(junet._tconv2x2(
        jnp.asarray(x), jnp.asarray(w))), rtol=0, atol=1e-6)
    for i in range(3):
        for j in range(4):
            for k in range(2):
                for l in range(2):
                    want = np.einsum("c,co->o", x[0, i, j], w[:, :, k, l])
                    np.testing.assert_allclose(got[0, 2 * i + k, 2 * j + l],
                                               want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fmt", ["npz", "pkl"])
@pytest.mark.parametrize("kind", ["system", "bar", "note"])
def test_vendored_weights_import_bit_for_bit(tmp_path, kind, fmt):
    path = jassets.omr_weights_path(kind)
    if fmt == "pkl":
        arrays = jassets.load_raw_arrays(path)
        path = str(tmp_path / f"{kind}_params.pkl")
        with open(path, "wb") as fp:
            pickle.dump(arrays, fp, protocol=2)
    want = jax_tree_numpy(junet.load_unet_checkpoint(path))
    net = tunet.load_unet_checkpoint(path, "cpu")
    assert_trees_equal(net.to_numpy(), want)


def test_import_checks_the_array_count():
    arrays = random_unet_arrays(0)
    with pytest.raises(ValueError, match="expected 99 arrays"):
        tunet.import_unet_params(arrays[:-1], "cpu")


def test_params_from_numpy_round_trip(random_pair):
    jparams, _ = random_pair
    tree = jax_tree_numpy(jparams)
    net = tunet.unet_params_from_numpy(tree, "cpu")
    assert_trees_equal(net.to_numpy(), tree)
    x = np.random.default_rng(3).random((1, 32, 40)).astype(np.float32)
    np.testing.assert_allclose(
        net(torch.from_numpy(x[:, None])).numpy(),
        np.asarray(junet.unet_apply(jparams, jnp.asarray(x[..., None]))),
        rtol=0, atol=F32_RTOL)


def test_high_is_highest(random_pair):
    _, net = random_pair
    high = net.with_numerics("float32", "high")
    x = torch.from_numpy(
        np.random.default_rng(4).random((1, 1, 32, 48)).astype(np.float32))
    assert torch.equal(high(x), net(x))


def test_bfloat16_against_jax_bfloat16(page_tile):
    arrays = jassets.load_raw_arrays(jassets.omr_weights_path("system"))
    jparams = junet.import_unet_params(arrays)
    net = tunet.import_unet_params(arrays, "cpu", compute_dtype="bfloat16",
                                   conv_precision="default")
    x = page_tile[None, :256, :256]
    j32 = np.asarray(junet.unet_apply(jparams, jnp.asarray(x[..., None])))
    j16 = np.asarray(junet.unet_apply(jparams, jnp.asarray(x[..., None]),
                                      compute_dtype="bfloat16",
                                      conv_precision="default"))
    got = net(torch.from_numpy(x[:, None]))
    assert got.dtype == torch.float32          # the head and sigmoid in f32
    got = got.numpy()
    bf16_own = np.abs(j16 - j32).max()
    assert bf16_own > 1e-3                     # JAX's bf16 arm is bf16
    assert np.abs(got - j16).max() <= bf16_own
    assert np.abs(got - j16).mean() < np.abs(got - j32).mean()


def test_numerics_are_checked():
    """float32 ``default`` runs (one TF32 pass on a card; float32 on the
    CPU, as JAX's CPU runs DEFAULT): the map and every stage against
    JAX's ``default`` at the float32 tolerance, TF32 off again after it
    (as a card's U-Net sets it, ``encoder.pin_full_f32``). Unknown names
    raise."""
    pin_full_f32()
    jparams = junet.import_unet_params(random_unet_arrays(2))
    tree = jax_tree_numpy(jparams)
    net = tunet.unet_params_from_numpy(tree, "cpu", conv_precision="default")
    assert net.tf32 and net.dtype == torch.float32
    x = np.random.default_rng(9).random((2, 64, 96)).astype(np.float32)
    want, want_inter = junet.unet_apply(
        jparams, jnp.asarray(x[..., None]), return_intermediates=True,
        conv_precision="default")
    got, got_inter = net(torch.from_numpy(x[:, None]),
                         return_intermediates=True)
    assert not torch.backends.cudnn.allow_tf32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_RTOL)
    for name in STAGES:
        w = np.asarray(want_inter[name])
        np.testing.assert_allclose(got_inter[name].permute(0, 2, 3, 1).numpy(),
                                   w, rtol=0, atol=F32_RTOL * np.abs(w).max(),
                                   err_msg=name)
    assert not tunet.unet_params_from_numpy(tree, "cpu",
                                            conv_precision="high").tf32
    with pytest.raises(ValueError, match="compute_dtype"):
        tunet.unet_params_from_numpy(tree, "cpu", compute_dtype="bf16")
    with pytest.raises(ValueError, match="conv_precision"):
        tunet.unet_params_from_numpy(tree, "cpu", conv_precision="fast")
