"""The port's device pool (``data/device_pool.py``) on the CPU against the
JAX package's ``data/device_pool.py`` and the port's host pool.

Everything here is exact: the concatenated arrays and the entity arithmetic
are numpy; a batch is an index gather of those arrays, so the port's batch
equals JAX's bit for bit wherever both compute the same indices. JAX's
draws come from a jax PRNG key, the port's from a ``torch.Generator``; the
tests recompute JAX's draws from its key exactly as its ``_make_assemble``
makes them (:69-120) and feed them to the port's ``assemble``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu.data import device_pool as jdp
from audio_sheet_retrieval_tpu_torch.data import device_pool as tdp
from audio_sheet_retrieval_tpu_torch.data import pools as tpools
from audio_sheet_retrieval_tpu_torch.data import synthetic as tsyn
from audio_sheet_retrieval_tpu_torch.data.pools import NO_AUGMENT

import torch_port_helpers  # noqa: F401  (one torch thread per test process)

FULL = dict(NO_AUGMENT, system_translation=5, sheet_scaling=[0.95, 1.05],
            onset_translation=1, spec_padding=3)
# the four branches of _make_assemble, the frequency shift, and the
# shipped augmentation (exp_configs/mutopia_full_aug.yaml: no shift)
BRANCHES = {
    "scale_and_translation": dict(NO_AUGMENT, sheet_scaling=[0.95, 1.05],
                                  system_translation=5),
    "translation_only": dict(NO_AUGMENT, system_translation=5),
    "scale_only": dict(NO_AUGMENT, sheet_scaling=[0.9, 1.1]),
    "neither": dict(NO_AUGMENT, onset_translation=2),
    "spec_padding": dict(NO_AUGMENT, spec_padding=3, onset_translation=1),
    "mutopia_full_aug": dict(NO_AUGMENT, sheet_scaling=[0.95, 1.05],
                             system_translation=5, onset_translation=1),
    "full_eval_mode": FULL,
}


@pytest.fixture(scope="module")
def pieces():
    return tsyn.make_piece_list(11, 3, n_onsets=40, n_performances=2)


def pools(pieces, augment=NO_AUGMENT, shuffle=False, seed=0):
    """(JAX DevicePool, port DevicePool on the CPU), each with its own
    numpy rng from ``seed``."""
    return (jdp.DevicePool(*pieces, data_augmentation=augment,
                           shuffle=shuffle, rng=np.random.default_rng(seed)),
            tdp.DevicePool(*pieces, data_augmentation=augment,
                           shuffle=shuffle, rng=np.random.default_rng(seed),
                           device="cpu"))


def jax_draws(key, B, aug, train) -> tdp.Draws:
    """JAX's per-sample draws of ``key``, as its ``_make_assemble`` makes
    them (split in four; uniform scale, randint translation, onset jitter
    and shift), as port ``Draws``."""
    sc, t_amp, o_amp, p_roll = tdp.amplitudes(aug, train)
    k_scale, k_trans, k_onset, k_roll = jax.random.split(key, 4)

    def t(x):
        return torch.from_numpy(np.array(x))

    return tdp.Draws(
        scale=t(jax.random.uniform(k_scale, (B,), minval=sc[0],
                                   maxval=sc[1])) if sc else None,
        trans=t(jax.random.randint(k_trans, (B,), -t_amp, t_amp + 1)
                .astype(jnp.float32)) if t_amp else None,
        onset=t(jax.random.randint(k_onset, (B,), -o_amp, o_amp + 1))
        if o_amp else None,
        shift=t(jax.random.randint(k_roll, (B,), 0, p_roll) - p_roll)
        if p_roll else None)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("short", [False, True])
def test_entities_and_arrays_bit_identical(pieces, shuffle, short):
    """Entity coordinates and onsets (the reference's bound filter and
    edge centring), the concatenated strip and spectrogram, the shuffled
    order, and the numpy rng's state after construction (the permutation,
    then the draw that seeds the key / generator) equal JAX's; ``short``
    gives one strip fewer rows (edge-padded to the tallest)."""
    images, specs, o2cs = pieces
    if short:
        images = [images[0][:-30]] + list(images[1:])
    jp, tp = pools((images, specs, o2cs), shuffle=shuffle, seed=4)
    assert tp.shape == jp.shape and tp.shape[0] > 100
    for name in ("entity_coords", "entity_onsets", "_order"):
        a, b = getattr(jp, name), getattr(tp, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert tp.strip.dtype == torch.uint8 and tp.spec.dtype == torch.float32
    assert np.array_equal(np.asarray(jp.strip), tp.strip.numpy())
    assert np.array_equal(np.asarray(jp.spec), tp.spec.numpy())
    assert (tp.strip_h, tp.bins) == (jp.strip_h, jp.bins)
    assert tp.rng.bit_generator.state == jp.rng.bit_generator.state


def test_edge_entities_are_clipped_like_jax(pieces):
    """The first and last entities of each piece sit at a strip's edges:
    their sheet windows centre on the clipped crop centre."""
    jp, tp = pools(pieces)
    n = tp.shape[0]
    for sl in (slice(0, 4), slice(n - 4, n), slice(76, 84)):
        (js, jsp), (ts, tsp) = jp[sl], tp[sl]
        assert np.array_equal(np.asarray(js), ts.numpy())
        assert np.array_equal(np.asarray(jsp), tsp.numpy())


@pytest.mark.parametrize("train", [False, True])
def test_noaug_batches_match_jax_and_host_pool(pieces, train):
    """No augmentation (``train=False``, and ``train=True`` under
    ``NO_AUGMENT``): the port's batch equals JAX's and the port's host
    pool's, bit for bit (JAX's own test holds its spectrogram to 1e-6)."""
    jp, tp = pools(pieces)
    hp = tpools.AudioScoreRetrievalPool(*pieces, shuffle=False)
    idx = np.arange(16)
    js, jsp = jp.batch(idx, train=train)
    ts, tsp = tp.batch(idx, train=train)
    hs, hsp = hp[0:16]
    assert ts.shape == (16, 1, 160, 200) and tsp.shape == (16, 1, 92, 42)
    assert ts.dtype == tsp.dtype == torch.float32
    for got, want in ((ts, js), (ts, hs), (tsp, jsp), (tsp, hsp)):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_assemble_fed_jax_draws_bit_identical(pieces, branch, train):
    """Each branch of the assembly: the port's ``assemble`` fed JAX's own
    draws gives JAX's ``_make_assemble(...)(strip, spec, coords, onsets,
    key)`` bit for bit, over three batches of 100 entities (edge
    entities among them); eval mode (``train=False``) draws nothing."""
    aug = BRANCHES[branch]
    jp, tp = pools(pieces, augment=aug)
    rng = np.random.default_rng(1)
    for b in range(3):
        sel = rng.integers(0, jp.shape[0], 100)
        sel[:2] = (0, jp.shape[0] - 1)
        coords, onsets = jp.entity_coords[sel], jp.entity_onsets[sel]
        key = jax.random.PRNGKey(100 + b)
        js, jsp = jp._assemble[train](jp.strip, jp.spec, jnp.asarray(coords),
                                      jnp.asarray(onsets), key)
        draws = jax_draws(key, 100, aug, train)
        ts, tsp = tp._assemble(tp.strip, tp.spec, torch.from_numpy(coords),
                               torch.from_numpy(onsets), draws, train)
        assert np.array_equal(np.asarray(js), ts.numpy()), (branch, b)
        assert np.array_equal(np.asarray(jsp), tsp.numpy()), (branch, b)
        if not train:
            assert draws == tdp.Draws()


def numpy_rows_and_cols(scale, trans, sh, ctx, strip_h, crop_w, centre):
    """The reference index arithmetic in numpy float32, one op at a time,
    rounding half to even (np.round)."""
    f = np.float32
    inv_s = (f(1.0) / scale.astype(f))[:, None]
    r = (np.arange(sh, dtype=f)[None, :] - f(sh / 2.0) + trans[:, None]
         ) * inv_s
    r = np.clip(np.round(f(strip_h / 2.0) + r).astype(np.int32), 0,
                strip_h - 1)
    c = centre.astype(f)[:, None] + (np.arange(ctx, dtype=f)[None, :]
                                     - f(ctx / 2.0)) * inv_s
    return r, np.clip(np.round(c).astype(np.int32), 0, crop_w - 1)


def test_assemble_rounds_half_to_even_at_exact_ties(pieces):
    """Scales whose inverse is a quarter (0.8 -> 1.25) or a half put row
    and column positions exactly on .5: the port rounds them as JAX's
    ``jnp.round`` and numpy do, to even (a reference in numpy float32)."""
    aug = BRANCHES["scale_and_translation"]
    _, tp = pools(pieces, augment=aug)
    B = 8
    scale = np.array([0.8, 0.8, 1.0, 0.5, 1.25, 0.8, 2.0, 0.95], np.float32)
    trans = np.array([0, 1, -3, 2, 5, -5, 0, 1], np.float32)
    sel = np.arange(40, 40 + B)
    coords, onsets = tp.entity_coords[sel], tp.entity_onsets[sel]
    sheet, _ = tp._assemble(tp.strip, tp.spec, torch.from_numpy(coords),
                            torch.from_numpy(onsets),
                            tdp.Draws(scale=torch.from_numpy(scale),
                                      trans=torch.from_numpy(trans)), True)
    crop_w = int(np.ceil(200 / 0.95)) + 4
    starts = np.clip(coords - crop_w // 2, 0, tp.strip.shape[1] - crop_w)
    r, c = numpy_rows_and_cols(scale, trans, 160, 200, tp.strip_h, crop_w,
                               coords - starts)
    assert np.any(np.abs(np.arange(160) * 1.25 % 1 - 0.5) < 1e-9)
    strip = tp.strip.numpy()
    want = strip[r[:, :, None], (starts[:, None] + c)[:, None, :]]
    assert np.array_equal(sheet[:, 0].numpy(), want.astype(np.float32))


@pytest.mark.parametrize("branch", ["mutopia_full_aug", "spec_padding",
                                    "translation_only"])
def test_draws_lie_in_their_ranges_and_repeat_from_a_seed(branch):
    """``draw``: each field in its range (integers where they are
    integers), None where its augmentation is off, the same from the same
    generator seed, and other draws after it."""
    aug = BRANCHES[branch]
    sc, t_amp, o_amp, p_roll = tdp.amplitudes(aug, True)
    g = torch.Generator().manual_seed(5)
    d = tdp.draw(g, 1000, aug, True)
    again = tdp.draw(torch.Generator().manual_seed(5), 1000, aug, True)
    for name, amp in zip(tdp.Draws._fields, (sc, t_amp, o_amp, p_roll)):
        x = getattr(d, name)
        assert (x is None) == (not amp), name
        if x is None:
            continue
        assert torch.equal(x, getattr(again, name)), name
        assert not torch.equal(x, getattr(tdp.draw(g, 1000, aug, True),
                                          name)), name
    if sc:
        assert d.scale.dtype == torch.float32
        assert sc[0] <= float(d.scale.min()) < float(d.scale.max()) <= sc[1]
    if t_amp:
        assert d.trans.dtype == torch.float32
        assert torch.equal(d.trans, d.trans.round())
        assert set(d.trans.tolist()) == set(range(-t_amp, t_amp + 1))
    if o_amp:
        assert set(d.onset.tolist()) == set(range(-o_amp, o_amp + 1))
    if p_roll:
        assert set(d.shift.tolist()) == set(range(-p_roll, 0))
    assert tdp.draw(g, 1000, aug, False) == tdp.Draws()


@pytest.mark.parametrize("k_samples,bs", [(40, 10), (45, 10), (None, 16)])
def test_iterator_entity_indices_and_batches_match_jax(pieces, k_samples,
                                                       bs):
    """``DeviceBatchIterator``: ``epoch_entity_indices`` over seven
    sub-epochs (several reshuffles of the pool) equals JAX's from one seed,
    wrap-around fill included; ``__iter__``'s batches (under
    ``NO_AUGMENT``) equal JAX's and the sub-epoch counter and the order
    advance alike."""
    jp, tp = pools(pieces, shuffle=True, seed=9)
    jit_ = jdp.DeviceBatchIterator(bs, k_samples=k_samples)(jp)
    tit = tdp.DeviceBatchIterator(bs, k_samples=k_samples)(tp)
    assert (tit.n_epochs, tit.n_batches, tit.k_samples) == (
        jit_.n_epochs, jit_.n_batches, jit_.k_samples)
    for _ in range(7):
        a, b = jit_.epoch_entity_indices(), tit.epoch_entity_indices()
        assert a.shape == b.shape and np.array_equal(a, b)
        assert np.array_equal(jp._order, tp._order)
    for _ in range(3):
        jb, tb = list(jit_), list(tit)
        assert len(jb) == len(tb)
        for (js, jsp), (ts, tsp) in zip(jb, tb):
            assert np.array_equal(np.asarray(js), ts.numpy())
            assert np.array_equal(np.asarray(jsp), tsp.numpy())
        assert tit.epoch_counter == jit_.epoch_counter
        assert np.array_equal(jp._order, tp._order)


def test_from_host_pool_keeps_the_augmentation(pieces):
    """``from_host_pool`` lifts a host pool's pieces with its
    augmentation, or the one given; the entities are the host pool's
    (in construction order), and the default device is the card."""
    hp = tpools.AudioScoreRetrievalPool(*pieces, data_augmentation=FULL,
                                        shuffle=False)
    dp = tdp.from_host_pool(hp, rng=np.random.default_rng(0), device="cpu")
    assert dp.data_augmentation == FULL and dp.shape == hp.shape
    assert dp.strip.device.type == "cpu"
    other = tdp.from_host_pool(hp, data_augmentation=NO_AUGMENT,
                               shuffle=False, device="cpu")
    assert other.data_augmentation == NO_AUGMENT
    assert np.array_equal(other._order, np.arange(hp.shape[0]))
    for fn in (tdp.DevicePool, tdp.from_host_pool):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
