"""The plain reference and the corpus against the port, at a tiny size on
the CPU, and the distractor moments file."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from port_bench import corpus, weights
from port_bench.harness import Bench
from port_bench.reference import plain

BENCH = Bench(ROOT)
MIX = dict(BENCH.mix("index"), pieces=3, onsets_min=12, onsets_max=20)


def test_corpus_equals_the_ports_generator():
    from audio_sheet_retrieval_tpu_torch.data.synthetic import make_piece

    c = corpus.make_corpus(2**31 + 5, MIX)
    rng = np.random.default_rng(2**31 + 5)
    lengths = rng.permutation(corpus.piece_lengths(MIX))
    assert list(lengths) == list(c.n_onsets)
    assert sorted(c.n_onsets) == [12, 16, 20]
    for n, im, spec in zip(lengths, c.images, c.specs):
        img, specs, _ = make_piece(rng, n_onsets=int(n))
        np.testing.assert_array_equal(im, img)
        np.testing.assert_array_equal(spec, specs[0])


def test_every_seed_draws_the_same_lengths():
    a = corpus.make_corpus(1, MIX)
    b = corpus.make_corpus(2**33 + 1, MIX)
    assert sorted(a.n_onsets) == sorted(b.n_onsets)
    assert sorted(im.shape[1] for im in a.images) == \
        sorted(im.shape[1] for im in b.images)


@pytest.mark.parametrize("name", ["mutopia_ccal_cont_rsz",
                                  "mutopia_ccal_cont"])
def test_reference_codes_match_the_port(name):
    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy

    config = BENCH.config(name)
    if "checkpoint" in config["weights"]:
        config["weights"]["checkpoint"] = os.path.join(
            ROOT, config["weights"]["checkpoint"])
    c = corpus.make_corpus(11, MIX)
    raw = weights.raw_weights(config, 11, c, "cpu", ROOT)
    cfg = weights.program_config(config)
    params = weights.program_params(config, cfg, raw, "cpu", ROOT)
    model = plain.Model(raw, config, device="cpu")

    g = accuracy.build_piece_gallery(params, cfg, c.images, device="cpu")
    codes, ids = plain.sheet_gallery(model, c.images, 50)
    np.testing.assert_array_equal(g.ids, ids)
    # float32 in another order (BN folded, another resize) reads up to
    # about 2.4e-5 on the CPU; one TF32 pass reads above 1e-3
    assert float((g.gallery_n - codes).abs().max()) < 1e-4

    spec = c.specs[0]
    payload, scale = win.spec_quantize(spec, bits=16)
    ref_payload, ref_scale = plain.u16_wire(spec)
    np.testing.assert_array_equal(payload, ref_payload)
    starts = win.linspace_starts(spec.shape[1], 42, 7)
    port = win.make_spec_embedder_q(params, cfg, device="cpu")(
        payload, scale, starts)
    ref = model.spec_codes(plain.u16_spectrogram(ref_payload, ref_scale,
                                                 "cpu"), starts)
    assert float((port - ref).abs().max()) < 1e-4


def test_control_precision_moves_the_codes():
    config = BENCH.config("mutopia_ccal_cont_rsz")
    raw = plain.read_checkpoint(os.path.join(ROOT, config["weights"][
        "checkpoint"]))
    c = corpus.make_corpus(3, MIX)
    st = plain.stride_starts(c.images[0].shape[1], 200, 50)
    f32 = plain.Model(raw, config, device="cpu").sheet_codes(c.images[0], st)
    tf32 = plain.Model(raw, config, device="cpu",
                       precision="tf32").sheet_codes(c.images[0], st)
    assert float((f32 - tf32).abs().max()) > 1e-4
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, 3.0])
    assert plain.round_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0, 3.0]


def test_topk_lower_index_wins_ties_as_kernel_one_does():
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import (
        topk_gallery_plain,
    )

    gen = torch.Generator().manual_seed(0)
    g = plain.normalize(torch.randn(300, 8, generator=gen))
    g[200:260] = g[5]                      # 61 tied rows across blocks
    q = plain.normalize(torch.randn(9, 8, generator=gen))
    q[0] = g[5]
    model = plain.Model(
        {"view1": [], "view2": [], "cca": {k: np.zeros(1) for k in
                                           ("U", "V", "mean1", "mean2")}},
        BENCH.config("mutopia_ccal_cont"), device="cpu")
    for k in (1, 25, 70):
        ref = plain.topk(model, q, g, k, block_rows=64)
        _, port = topk_gallery_plain(q, g, k)
        np.testing.assert_array_equal(ref.numpy(), port.numpy())


def test_votes_drop_labels_past_the_pieces():
    idx = torch.tensor([[0, 1, 2], [2, 2, 3]])
    ids = torch.tensor([0, 1, 1, 7])
    assert plain.votes(idx, ids, 2).tolist() == [1, 4]


def test_distractor_moments_load_and_are_positive_definite():
    mix = BENCH.mix("a2s-library")
    m = json.load(open(os.path.join(ROOT, mix["distractor_moments"])))
    cov = np.asarray(m["cov"])
    assert cov.shape == (32, 32) and len(m["mean"]) == 32
    np.testing.assert_allclose(cov, cov.T, atol=1e-12)
    assert np.linalg.eigvalsh(cov).min() > 0
    assert m["rows"] > 32 * 10


def test_distractors_have_the_moments():
    from port_bench.drivers import a2s

    mix = BENCH.mix("a2s-library")
    path = os.path.join(ROOT, mix["distractor_moments"])
    x = a2s.distractors(2**31 + 1, 20_000, path, "cpu")
    assert torch.allclose(torch.linalg.vector_norm(x, dim=1),
                          torch.ones(20_000), atol=1e-6)
    again = a2s.distractors(2**31 + 1, 20_000, path, "cpu")
    assert torch.equal(x, again)
    m = json.load(open(path))
    mean = np.asarray(m["mean"])
    # unit rows of Gaussians about the codes' mean point where it points
    cos = float(x.double().mean(0) @ torch.as_tensor(mean)) / (
        float(np.linalg.norm(mean)) * float(x.double().mean(0).norm()))
    assert cos > 0.9
