"""The port's accuracy sweep (``scripts/torch_accuracy_sweep.py``) against
the JAX side's (``scripts/accuracy_sweep.py``) on the same confusable
corpus and the vendored synthetic-corpus serving checkpoint at full width:
6 pieces of 40 onsets, seed 31, both gallery modes, all four arms.

Tolerances:
  * the statistics (``mcnemar_exact``, ``paired_delta_ci``) and the
    constants: equal (the same Python);
  * float32 arms (f32-highest, f32-high, u16 and u8 wires): every cell and
    comparison entry equal to JAX's (the ranks, counts, margins and CIs:
    both packages' float32 codes agree to 1e-5, far inside this corpus's
    vote margins);
  * bf16 arms: each onset (gating) cell's rank<=1 within JAX's own
    discordance between its bf16 and f32-highest arms in that cell (b + c
    of its ``bf16+u16 vs f32-highest+u16`` comparison, 1 where that is
    0); in both modes every row of the port's bf16 gallery nearer JAX's
    bf16 row than JAX's float32 row, the rule
    ``tests/test_torch_precision.py`` applies to codes;
  * bf16-fcp: the same keys and query counts as JAX's, its galleries
    built through the feature-window gather's plain version on the CPU
    (JAX's is its Pallas kernel; the two planes differ in bf16 rounding).
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from audio_sheet_retrieval_tpu.utils import profiling as jprofiling
from audio_sheet_retrieval_tpu_torch.ops import windows as win
import torch_port_helpers  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--n_pieces", "6", "--n_onsets", "40", "--seeds", "31",
        "--modes", "onset,stride"]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jsweep = _script("accuracy_sweep")
tsweep = _script("torch_accuracy_sweep")

EPQS = [epq for epq, _ in jsweep.DIFFICULTY]
F32_LABELS = ["f32-highest+u16", "f32-high+u16", "f32-high+u8"]
BF16_LABELS = ["bf16+u16", "bf16+u8"]
F32_COMPARISONS = [(a, b) for a, b, _ in jsweep.COMPARISONS
                   if a.startswith("f32") and b.startswith("f32")]


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """-> (JAX's output, the port's, the port's dumped file, the dtype of
    each plane the port's feature-window gather saw)."""
    out_file = str(tmp_path_factory.mktemp("sweep") / "sweep.json")
    planes = []
    plain = win.gather_feature_windows_plain

    def spy(plane, starts, n_cols):
        planes.append(plane.dtype)
        return plain(plane, starts, n_cols)

    with pytest.MonkeyPatch.context() as mp:
        # the JAX script's compile cache is process-wide state
        mp.setattr(jprofiling, "enable_compile_cache", lambda *a, **k: None)
        want = jsweep.main(list(ARGV))
        mp.setattr(win, "gather_feature_windows_plain", spy)
        got = tsweep.main(ARGV + ["--device", "cpu", "--out", out_file])
    with open(out_file) as fp:
        dumped = json.load(fp)
    return want, got, dumped, planes


def test_constants_equal_jax():
    for name in ("LADDER", "DIFFICULTY", "MODES", "COMPARISONS"):
        assert getattr(tsweep, name) == getattr(jsweep, name), name
    parser = tsweep.build_arg_parser()
    assert parser.get_default("device") == "cuda"
    for flag, default in (("n_pieces", 300), ("n_onsets", 120),
                          ("seeds", "31"), ("only", None),
                          ("modes", "onset,stride"), ("out", None)):
        assert parser.get_default(flag) == default, flag


def test_bf16_arms_keep_the_default_precision():
    """The bf16 arms carry JAX's ``conv_precision="default"``, which a
    bfloat16 ``compute_dtype`` ignores in both packages: the port reads it
    as its bf16 mode (float32 "default" is the TF32 mode)."""
    from audio_sheet_retrieval_tpu_torch.models import cca_model as tcca
    from audio_sheet_retrieval_tpu_torch.models import encoder as tenc
    from audio_sheet_retrieval_tpu_torch.models.configs import (
        get_model_config,
    )

    cfg0 = get_model_config("mutopia_ccal_cont_rsz")
    modes = {}
    for base in ("f32-highest", "f32-high", "bf16", "bf16-fcp"):
        cfg, _, gal_kw = tsweep.arm_config(cfg0, base)
        modes[base] = (cfg.conv_precision, tcca.check_numerics(cfg),
                       gal_kw["fullconv"])
    assert modes == {"f32-highest": ("highest", tenc.HIGHEST, False),
                     "f32-high": ("high", tenc.HIGHEST, False),
                     "bf16": ("default", tenc.BF16, False),
                     "bf16-fcp": ("default", tenc.BF16, True)}


@pytest.mark.parametrize("hi", [4, 12, 40])
def test_mcnemar_exact_equals_jax(hi):
    pairs = [(b, c) for b in range(hi - 4, hi + 1) for c in range(hi + 1)]
    pairs += [(5, 0), (0, 5), (3, 3), (9, 1), (300, 310), (0, 0)]
    for b, c in pairs:
        assert tsweep.mcnemar_exact(b, c) == jsweep.mcnemar_exact(b, c), \
            (b, c)
    assert tsweep.mcnemar_exact(9, 1) == pytest.approx(22 / 1024)


@pytest.mark.parametrize("n", [1, 2, 5, 100, 4500])
def test_paired_delta_ci_equals_jax(n):
    rng = np.random.default_rng(n)
    for p in (0.0, 0.2, 0.5, 0.9):
        a = rng.random(n) < 0.5
        b = np.where(rng.random(n) < p, ~a, a)
        assert tsweep.paired_delta_ci(a, b) == jsweep.paired_delta_ci(a, b)
    # JAX's own cases (tests/test_data.py)
    a = np.array([1, 1, 0, 1, 0], bool)
    b = np.array([1, 1, 0, 0, 0], bool)
    assert tsweep.paired_delta_ci(a, a) == (0.0, (0.0, 0.0))
    d, ci = tsweep.paired_delta_ci(a, b)
    assert d == pytest.approx(0.2) and ci[0] < 0 < ci[1]
    assert (d, ci) == jsweep.paired_delta_ci(a, b)


def test_layout_equals_jax(sweeps):
    want, got, dumped, _ = sweeps
    assert dumped == got
    assert list(got) == list(want)
    assert sorted(got["cells"]) == sorted(want["cells"])
    assert sorted(got["comparisons"]) == sorted(want["comparisons"])
    assert got["notes"] == want["notes"]
    for key in ("n_pieces", "n_onsets", "seeds"):
        assert got[key] == want[key], key
    for key, cell in got["cells"].items():
        assert list(cell) == list(want["cells"][key]), key
    for key, cmp in got["comparisons"].items():
        assert list(cmp) == list(want["comparisons"][key]), key


@pytest.mark.parametrize("mode", ["onset", "stride"])
@pytest.mark.parametrize("label", F32_LABELS)
def test_f32_cells_equal_jax(sweeps, label, mode):
    want, got = sweeps[0]["cells"], sweeps[1]["cells"]
    for epq, qpp in jsweep.DIFFICULTY:
        key = f"{label}|{mode}|e{epq}"
        assert got[key] == want[key], key
        assert got[key]["n"] == 6 * qpp


@pytest.mark.parametrize("mode", ["onset", "stride"])
@pytest.mark.parametrize("pair", F32_COMPARISONS, ids=lambda p: p[0])
def test_f32_comparisons_equal_jax(sweeps, pair, mode):
    want, got = sweeps[0]["comparisons"], sweeps[1]["comparisons"]
    for epq in EPQS:
        key = f"{pair[0]} vs {pair[1]}|{mode}|e{epq}"
        assert got[key] == want[key], key


def test_high_equals_highest_query_for_query(sweeps):
    """``high`` runs highest's float32 code in the port: no discordant
    pair in any cell."""
    got = sweeps[1]["comparisons"]
    for mode in jsweep.MODES:
        for epq in EPQS:
            cmp = got[f"f32-high+u16 vs f32-highest+u16|{mode}|e{epq}"]
            assert cmp["discordant_a_only"] == cmp["discordant_b_only"] == 0


@pytest.mark.parametrize("label", BF16_LABELS)
def test_bf16_onset_cells_within_jax_discordance(sweeps, label):
    """The bf16 outcome rule (module docstring) over the sweep's gating
    (onset) cells."""
    want, got = sweeps[0], sweeps[1]
    for epq, qpp in jsweep.DIFFICULTY:
        key = f"{label}|onset|e{epq}"
        jcmp = want["comparisons"][f"bf16+u16 vs f32-highest+u16|onset|"
                                   f"e{epq}"]
        slack = max(1, jcmp["discordant_a_only"]
                    + jcmp["discordant_b_only"])
        assert got["cells"][key]["n"] == want["cells"][key]["n"] == 6 * qpp
        assert abs(got["cells"][key]["rank1"]
                   - want["cells"][key]["rank1"]) <= slack, (key, slack)


@pytest.mark.parametrize("mode", ["onset", "stride"])
def test_bf16_gallery_rows_nearer_jax_bf16_than_f32(mode):
    """Every row of the port's bf16 gallery lies nearer JAX's bf16 row than
    JAX's float32 row (max abs difference), in both modes. This is what
    the stride cells are held to: they are diagnostic-only in both sweeps
    (most of their margins lie within 3 votes of a tie), and there the
    port's bf16 and JAX's flip different near-tie queries (2 and 3
    queries apart at e25 where JAX's bf16 moved 1 from float32)."""
    import jax

    from audio_sheet_retrieval_tpu import assets
    from audio_sheet_retrieval_tpu.data import synthetic as jsyn
    from audio_sheet_retrieval_tpu.models import cca_model as jcca
    from audio_sheet_retrieval_tpu.retrieval import accuracy as jacc
    from audio_sheet_retrieval_tpu.utils import io as juio

    cfg0, tparams = tsweep.load_params("cpu")
    jparams = juio.load_pytree(
        assets.asset_path("synth_serving_ckpt.pkl"),
        like=jcca.init_model(jax.random.PRNGKey(0), cfg0))
    images, _, o2cs, _ = jsyn.make_confusable_piece_list(31, 6, n_onsets=40)
    coords = [oc[0][:, 1] for oc in o2cs] if mode == "onset" else None
    rows = {}
    for base in ("f32-highest", "bf16"):
        cfg = tsweep.arm_config(cfg0, base)[0]
        jgal = jacc.build_piece_gallery(jparams, cfg, images, coords=coords)
        rows[base] = np.asarray(jgal.gallery_n[:jgal.n])
    port = tsweep.build_gallery(tparams, cfg0, "bf16", mode, images, coords,
                                device="cpu").gallery_n.numpy()
    to_bf16 = np.abs(port - rows["bf16"]).max(1)
    to_f32 = np.abs(port - rows["f32-highest"]).max(1)
    assert port.shape == rows["bf16"].shape
    assert (to_bf16 < to_f32).all(), int((to_bf16 >= to_f32).sum())


def test_bf16_fcp_runs_the_gather_on_bf16_planes(sweeps):
    want, got, _, planes = sweeps
    fcp = sorted(k for k in want["cells"] if k.startswith("bf16-fcp+"))
    assert fcp == sorted(k for k in got["cells"]
                         if k.startswith("bf16-fcp+"))
    assert len(fcp) == 6
    for key in fcp:
        assert got["cells"][key]["n"] == want["cells"][key]["n"]
    # one plane a piece in each mode's build, in bf16, and no other arm
    # took the fullconv path
    import torch

    assert planes == [torch.bfloat16] * 12


def test_one_width_a_corpus(monkeypatch):
    """The port embeds each strip at its own width, JAX pads to the
    widest: the sweep refuses a corpus where the two would differ."""
    from audio_sheet_retrieval_tpu_torch.data import synthetic

    real = synthetic.make_confusable_piece_list

    def ragged(*a, **k):
        images, specs, o2cs, kinds = real(*a, **k)
        images[1] = images[1][:, :-8]
        return images, specs, o2cs, kinds

    monkeypatch.setattr(synthetic, "make_confusable_piece_list", ragged)
    with pytest.raises(ValueError, match="strip widths"):
        tsweep.seed_corpus(31, 3, 40)
