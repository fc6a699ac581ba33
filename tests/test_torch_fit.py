"""The port's ``fit`` and ``run_train`` on the CPU: against the JAX
package's ``fit`` over the host iterator and over the device pool, the
fused per-epoch evaluation against JAX's, kill-and-resume within the port
over both data paths, and the CLI.

The parity fit runs both packages from one numpy tree on the same
synthetic pools (the port's pool draws the same batches as the JAX pool,
``tests/test_torch_standalone.py``) at a learning rate of 1e-6. At the
model's 2e-3, Adam's first update is about lr * sign(g), and gradients
near zero come out with other signs in the two packages, so after a few
steps the weights differ by 2 lr in some elements: at this small size
(chance-level MRR, about 0.078 for 60 pairs) the epoch-1 train loss then
differs by 1.5 % and the improvement decisions follow float32 near-ties.
At 1e-6 the running BN statistics move the evaluation from epoch to epoch
as in training, the same in both packages, and every decision (improve,
early stop, refinement restart with the best params and optimizer state,
lr decay) can be held equal. Adam's own arithmetic is held on JAX's
gradients in ``tests/test_torch_train.py``.

Tolerances: train loss rtol 1e-3 (two float32 steps, measured
5e-5), valid loss 1e-5, MRR 1e-3 (a float32 near-tie may swap two ranks;
measured: equal).
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu.data import device_pool as jdp
from audio_sheet_retrieval_tpu.data import iterators as jit_
from audio_sheet_retrieval_tpu.data import synthetic as jsyn
from audio_sheet_retrieval_tpu.models import cca_model as jcm
from audio_sheet_retrieval_tpu.models.configs import get_model_config as jcfg_of
from audio_sheet_retrieval_tpu.ops import cca as jcca
from audio_sheet_retrieval_tpu.ops import metrics as jmetrics
from audio_sheet_retrieval_tpu.retrieval.wrapper import (
    load_any_checkpoint as jload_any,
)
from audio_sheet_retrieval_tpu.train import engine as jeng
from audio_sheet_retrieval_tpu.utils import io as juio
from audio_sheet_retrieval_tpu_torch.data import device_pool as tdp
from audio_sheet_retrieval_tpu_torch.data import iterators as tit
from audio_sheet_retrieval_tpu_torch.data import synthetic as tsyn
from audio_sheet_retrieval_tpu_torch.data.pools import NO_AUGMENT
from audio_sheet_retrieval_tpu_torch.models import cca_model as tcm
from audio_sheet_retrieval_tpu_torch.models import configs as tconfigs
from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    RetrievalWrapper,
)
from audio_sheet_retrieval_tpu_torch.train import engine as teng

import torch_port_helpers  # noqa: F401  (one torch thread per test process)

# patience 0: every epoch ends in early stopping, so two refinement
# restarts (best params and optimizer state reloaded, lr halved) and then
# the stop, within four epochs whatever the MRR does
PARITY = dict(num_filters=4, dim_latent=8, batch_size=20, k_samples=40,
              patience=0, refinement_steps=2, refinement_patience=0,
              max_epochs=4, ini_learning_rate=1e-6)


def parity_data(mod):
    return mod.load_synthetic_retrieval(n_train=3, n_valid=1, n_test=1,
                                        seed=7, n_onsets=60)


def parity_runs(tmp_path, data_of, iterators_of, **numerics):
    """Both packages' ``fit`` from one numpy tree at ``PARITY`` (and the
    config's ``numerics``, e.g. ``compute_dtype="bfloat16"``):
    ``data_of(synthetic module, package's device_pool module, port
    keywords)`` and ``iterators_of(package's iterators module, package's
    device_pool module)`` -> {"jax" | "port": (epoch records, best MRR,
    curves, best params)}."""
    jcfg = jcfg_of("mutopia_ccal_cont_rsz", **PARITY, **numerics)
    cfg = get_model_config("mutopia_ccal_cont_rsz", **PARITY, **numerics)
    tree = tli.train_params_to_numpy(tcm.init_model(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    jtree = jcm.ModelParams(tree.view1, tree.view2, jcca.CCAState(*tree.cca))
    runs = {}
    for name, fit, mod, it_mod, dp_mod, params, c, kw in (
            ("jax", jeng.fit, jsyn, jit_, jdp,
             jax.tree.map(jnp.asarray, jtree), jcfg, {}),
            ("port", teng.fit, tsyn, tit, tdp,
             tli.train_params_from_numpy(tree, cfg, device="cpu"), cfg,
             dict(device="cpu"))):
        recs = []
        out = str(tmp_path / name)
        best, best_map = fit(
            params, data_of(mod, dp_mod, kw), c,
            *iterators_of(it_mod, dp_mod),
            out_path=out, dump_file=os.path.join(out, "params.pkl"),
            verbose=False, on_epoch=recs.append, **kw)
        runs[name] = (recs, best_map, juio.load_results(
            os.path.join(out, "results.pkl")), best)
    return runs


def assert_same_decisions(runs):
    """The same epochs, improvement and refinement decisions (the lr
    curve), curves within the module's tolerances -> the port's records
    and curves."""
    (jrecs, jbest, jcurves, _), (trecs, tbest, tcurves, _) = \
        runs["jax"], runs["port"]
    assert [r["number"] for r in trecs] == [r["number"] for r in jrecs]
    assert tcurves["lr"] == jcurves["lr"]
    assert tcurves["lr"] == [1e-6, 5e-7, 2.5e-7]
    np.testing.assert_allclose(trecs[0]["train_loss"], jrecs[0]["train_loss"],
                               rtol=1e-3)
    for t, j in zip(trecs, jrecs):
        np.testing.assert_allclose(t["valid_loss"], j["valid_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(t["map_va"], j["map_va"], atol=1e-3)
        np.testing.assert_allclose(t["map_tr"], j["map_tr"], atol=1e-3)
    assert abs(tbest - jbest) <= 1e-3
    improved = [m >= max([0.0] + tcurves["map_val"][:i]) for i, m in
                enumerate(tcurves["map_val"])]
    assert improved == [m >= max([0.0] + jcurves["map_val"][:i]) for i, m
                        in enumerate(jcurves["map_val"])]
    for key in ("pred_tr_err", "map_val", "evals_tr", "rank_val"):
        assert len(tcurves[key]) == len(trecs)
    assert trecs[0]["n_batches"] == 2 and trecs[0]["loop_seconds"] > 0
    return trecs, tcurves


def test_fit_matches_jax_curves_and_decisions(tmp_path):
    """Four epochs through both packages over the host iterator: the same
    epochs, improvement and refinement decisions (the lr curve, the best
    epoch's dump), epoch-1 curves close; the port's dump (unfolded,
    asr-tpu-v1) read by the JAX package's ``load_any_checkpoint`` embeds as
    the port's folded model."""
    jcfg = jcfg_of("mutopia_ccal_cont_rsz", **PARITY)
    cfg = get_model_config("mutopia_ccal_cont_rsz", **PARITY)
    runs = parity_runs(
        tmp_path, lambda mod, dp, kw: parity_data(mod),
        lambda it, dp: (it.MultiviewPoolIteratorUnsupervised(20, k_samples=40),
                        it.MultiviewPoolIteratorUnsupervised(20,
                                                             shuffle=False)))
    trecs, _ = assert_same_decisions(runs)
    assert {r["data"] for r in trecs} == {"host iterator"}
    jlike, tparams = runs["jax"][3], runs["port"][3]
    # the dump is the best epoch's unfolded params; JAX reads it
    dump = str(tmp_path / "port" / "params.pkl")
    jparams = jload_any(dump, jcfg)
    x1, x2 = parity_data(tsyn)["valid"][0:20]
    want = jcm.embed_view1(jparams, jeng.prepare_view1_device(
        jnp.asarray(x1), jcfg), jcfg)
    got = RetrievalWrapper(cfg, param_file=dump, device="cpu",
                           batch_size=20).compute_view_1(x1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    best_tree = tli.train_params_to_numpy(tparams)
    for a, b in zip(jax.tree.leaves(juio.load_pytree(dump, like=jlike)),
                    jax.tree.leaves(jax.tree.map(np.asarray, best_tree))):
        assert np.array_equal(np.asarray(a), b)


def lifted_parity_data(mod, dp, kw):
    """``parity_data`` lifted onto device pools as both CLIs lift them
    (train shuffled from one seed, valid in order from the next)."""
    data = parity_data(mod)
    return dict(
        data,
        train=dp.from_host_pool(data["train"],
                                rng=np.random.default_rng(7), **kw),
        valid=dp.from_host_pool(data["valid"], shuffle=False,
                                rng=np.random.default_rng(8), **kw))


def test_fit_over_device_pool_matches_jax_decisions(tmp_path):
    """Four epochs through both packages over their device pools under
    ``NO_AUGMENT``, where no random draw enters a batch: the same epochs,
    improvement and refinement decisions, curves within the host test's
    tolerances (the evaluation is each package's fused arm); the train
    subset and the valid codes are read in the same order, so the rank
    curves agree too. No producer thread: the iterator wait is 0."""
    runs = parity_runs(
        tmp_path, lifted_parity_data,
        lambda it, dp: (dp.DeviceBatchIterator(20, k_samples=40),
                        dp.DeviceBatchIterator(20, shuffle=False,
                                               train=False)))
    trecs, tcurves = assert_same_decisions(runs)
    jcurves = runs["jax"][2]
    assert {r["data"] for r in trecs} == {"device pool"}
    assert all(r["wait_seconds"] == 0.0 for r in trecs)
    for key in ("rank_tr", "rank_val", "dist_tr", "dist_val"):
        np.testing.assert_allclose(tcurves[key], jcurves[key], atol=1e-3)
    np.testing.assert_allclose(tcurves["pred_tr_err"],
                               jcurves["pred_tr_err"], rtol=1e-3)


@pytest.mark.parametrize("fit_cca", [False, True])
@pytest.mark.parametrize("n_tr,n_va,noise", [(300, 200, 0.6),
                                              (1000, 1000, 1.5)])
def test_make_fused_eval_matches_jax(fit_cca, n_tr, n_va, noise):
    """``make_fused_eval`` (ranks up to 25 through kernel 1's plain version
    here, an argsort of their own row beyond) against JAX's
    ``make_fused_eval`` + ``unpack_retrieval_metrics`` (a full argsort) on
    the same codes, with and without the CCA refit: hits exact, mean rank
    and MRR to 1e-6, the median as ``jnp.median``, the mean diagonal
    distance to 1e-6. At ``noise`` 1.5 most matches lie beyond 25."""
    rng = np.random.default_rng(n_tr + fit_cca)
    d = 32
    codes = []
    for n in (n_tr, n_va):
        a = rng.standard_normal((n, d)).astype(np.float32)
        codes += [a, (a + noise * rng.standard_normal((n, d)))
                  .astype(np.float32)]
    jcfg = jcfg_of("mutopia_ccal_cont_rsz", fit_cca=fit_cca)
    cfg = get_model_config("mutopia_ccal_cont_rsz", fit_cca=fit_cca)
    want = [jmetrics.unpack_retrieval_metrics(np.asarray(v)) for v in
            jeng.make_fused_eval(jcfg)(*map(jnp.asarray, codes))]
    got = teng.make_fused_eval(cfg)(*map(torch.from_numpy, codes))
    beyond = 0
    for (gm, gmed, gdist, ghits, gmrr), (wm, wmed, wdist, whits, wmrr) in \
            zip(got, want):
        assert ghits == whits
        assert gmed == wmed
        np.testing.assert_allclose(gm, wm, rtol=1e-6)
        np.testing.assert_allclose(gmrr, wmrr, rtol=1e-6)
        np.testing.assert_allclose(gdist, wdist, atol=1e-6)
        beyond += ghits[25] < n_va
    if noise > 1:   # the argsort of the rows beyond 25 is exercised
        assert beyond == 2


RESUME = dict(num_filters=4, dim_latent=8, batch_size=16, k_samples=40,
              patience=50, refinement_steps=0, fit_cca=True,
              pretrain_epochs=1)


def resume_run(outdir, resume_file, n_epochs, device_data=False):
    """A port fit over a pool of two sub-epochs (80 pairs, k_samples 40):
    the train iterator reshuffles the pool after every second epoch. A
    CCA / BN burn-in epoch comes first (``pretrain_epochs``; a resumed run
    skips it), and the evaluation refits CCA (``fit_cca``). Every
    augmentation is on; ``device_data`` lifts both pools onto device pools
    (on the CPU) as ``run_train`` does."""
    cfg = get_model_config("mutopia_ccal_cont_rsz", **RESUME)
    data = tsyn.load_synthetic_retrieval(
        n_train=2, n_valid=1, n_test=1, seed=5, n_onsets=40,
        augment=dict(NO_AUGMENT, sheet_scaling=[0.95, 1.05],
                     system_translation=5, onset_translation=1,
                     spec_padding=3))
    params = tcm.init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    if device_data:
        data = dict(data, train=tdp.from_host_pool(
            data["train"], rng=np.random.default_rng(5), device="cpu"),
            valid=tdp.from_host_pool(data["valid"], shuffle=False,
                                     rng=np.random.default_rng(6),
                                     device="cpu"))
        iters = (tdp.DeviceBatchIterator(16, k_samples=40),
                 tdp.DeviceBatchIterator(16, shuffle=False, train=False))
    else:
        iters = (tit.MultiviewPoolIteratorUnsupervised(16, k_samples=40),
                 tit.MultiviewPoolIteratorUnsupervised(16, shuffle=False))
    recs = []
    teng.fit(params, data, cfg, *iters, device="cpu", out_path=outdir, num_epochs=n_epochs,
             verbose=False, on_epoch=recs.append, resume_file=resume_file)
    return recs, data


def test_fit_kill_and_resume_bit_identical_after_a_reshuffle(tmp_path):
    """A run stopped after epoch 2 (the pool reshuffled at its end) and
    resumed from its snapshot gives epochs 3 and 4 bit for bit as the
    uninterrupted run: params, optimizer, bookkeeping and the data order
    (the pool's rng AND its permuted ``train_entities``, which the JAX
    package's snapshot does not keep) all round-trip."""
    def key(r):
        return (float(r["train_loss"]).hex(), float(r["valid_loss"]).hex(),
                float(r["map_va"]).hex(), float(r["map_tr"]).hex())

    full, _ = resume_run(str(tmp_path / "full"), None, 4)
    snap_file = str(tmp_path / "fit_state.pkl")
    first, data = resume_run(str(tmp_path / "p1"), snap_file, 2)
    with open(snap_file, "rb") as fp:
        snap = pickle.load(fp)
    assert snap["fit_state_version"] == teng.FIT_STATE_VERSION
    saved = snap["data_state"]["train_pool"]["train_entities"]
    fresh = tsyn.load_synthetic_retrieval(n_train=2, n_valid=1, n_test=1,
                                          seed=5, n_onsets=40)["train"]
    assert not np.array_equal(saved, fresh.train_entities), \
        "no reshuffle before the stop: the test would not see the fault"
    assert np.array_equal(saved, data["train"].train_entities)
    second, _ = resume_run(str(tmp_path / "p2"), snap_file, 4)
    assert [key(r) for r in first] == [key(r) for r in full[:2]]
    assert [r["number"] for r in second] == [3, 4]
    assert [key(r) for r in second] == [key(r) for r in full[2:]]
    snap["fit_state_version"] = 0
    with open(snap_file, "wb") as fp:
        pickle.dump(snap, fp)
    with pytest.raises(ValueError, match="fit-state version"):
        resume_run(str(tmp_path / "p3"), snap_file, 5)


def test_fit_kill_and_resume_over_device_pool_bit_identical(tmp_path):
    """The same kill and resume over device pools, every augmentation on
    (its draws from the pool's generator): stopped after epoch 2, where
    the pool reshuffled, the resumed run gives epochs 3 and 4 bit for bit
    as the uninterrupted run. The snapshot holds the pool's ``_order`` and
    its generator's state; without the generator's the resumed epochs
    draw other augmentations and differ."""
    def key(r):
        return (float(r["train_loss"]).hex(), float(r["valid_loss"]).hex(),
                float(r["map_va"]).hex(), float(r["map_tr"]).hex())

    full, _ = resume_run(str(tmp_path / "full"), None, 4, device_data=True)
    assert {r["data"] for r in full} == {"device pool"}
    snap_file = str(tmp_path / "fit_state.pkl")
    first, data = resume_run(str(tmp_path / "p1"), snap_file, 2,
                             device_data=True)
    with open(snap_file, "rb") as fp:
        snap = pickle.load(fp)
    state = snap["data_state"]["train_pool"]
    assert not np.array_equal(state["order"], tdp.from_host_pool(
        tsyn.load_synthetic_retrieval(n_train=2, n_valid=1, n_test=1, seed=5,
                                      n_onsets=40)["train"],
        rng=np.random.default_rng(5), device="cpu")._order), \
        "no reshuffle before the stop: the test would not see the fault"
    assert np.array_equal(state["order"], data["train"]._order)
    assert np.array_equal(state["generator"],
                          data["train"].generator.get_state().numpy())
    assert snap["data_state"]["train_iter"]["epoch_counter"] == 3
    second, _ = resume_run(str(tmp_path / "p2"), snap_file, 4,
                           device_data=True)
    assert [key(r) for r in first] == [key(r) for r in full[:2]]
    assert [r["number"] for r in second] == [3, 4]
    assert [key(r) for r in second] == [key(r) for r in full[2:]]
    # the generator's state is what carries the augmentation draws
    for name in ("train_pool", "valid_pool"):
        del snap["data_state"][name]["generator"]
    with open(snap_file, "wb") as fp:
        pickle.dump(snap, fp)
    third, _ = resume_run(str(tmp_path / "p3"), snap_file, 4,
                          device_data=True)
    assert third[0]["train_loss"] != full[2]["train_loss"]


def test_fit_refuses_mixed_data_paths(tmp_path):
    """A device pool for training with a host pool for validation (or the
    other way round) is refused before any work."""
    cfg = get_model_config("mutopia_ccal_cont_rsz", **RESUME)
    params = tcm.init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    data = parity_data(tsyn)
    for iters in ((tdp.DeviceBatchIterator(16),
                   tit.MultiviewPoolIteratorUnsupervised(16)),
                  (tit.MultiviewPoolIteratorUnsupervised(16),
                   tdp.DeviceBatchIterator(16))):
        with pytest.raises(ValueError, match="must both be device pools"):
            teng.fit(params, data, cfg, *iters, device="cpu",
                     out_path=str(tmp_path), verbose=False)


@pytest.fixture()
def tiny_model(monkeypatch):
    cfg = get_model_config(
        "mutopia_ccal_cont_rsz", num_filters=4, dim_latent=8, batch_size=8,
        k_samples=32, patience=0, refinement_steps=1, refinement_patience=0,
        max_epochs=2)
    cfg = dataclasses.replace(cfg, name="tiny_test")
    monkeypatch.setitem(tconfigs.MODEL_REGISTRY, "tiny_test", cfg)
    return cfg


def test_run_train_cli_resume_and_architecture(tiny_model, tmp_path, capsys,
                                              monkeypatch):
    """``run_train --device cpu``: the artifacts (the dump in the JAX
    package's format), no snapshot left after a normal end, the
    architecture table, the data path each run reports (the device pool by
    default, the host iterator with ``--host_data``), ``--resume`` without
    a snapshot continuing from the dump, and ``--compute_dtype bfloat16``
    training as the JAX CLI does."""
    from audio_sheet_retrieval_tpu_torch.cli import run_train

    assert run_train.build_arg_parser().get_default("device") == "cuda"
    common = ["--model", "tiny_test", "--data", "synthetic", "--exp_root",
              str(tmp_path), "--device", "cpu", "--max_epochs", "1"]
    run_train.main(common + ["--show_architecture", "--tag", "t1"])
    out = capsys.readouterr().out
    assert "architecture of tiny_test" in out and "head.S12" in out
    assert "Training data: device pool, batches assembled on cpu" in out
    assert "host iterator" not in out
    d = tmp_path / "tiny_test"
    assert (d / "params_t1.pkl").exists() and (d / "results_t1.pkl").exists()
    assert not (d / "fit_state_t1.pkl").exists()
    before = juio.load_pytree(str(d / "params_t1.pkl"))
    run_train.main(common + ["--tag", "t1", "--resume", "--host_data"])
    out = capsys.readouterr().out
    assert "Loading model parameters from:" in out
    assert "Training data: host iterator" in out and "device pool" not in out
    assert not (d / "fit_state_t1.pkl").exists()
    after = jload_any(str(d / "params_t1.pkl"), jcfg_of(
        "mutopia_ccal_cont_rsz", num_filters=4, dim_latent=8))
    w0 = np.asarray(before.view1["blocks"][0]["w"])
    assert w0.shape == np.asarray(after.view1["blocks"][0]["w"]).shape
    assert not np.allclose(w0, np.asarray(after.view1["blocks"][0]["w"]))
    # a fresh run removes a stale snapshot instead of resuming from it
    (d / "fit_state_t2.pkl").write_bytes(b"stale")
    run_train.main(common + ["--tag", "t2", "--no_dump"])
    assert not (d / "fit_state_t2.pkl").exists()
    assert not (d / "params_t2.pkl").exists()
    # --compute_dtype bfloat16: both CLIs resume from this dump over the
    # same host batches (the tiny model at lr 1e-6, where Adam's sign
    # steps cannot pull the packages apart: see the module docstring) and
    # record the same epoch within bf16's tolerances
    # (tests/test_torch_precision.py): losses 1e-2; MRR 1e-2, as bf16's
    # near-ties move single ranks of the chance-level model (0.007
    # measured)
    from audio_sheet_retrieval_tpu.cli import run_train as jrun_train
    from audio_sheet_retrieval_tpu.models import configs as jconfigs

    over = dict(num_filters=4, dim_latent=8, batch_size=8, k_samples=32,
                max_epochs=1, ini_learning_rate=1e-6)
    monkeypatch.setitem(tconfigs.MODEL_REGISTRY, "tiny_bf16",
                        dataclasses.replace(get_model_config(
                            "mutopia_ccal_cont_rsz", **over),
                            name="tiny_bf16"))
    monkeypatch.setitem(jconfigs.MODEL_REGISTRY, "tiny_bf16",
                        dataclasses.replace(jcfg_of(
                            "mutopia_ccal_cont_rsz", **over),
                            name="tiny_bf16"))
    curves = {}
    for name, main, extra in (("port", run_train.main, ["--device", "cpu"]),
                              ("jax", jrun_train.main, [])):
        root = tmp_path / name
        (root / "tiny_bf16").mkdir(parents=True)
        (root / "tiny_bf16" / "params_t3.pkl").write_bytes(
            (d / "params_t1.pkl").read_bytes())
        main(["--model", "tiny_bf16", "--data", "synthetic", "--exp_root",
              str(root), "--tag", "t3", "--resume", "--host_data",
              "--no_dump", "--compute_dtype", "bfloat16"] + extra)
        curves[name] = juio.load_results(
            str(root / "tiny_bf16" / "results_t3.pkl"))
    assert "Training data: host iterator" in capsys.readouterr().out
    got, want = curves["port"], curves["jax"]
    assert got["lr"] == want["lr"] == [1e-6]
    for key in ("pred_tr_err", "pred_val_err"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-2)
    np.testing.assert_allclose(got["map_val"], want["map_val"], atol=1e-2)


def test_run_train_device_pool_writes_the_host_paths_artifacts(
        tiny_model, tmp_path, monkeypatch):
    """``run_train`` without ``--host_data`` trains over device pools
    (``fit`` sees ``DeviceBatchIterator``s over ``DevicePool``s on the
    CPU) and writes the artifacts the host path writes: the same files,
    the same curves, each a record an epoch, and a dump the JAX package
    reads."""
    from audio_sheet_retrieval_tpu_torch.cli import run_train

    seen = {}
    fit = teng.fit

    def spy(params, data, cfg, train_it, valid_it, **kw):
        seen.setdefault("paths", []).append(
            (type(data["train"]).__name__, type(train_it).__name__,
             type(valid_it).__name__, getattr(valid_it, "train", None)))
        return fit(params, data, cfg, train_it, valid_it, **kw)

    monkeypatch.setattr(run_train.engine, "fit", spy)
    files, curves = {}, {}
    for flag in ("", "--host_data"):
        root = tmp_path / (flag or "device")
        argv = ["--model", "tiny_test", "--data", "synthetic", "--exp_root",
                str(root), "--device", "cpu", "--max_epochs", "2"]
        run_train.main(argv + ([flag] if flag else []))
        d = root / "tiny_test"
        files[flag] = sorted(os.listdir(d))
        curves[flag] = juio.load_results(str(d / "results.pkl"))
        jload_any(str(d / "params.pkl"), jcfg_of(
            "mutopia_ccal_cont_rsz", num_filters=4, dim_latent=8))
    assert seen["paths"] == [
        ("DevicePool", "DeviceBatchIterator", "DeviceBatchIterator", False),
        ("AudioScoreRetrievalPool", "MultiviewPoolIteratorUnsupervised",
         "MultiviewPoolIteratorUnsupervised", None)]
    assert files[""] == files["--host_data"] == ["params.pkl", "results.pkl"]
    assert sorted(curves[""]) == sorted(curves["--host_data"])
    for key, v in curves[""].items():
        assert len(v) == len(curves["--host_data"][key]) == 2, key
