"""The port's ``fit`` and ``run_train`` on the CPU: against the JAX
package's ``fit`` over the host iterator, kill-and-resume within the port,
and the CLI.

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

from audio_sheet_retrieval_tpu.data import iterators as jit_
from audio_sheet_retrieval_tpu.data import synthetic as jsyn
from audio_sheet_retrieval_tpu.models import cca_model as jcm
from audio_sheet_retrieval_tpu.models.configs import get_model_config as jcfg_of
from audio_sheet_retrieval_tpu.ops import cca as jcca
from audio_sheet_retrieval_tpu.retrieval.wrapper import (
    load_any_checkpoint as jload_any,
)
from audio_sheet_retrieval_tpu.train import engine as jeng
from audio_sheet_retrieval_tpu.utils import io as juio
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


def test_fit_matches_jax_curves_and_decisions(tmp_path):
    """Four epochs through both packages: the same epochs, improvement and
    refinement decisions (the lr curve, the best epoch's dump), epoch-1
    curves close; the port's dump (unfolded, asr-tpu-v1) read by the JAX
    package's ``load_any_checkpoint`` embeds as the port's folded model."""
    jcfg = jcfg_of("mutopia_ccal_cont_rsz", **PARITY)
    cfg = get_model_config("mutopia_ccal_cont_rsz", **PARITY)
    tree = tli.train_params_to_numpy(tcm.init_model(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    jtree = jcm.ModelParams(tree.view1, tree.view2, jcca.CCAState(*tree.cca))
    runs = {}
    for name, fit, mod, it_mod, params, kw in (
            ("jax", jeng.fit, jsyn, jit_,
             jax.tree.map(jnp.asarray, jtree), dict(cfg=jcfg)),
            ("port", teng.fit, tsyn, tit,
             tli.train_params_from_numpy(tree, cfg, device="cpu"),
             dict(cfg=cfg, device="cpu"))):
        recs = []
        out = str(tmp_path / name)
        c = kw.pop("cfg")
        best, best_map = fit(
            params, parity_data(mod), c,
            it_mod.MultiviewPoolIteratorUnsupervised(20, k_samples=40),
            it_mod.MultiviewPoolIteratorUnsupervised(20, shuffle=False),
            out_path=out, dump_file=os.path.join(out, "params.pkl"),
            verbose=False, on_epoch=recs.append, **kw)
        runs[name] = (recs, best_map, juio.load_results(
            os.path.join(out, "results.pkl")), best)
    (jrecs, jbest, jcurves, _), (trecs, tbest, tcurves, tparams) = \
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
    for a, b in zip(jax.tree.leaves(juio.load_pytree(dump, like=jtree)),
                    jax.tree.leaves(jax.tree.map(np.asarray, best_tree))):
        assert np.array_equal(np.asarray(a), b)


RESUME = dict(num_filters=4, dim_latent=8, batch_size=16, k_samples=40,
              patience=50, refinement_steps=0, fit_cca=True,
              pretrain_epochs=1)


def resume_run(outdir, resume_file, n_epochs):
    """A port fit over a pool of two sub-epochs (80 pairs, k_samples 40):
    the train iterator reshuffles the pool after every second epoch. A
    CCA / BN burn-in epoch comes first (``pretrain_epochs``; a resumed run
    skips it), and the evaluation refits CCA (``fit_cca``)."""
    cfg = get_model_config("mutopia_ccal_cont_rsz", **RESUME)
    data = tsyn.load_synthetic_retrieval(
        n_train=2, n_valid=1, n_test=1, seed=5, n_onsets=40,
        augment=dict(NO_AUGMENT, sheet_scaling=[0.95, 1.05],
                     system_translation=5, onset_translation=1,
                     spec_padding=3))
    params = tcm.init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    recs = []
    teng.fit(params, data, cfg,
             tit.MultiviewPoolIteratorUnsupervised(16, k_samples=40),
             tit.MultiviewPoolIteratorUnsupervised(16, shuffle=False),
             device="cpu", out_path=outdir, num_epochs=n_epochs,
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


@pytest.fixture()
def tiny_model(monkeypatch):
    cfg = get_model_config(
        "mutopia_ccal_cont_rsz", num_filters=4, dim_latent=8, batch_size=8,
        k_samples=32, patience=0, refinement_steps=1, refinement_patience=0,
        max_epochs=2)
    cfg = dataclasses.replace(cfg, name="tiny_test")
    monkeypatch.setitem(tconfigs.MODEL_REGISTRY, "tiny_test", cfg)
    return cfg


def test_run_train_cli_resume_and_architecture(tiny_model, tmp_path, capsys):
    """``run_train --device cpu``: the artifacts (the dump in the JAX
    package's format), no snapshot left after a normal end, the
    architecture table, the host-iterator note, ``--resume`` without a
    snapshot continuing from the dump, and bf16 refused."""
    from audio_sheet_retrieval_tpu_torch.cli import run_train

    assert run_train.build_arg_parser().get_default("device") == "cuda"
    common = ["--model", "tiny_test", "--data", "synthetic", "--exp_root",
              str(tmp_path), "--device", "cpu", "--max_epochs", "1"]
    run_train.main(common + ["--show_architecture", "--tag", "t1"])
    out = capsys.readouterr().out
    assert "architecture of tiny_test" in out and "head.S12" in out
    assert run_train.DEVICE_POOL_TODO in out
    d = tmp_path / "tiny_test"
    assert (d / "params_t1.pkl").exists() and (d / "results_t1.pkl").exists()
    assert not (d / "fit_state_t1.pkl").exists()
    before = juio.load_pytree(str(d / "params_t1.pkl"))
    run_train.main(common + ["--tag", "t1", "--resume", "--host_data"])
    assert "Loading model parameters from:" in capsys.readouterr().out
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
    with pytest.raises(NotImplementedError):
        run_train.main(common + ["--compute_dtype", "bfloat16"])
