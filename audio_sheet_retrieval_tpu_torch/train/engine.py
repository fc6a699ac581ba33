"""Training engine: the train step and the reference's fit / refinement loop.

The port of the JAX package's ``train/engine.py``. Control-flow parity
with reference:utils/train_dcca_pool.py:
  * per-epoch training over ``k_samples`` sub-epochs (:193-232), over one
    of two data paths, chosen by the iterators (duck-typed on
    ``epoch_entity_indices``, as in the JAX package): the host iterator,
    whose producer thread builds numpy batches that the loop uploads to
    ``device`` (a threaded prefetch generator, :114-141), or the device
    pool (``data.device_pool``), whose sub-epoch is one call of its epoch
    runner: batches gathered on the card, no producer thread;
  * per-epoch embedding of <= 1000 train and valid samples, the optional
    offline CCA refit (``fit_cca``), retrieval evaluation (:234-299), whose
    ranks up to 25 come from the gallery top-k kernel on a card
    (``ops.metrics.eval_ranks``; over the device pool the whole evaluation
    is ``make_fused_eval``'s, with one download);
  * early stopping on ``map_va >= prev_map_va`` with a best-model snapshot
    and a params dump on improvement (:391-401);
  * the NaN-loss abort (:410-411);
  * refinement: on patience exhaustion reload the best weights AND the best
    optimizer state, lr *= lr_multiplier, patience = refinement_patience,
    ``refinement_steps`` times (:492-520);
  * the per-epoch results curves (:477-489).

One step is one eager PyTorch program: both encoders in train mode, the CCA
layer's whitening, the ranking loss, autograd, one ``torch.optim.Adam`` step,
then the new BN and CCA running state written into the params (in place:
the params, the optimizer and the step count of a ``TrainState`` are
updated where they are). Evaluation embeds through the folded eval model
(``TrainParams.fold``); the best snapshot and the dump are the unfolded
train params.

Data parallelism (``fit(..., mesh=...)``, a ``parallel.mesh.DataMesh``): one
process a card; every rank runs the same fit on its slice of each global
batch. The step is the global batch's on every rank (BN statistics summed
over the ranks, the CCA layer and the loss on the gathered codes, the
gradients summed: ``make_train_step``), the evaluation is replicated, and
rank 0's epoch numbers are broadcast so every rank takes the same early-stop
and refinement decisions. Only rank 0 writes files.
"""

from __future__ import annotations

import copy
import os
import pickle
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from audio_sheet_retrieval_tpu_torch.data import device_pool
from audio_sheet_retrieval_tpu_torch.data.iterators import (
    threaded_generator_from_iterator,
)
from audio_sheet_retrieval_tpu_torch.models import cca_model, lasagne_import
from audio_sheet_retrieval_tpu_torch.models.cca_model import (
    ModelParams,
    TrainParams,
)
from audio_sheet_retrieval_tpu_torch.models.configs import ModelConfig
from audio_sheet_retrieval_tpu_torch.ops import cca as cca_ops
from audio_sheet_retrieval_tpu_torch.ops import losses
from audio_sheet_retrieval_tpu_torch.ops.metrics import (
    eval_ranks,
    eval_retrieval,
    summarise_ranks,
)
from audio_sheet_retrieval_tpu_torch.parallel import sharded_pool
from audio_sheet_retrieval_tpu_torch.train import state as ts
from audio_sheet_retrieval_tpu_torch.utils import io as uio
from audio_sheet_retrieval_tpu_torch.utils.logging import BColors

col = BColors()


# --- device-side input preparation -------------------------------------------


def prepare_view1_device(x1: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[B, 1, H, W] raw-range sheet batch -> [B, 1, H', W'] normalized.

    Mirrors model.prepare (x/255 + half bilinear resize, reference
    mutopia_ccal_cont_rsz.py:170-190). A bilinear resize to exactly half
    size without antialiasing samples midway between pixel pairs, so it is a
    2x2 mean (the JAX package's ``jax.image.resize``) for even H and W.
    """
    x = x1.to(torch.float32) * (1.0 / 255.0)
    if cfg.sheet_downscale == 1:
        return x
    if cfg.sheet_downscale != 2:
        raise NotImplementedError(
            f"sheet_downscale={cfg.sheet_downscale}: only 1 and 2 exist")
    if x.shape[-2] % 2 or x.shape[-1] % 2:
        raise ValueError(f"half resize needs even H, W; got {tuple(x.shape)}")
    return F.avg_pool2d(x, 2)


def prepare_view2_device(x2: torch.Tensor) -> torch.Tensor:
    """[B, 1, bins, frames] spectrogram batch, fed as it is (the
    log-filterbank output is not normalized, like the reference)."""
    return x2.to(torch.float32)


# --- steps --------------------------------------------------------------------


def train_loss(params: TrainParams, x1: torch.Tensor, x2: torch.Tensor,
               cfg: ModelConfig, mesh=None):
    """The training objective of one raw batch -> (loss, new running
    state, corr): the contrastive cosine loss weighted 1 - weight_tno,
    minus mean(corr) * weight_tno (the CCALayer corr loss, lasagne
    cca.py:163), plus the L2 / L1 penalties over the trainable set. The
    loss is differentiable in ``params``' parameters; ``params`` is not
    changed.

    With a ``parallel.mesh.DataMesh``, ``x1`` / ``x2`` are this rank's
    slice and the loss is the global batch's, the same on every rank; the
    gradient of this rank's backward is its share, and the shares sum to
    the global gradient (``DataMesh.all_reduce_grads``). The penalties
    depend on the parameters alone, so only rank 0's backward carries
    their gradient."""
    lv1, lv2, new_state, corr = cca_model.forward_train(
        params, prepare_view1_device(x1, cfg), prepare_view2_device(x2), cfg,
        mesh)
    obj = losses.contrastive_cos_loss(lv1, lv2, weight=1.0 - cfg.weight_tno,
                                      gamma=cfg.gamma)
    obj = obj - corr.mean() * cfg.weight_tno
    trainable = list(params.parameters())
    rank0 = mesh is None or mesh.rank == 0

    def penalty(t):
        return t if rank0 else t.detach()

    if cfg.l2:
        obj = obj + penalty(cfg.l2 * ts.l2_penalty(trainable))
    if cfg.l1:
        obj = obj + penalty(cfg.l1 * ts.l1_penalty(trainable))
    return obj, new_state, corr


def make_train_step(cfg: ModelConfig, mesh=None):
    """-> ``train_step(state, x1, x2)``: loss, backward, one Adam step, the
    new BN and CCA state written back; returns ``{"loss", "corr"}`` as
    device tensors (nothing is downloaded). With a
    ``parallel.mesh.DataMesh``, ``x1`` / ``x2`` are this rank's slice of
    the global batch and the gradients are summed over the ranks before
    the step, so every rank takes the same step."""

    def train_step(state: ts.TrainState, x1, x2):
        loss, new_state, corr = train_loss(state.params, x1, x2, cfg, mesh)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            mesh.all_reduce_grads(state.params.parameters())
        state.optimizer.step()
        state.params.write_state(new_state)
        state.step += 1
        return {"loss": loss.detach(), "corr": corr.detach()}

    return train_step


def make_eval_fns(cfg: ModelConfig, mesh=None):
    """-> (embed_pair, valid_loss, init_cca_step). The first two take the
    folded eval ``ModelParams`` (``TrainParams.fold()``). With a
    ``parallel.mesh.DataMesh``, ``valid_loss`` and ``init_cca_step`` take
    this rank's slice of a global batch (``embed_pair`` is per sample)."""

    def embed_pair(params: ModelParams, x1, x2):
        lv1 = cca_model.embed_view1(params, prepare_view1_device(x1, cfg),
                                    cfg)
        lv2 = cca_model.embed_view2(params, prepare_view2_device(x2), cfg)
        return lv1, lv2

    @torch.no_grad()
    def valid_loss(params: ModelParams, x1, x2):
        """-> (loss, lv1, lv2) of the batch; with a mesh, of the global
        batch, gathered from this rank's slice."""
        lv1, lv2 = embed_pair(params, x1, x2)
        if mesh is not None:
            lv1, lv2 = mesh.gather(lv1), mesh.gather(lv2)
        return losses.contrastive_cos_loss(
            lv1, lv2, weight=1.0 - cfg.weight_tno, gamma=cfg.gamma), lv1, lv2

    @torch.no_grad()
    def init_cca_step(state: ts.TrainState, x1, x2):
        """CCA (and BN) running-stat burn-in without gradient updates
        (pretrain, reference train_dcca_pool.py:170-182)."""
        _, _, new_state, _ = cca_model.forward_train(
            state.params, prepare_view1_device(x1, cfg),
            prepare_view2_device(x2), cfg, mesh)
        state.params.write_state(new_state)
        return state

    return embed_pair, valid_loss, init_cca_step


def make_fused_eval(cfg: ModelConfig):
    """-> ``fused_eval(lv1_tr, lv2_tr, lv1_va, lv2_va)`` -> the
    ``eval_retrieval`` tuples of the train and the valid codes: with
    ``cfg.fit_cca``, CCA refitted on the train codes (``cca_fit``, svd) and
    both splits projected, on the codes' device; each split ranked through
    the gallery top-k kernel on a card (``ops.metrics.eval_ranks``); one
    download for both. The JAX package's counterpart (its :146-168) ranks
    by a full argsort inside one program."""

    def fused_eval(lv1_tr, lv2_tr, lv1_va, lv2_va):
        if cfg.fit_cca:
            res = cca_ops.cca_fit(lv1_tr, lv2_tr, method="svd")
            lv1_tr, lv1_va = (cca_ops.cca_transform_v1(res, v)
                              for v in (lv1_tr, lv1_va))
            lv2_tr, lv2_va = (cca_ops.cca_transform_v2(res, v)
                              for v in (lv2_tr, lv2_va))
        splits = [eval_ranks(a, b, device=None)
                  for a, b in ((lv1_tr, lv2_tr), (lv1_va, lv2_va))]
        host = torch.cat([torch.cat([r.double(), d.double()[None]])
                          for r, d in splits]).cpu().numpy()
        n = lv1_tr.shape[0]
        return (summarise_ranks(host[:n], host[n]),
                summarise_ranks(host[n + 1:-1], host[-1]))

    return fused_eval


# --- kill-and-resume snapshot -------------------------------------------------
#
# fit(resume_file=...) writes the whole fit state atomically at every epoch
# end: params and optimizer state, the best snapshot, the early-stop and
# refinement bookkeeping, the curves, and the data order: each pool's rng
# state AND its shuffled order (a host pool's ``train_entities``, which
# ``reset_batch_generator`` permutes in place; a device pool's ``_order``
# and the state of its device generator), each iterator's
# ``epoch_counter``. A killed run resumed from it continues epoch for epoch
# as the uninterrupted run would.

FIT_STATE_VERSION = 1


def _to_numpy(obj):
    """Tensors of a nest of dicts / lists / tuples -> numpy arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _from_numpy(obj):
    """The inverse of ``_to_numpy`` (tensors on the CPU)."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy())
    if isinstance(obj, dict):
        return {k: _from_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_numpy(v) for v in obj)
    return obj


def _atomic_pickle(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        pickle.dump(obj, fp, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)  # a kill mid-write never corrupts the snapshot


def _data_state(obj) -> dict:
    """The data order of a pool or an iterator: numpy Generator state, the
    shuffled entity order, a device pool's generator state, the sub-epoch
    counter."""
    d = {}
    if obj is None:
        return d
    rng = getattr(obj, "rng", None)
    if isinstance(rng, np.random.Generator):
        d["rng"] = rng.bit_generator.state
    entities = getattr(obj, "train_entities", None)
    if entities is not None:
        d["train_entities"] = np.array(entities)
    order = getattr(obj, "_order", None)
    if order is not None:
        d["order"] = np.array(order)
    generator = getattr(obj, "generator", None)
    if isinstance(generator, torch.Generator):
        d["generator"] = generator.get_state().numpy().copy()
    if hasattr(obj, "epoch_counter"):
        d["epoch_counter"] = int(obj.epoch_counter)
    return d


def _restore_data_state(obj, d: Optional[dict]) -> None:
    if obj is None or not d:
        return
    if "rng" in d:
        obj.rng.bit_generator.state = d["rng"]
    if "train_entities" in d:
        obj.train_entities = np.array(d["train_entities"])
    if "order" in d:
        obj._order = np.array(d["order"])
    if "generator" in d:
        obj.generator.set_state(torch.from_numpy(d["generator"].copy()))
    if "epoch_counter" in d:
        obj.epoch_counter = int(d["epoch_counter"])


def _clone_params(params: TrainParams) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.state_dict().items()}


# --- fit ----------------------------------------------------------------------


def fit(
    params: TrainParams,
    data: Dict,
    cfg: ModelConfig,
    train_batch_iter,
    valid_batch_iter,
    *,
    device,
    out_path: str,
    dump_file: Optional[str] = None,
    log_file: Optional[str] = None,
    num_epochs: Optional[int] = None,
    exp_name: str = "ff",
    verbose: bool = True,
    on_epoch: Optional[Callable[[dict], None]] = None,
    update_learning_rate: Optional[Callable[[float, int], float]] = None,
    resume_file: Optional[str] = None,
    mesh=None,
):
    """Train with early stopping and refinement restarts on ``device`` (a
    copy of ``params`` is trained; the caller's module is not changed) ->
    (best ``TrainParams``, best validation MRR).

    ``data`` holds the pools (``data["train"]``, ``data["valid"]``): host
    pools with ``data.iterators.MultiviewPoolIteratorUnsupervised``, or
    device pools (``data.device_pool.DevicePool`` on ``device``) with
    ``data.device_pool.DeviceBatchIterator``, both of one kind.
    ``on_epoch`` gets the JAX package's per-epoch record (number,
    train_loss, valid_loss, map_tr, map_va, med_rank_va), the data path
    (``data``: "device pool" or "host iterator") and the epoch's timing:
    ``n_batches``, ``updates_per_s``, ``loop_seconds`` (the step loop, to a
    synchronise), ``wait_seconds`` (of it, waiting on the host iterator; 0
    over the device pool) and ``eval_seconds``. With ``resume_file`` set,
    the whole fit state is written there at every epoch end, and an
    existing file resumes the run where it stopped.

    With ``mesh`` (a ``parallel.mesh.DataMesh`` on ``device``), training
    is data-parallel over its ranks (JAX ``train/engine.py:255-456``): the
    params are broadcast from rank 0; the train pool is a
    ``DevicePool(mesh=mesh)`` (replicated, each rank assembling its slice
    of every batch) or a ``parallel.sharded_pool.ShardedDevicePool`` with
    its ``ShardedBatchIterator``, or host pools (each rank builds the
    global batch and uploads its slice); the valid pool is a device pool
    on the mesh or on none. The evaluation runs on every rank (the train
    codes of a sharded pool gathered first); rank 0's epoch numbers are
    broadcast, so every rank takes the same decisions; only rank 0 writes
    the dump, the curves and the snapshot, and every rank resumes from
    the same snapshot.
    """
    device = torch.device(device)
    if mesh is not None and mesh.device != device:
        raise ValueError(f"fit on {device} with a mesh on {mesh.device}")
    is_writer = mesh is None or mesh.rank == 0
    if is_writer:
        os.makedirs(out_path, exist_ok=True)
    if log_file is None:
        log_file = os.path.join(out_path, "results.pkl")
    num_epochs = num_epochs or cfg.max_epochs

    cca_model.check_numerics(cfg)
    device_data = hasattr(train_batch_iter, "epoch_entity_indices")
    if hasattr(valid_batch_iter, "epoch_entity_indices") != device_data:
        raise ValueError("the train and the valid data must both be device "
                         "pools or both host pools")
    data_path = "device pool" if device_data else "host iterator"
    sharded = isinstance(data["train"], sharded_pool.ShardedDevicePool)
    if device_data and getattr(data["train"], "mesh", None) is not mesh:
        raise ValueError("the train pool must be built on fit's mesh")
    state = ts.init_train_state(copy.deepcopy(params).to(device), cfg)
    if mesh is not None:
        mesh.broadcast_(state.params.state_dict().values())
    train_step = make_train_step(cfg, mesh)
    embed_pair, valid_loss_fn, init_cca_step = make_eval_fns(cfg, mesh)

    def put(x):
        """A host batch on the device (with a mesh, this rank's slice)."""
        if mesh is not None:
            x = mesh.shard(x)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def say(msg, color=None):
        if verbose:
            print(col.print_colored(msg, color) if color else msg)

    say("Running Test Case: " + exp_name, BColors.UNDERLINE)
    say("Training data: " + (
        "device pool, batches assembled on %s" % data["train"].device
        if device_data else
        "host iterator, batches built in a producer thread"))

    snap = None
    do_resume = resume_file is not None and os.path.exists(resume_file)
    if mesh is not None:
        # one decision for all ranks, rank 0's: a rank that decided alone
        # could skip the pretrain the others run and wait in a collective
        do_resume = bool(mesh.broadcast_values([do_resume])[0])
    if do_resume:
        with open(resume_file, "rb") as fp:
            snap = pickle.load(fp)
        if snap.get("fit_state_version") != FIT_STATE_VERSION:
            raise ValueError(
                f"{resume_file} has fit-state version "
                f"{snap.get('fit_state_version')}, expected "
                f"{FIT_STATE_VERSION}")
        say(f"Resuming full fit state from {resume_file} "
            f"(after epoch {snap['epoch_idx']})", BColors.WARNING)

    # CCA burn-in epochs (pretrain, reference :170-182); already done in
    # the interrupted run when resuming
    for _ in range(0 if snap is not None else cfg.pretrain_epochs):
        if device_data:     # batches already on the card: no thread
            for x1, x2 in train_batch_iter(data["train"]):
                init_cca_step(state, x1, x2)
        else:
            for x1, x2 in threaded_generator_from_iterator(
                    train_batch_iter(data["train"])):
                init_cca_step(state, put(x1), put(x2))

    patience = cfg.patience
    refinement_steps = cfg.refinement_steps
    learn_rate = cfg.ini_learning_rate
    last_improvement = 0
    best_model = _clone_params(state.params)
    best_opt_state = copy.deepcopy(state.optimizer.state_dict())
    best_epoch = 0
    prev_map_va = 0.0
    curves: Dict[str, list] = {k: [] for k in (
        "pred_tr_err", "pred_val_err", "dist_tr", "dist_val", "rank_tr",
        "rank_val", "map_tr", "map_val", "evals_tr", "lr")}
    n_valid_cca = int(min(1000, data["valid"].shape[0]))
    epoch_idx = 0
    if device_data:
        epoch_runner = device_pool.make_epoch_runner(cfg, data["train"])
        embed_tr = device_pool.make_embed_runner(cfg, data["train"])
        embed_va = device_pool.make_embed_runner(cfg, data["valid"])
        fused_eval = make_fused_eval(cfg)
    data_objs = (("train_pool", data.get("train")),
                 ("valid_pool", data.get("valid")),
                 ("train_iter", train_batch_iter),
                 ("valid_iter", valid_batch_iter))

    if snap is not None:
        epoch_idx = int(snap["epoch_idx"])
        patience = int(snap["patience"])
        refinement_steps = int(snap["refinement_steps"])
        learn_rate = float(snap["learn_rate"])
        last_improvement = int(snap["last_improvement"])
        prev_map_va = float(snap["prev_map_va"])
        best_epoch = int(snap["best_epoch"])
        curves = snap["curves"]
        state.params.load_state_dict(_from_numpy(snap["params"]))
        state.optimizer.load_state_dict(_from_numpy(snap["optimizer"]))
        state.step = int(snap["step"])
        best_model = {k: v.to(device) for k, v in
                      _from_numpy(snap["best_model"]).items()}
        best_opt_state = _from_numpy(snap["best_opt_state"])
        for name, obj in data_objs:
            _restore_data_state(obj, snap["data_state"].get(name))

    def write_snapshot():
        _atomic_pickle(resume_file, {
            "fit_state_version": FIT_STATE_VERSION,
            "epoch_idx": epoch_idx, "patience": patience,
            "refinement_steps": refinement_steps, "learn_rate": learn_rate,
            "last_improvement": last_improvement,
            "prev_map_va": prev_map_va, "best_epoch": best_epoch,
            "curves": curves, "step": state.step,
            "params": _to_numpy(state.params.state_dict()),
            "optimizer": _to_numpy(state.optimizer.state_dict()),
            "best_model": _to_numpy(best_model),
            "best_opt_state": _to_numpy(best_opt_state),
            "data_state": {name: _data_state(obj)
                           for name, obj in data_objs},
        })

    def evaluate_on_device(model: ModelParams):
        """The evaluation over the device pools (the JAX package's fused
        arm, its :477-506): the train subset is the first nb * bs entities
        of the pool's current order, read without an iterator, so nothing
        reshuffles (of a sharded pool: nb fresh batches of its epoch
        indices, gathered over the ranks); the valid codes are the valid
        iterator's next sub-epoch, cut to max(n_valid_cca, bs) rows."""
        bs = train_batch_iter.batch_size
        nb = int(np.ceil(n_valid_cca / bs))
        pool_tr = data["train"]
        if sharded:
            entity_idx = pool_tr.epoch_indices(nb, bs)
        else:
            idx = np.arange(nb * bs) % pool_tr.shape[0]
            entity_idx = pool_tr._order[idx.reshape(nb, bs)]
        lv1_tr, lv2_tr, _ = embed_tr(model, entity_idx)
        va_it = valid_batch_iter(data["valid"])
        lv1_va, lv2_va, va_losses = embed_va(model,
                                             va_it.epoch_entity_indices())
        n_keep = max(n_valid_cca, va_it.batch_size)
        metrics_tr, metrics_va = fused_eval(lv1_tr, lv2_tr, lv1_va[:n_keep],
                                            lv2_va[:n_keep])
        return (metrics_tr, metrics_va,
                float(va_losses.double().mean()), nb * bs)

    def evaluate_on_host(model: ModelParams):
        """The evaluation over the host pools -> (train metrics, valid
        metrics, valid loss, train codes ranked)."""
        # embed the train subset from a fresh iterator copy
        # (:234-246), drained fully as the reference does: it
        # reshuffles the shared pool at its end, and breaking out would
        # leave the producer thread blocked on its queue
        it_copy = copy.copy(train_batch_iter)
        it_copy.epoch_counter = 0
        V1_tr, V2_tr = [], []
        n_collected = 0
        for x1, x2 in threaded_generator_from_iterator(
                it_copy(data["train"])):
            if n_collected >= n_valid_cca:
                continue
            lv1, lv2 = embed_pair(model, put(x1), put(x2))
            if mesh is not None:    # this rank's slice -> the batch's codes
                lv1, lv2 = mesh.gather(lv1), mesh.gather(lv2)
            V1_tr.append(lv1)
            V2_tr.append(lv2)
            n_collected += lv1.shape[0]
        V1_tr, V2_tr = torch.cat(V1_tr), torch.cat(V2_tr)
        if cfg.fit_cca:
            res = cca_ops.cca_fit(V1_tr, V2_tr, method="svd")
            lv1_tr = cca_ops.cca_transform_v1(res, V1_tr)
            lv2_tr = cca_ops.cca_transform_v2(res, V2_tr)
        else:
            lv1_tr, lv2_tr = V1_tr, V2_tr
        metrics_tr = eval_retrieval(lv1_tr, lv2_tr, device=device)

        # ---- validation (:272-299) --------------------------------
        V1_va, V2_va, va_losses = [], [], []
        n_collected = 0
        for x1, x2 in threaded_generator_from_iterator(
                valid_batch_iter(data["valid"])):
            vloss, lv1, lv2 = valid_loss_fn(model, put(x1), put(x2))
            va_losses.append(vloss)
            if n_collected < n_valid_cca:
                V1_va.append(lv1)
                V2_va.append(lv2)
                n_collected += lv1.shape[0]
        va_loss = float(np.mean([float(v) for v in
                                 torch.stack(va_losses).cpu()]))
        V1_va, V2_va = torch.cat(V1_va), torch.cat(V2_va)
        if cfg.fit_cca:
            lv1_va = cca_ops.cca_transform_v1(res, V1_va)
            lv2_va = cca_ops.cca_transform_v2(res, V2_va)
        else:
            lv1_va, lv2_va = V1_va, V2_va
        return (metrics_tr, eval_retrieval(lv1_va, lv2_va, device=device),
                va_loss, len(lv1_tr))

    now = time.time()
    try:
        while epoch_idx < num_epochs:
            epoch_idx += 1

            # ---- train one epoch ---------------------------------------
            t0 = time.perf_counter()
            wait = 0.0
            if device_data:
                # the sub-epoch in one call, on the card (no producer)
                losses_d, corrs_d = epoch_runner(
                    state,
                    train_batch_iter(data["train"]).epoch_entity_indices())
                batch_losses, batch_corrs = list(losses_d), list(corrs_d)
            else:
                batch_losses, batch_corrs = [], []
                batches = threaded_generator_from_iterator(
                    train_batch_iter(data["train"]))
                while True:
                    tw = time.perf_counter()
                    batch = next(batches, None)
                    wait += time.perf_counter() - tw
                    if batch is None:
                        break
                    m = train_step(state, put(batch[0]), put(batch[1]))
                    batch_losses.append(m["loss"])
                    batch_corrs.append(m["corr"])
            n_batches = len(batch_losses)
            # one synchronising download at epoch end, not per batch
            batch_losses = ([float(v) for v in torch.stack(batch_losses)
                             .cpu()] if batch_losses else [])
            loop_s = time.perf_counter() - t0
            tr_loss = float(np.mean(batch_losses))
            ups = n_batches / max(loop_s, 1e-9)

            # ---- evaluation through the folded model ------------------
            t_eval = time.perf_counter()
            model = state.params.fold()
            (_, med_rank_tr, dist_tr, hit_tr, map_tr), \
                (_, med_rank_va, dist_va, hit_va, map_va), va_loss, n_tr = \
                (evaluate_on_device if device_data
                 else evaluate_on_host)(model)
            mean_rank_tr = 1.0 - float(hit_tr[10]) / n_tr
            mean_rank_va = 1.0 - float(hit_va[10]) / 1000.0
            if mesh is not None:
                # every rank computed these; rank 0's decide for all
                (tr_loss, va_loss, map_tr, map_va, med_rank_tr, med_rank_va,
                 dist_tr, dist_va, mean_rank_tr, mean_rank_va) = \
                    mesh.broadcast_values([
                        tr_loss, va_loss, map_tr, map_va, med_rank_tr,
                        med_rank_va, dist_tr, dist_va, mean_rank_tr,
                        mean_rank_va])
            eval_s = time.perf_counter() - t_eval

            # ---- improvement / snapshot (:387-401) --------------------
            improvement = map_va >= prev_map_va
            if improvement:
                last_improvement = 0
                best_epoch = epoch_idx
                best_model = _clone_params(state.params)
                best_opt_state = copy.deepcopy(state.optimizer.state_dict())
                if dump_file is not None and is_writer:
                    uio.save_pytree(
                        dump_file,
                        lasagne_import.train_params_to_numpy(state.params),
                        meta={"model": cfg.name, "epoch": epoch_idx})
            last_improvement += 1

            if np.isnan(tr_loss):
                last_improvement = patience + 1

            say("Epoch %d of %d took %.3fs (patience: %d, %.2f ups)" % (
                epoch_idx, num_epochs, time.time() - now,
                patience - last_improvement + 1, ups))
            now = time.time()
            txt = "  costs_tr %.5f costs_va %.5f " % (tr_loss, va_loss)
            txt += "| map_tr %.2f map_va %.2f " % (100 * map_tr, 100 * map_va)
            txt += "| medr_tr %.2f medr_va %.2f lr %.6g" % (
                med_rank_tr, med_rank_va, learn_rate)
            say(txt, BColors.OKGREEN if map_va > prev_map_va else None)
            if map_va > prev_map_va:
                prev_map_va = map_va

            # ---- curves (:465-489) ------------------------------------
            corr_mean = (torch.stack(batch_corrs).cpu().numpy().mean(axis=0)
                         if batch_corrs else None)
            for k, v in (("pred_tr_err", tr_loss), ("pred_val_err", va_loss),
                         ("dist_tr", dist_tr), ("dist_val", dist_va),
                         ("rank_tr", mean_rank_tr),
                         ("rank_val", mean_rank_va), ("map_tr", map_tr),
                         ("map_val", map_va), ("evals_tr", corr_mean),
                         ("lr", learn_rate)):
                curves[k].append(v)
            if is_writer:
                uio.save_results(log_file, curves)

            if on_epoch is not None:
                on_epoch(dict(number=epoch_idx, train_loss=tr_loss,
                              valid_loss=va_loss, map_tr=map_tr,
                              map_va=map_va, med_rank_va=med_rank_va,
                              data=data_path, n_batches=n_batches, updates_per_s=ups,
                              loop_seconds=loop_s, wait_seconds=wait,
                              eval_seconds=eval_s))

            # ---- early stopping / refinement (:491-520) ---------------
            if last_improvement > patience:
                say("Early Stopping!", BColors.WARNING)
                say("Best Epoch: %d, Map: %.2f" % (best_epoch,
                                                   100 * prev_map_va),
                    BColors.WARNING)
                if refinement_steps <= 0:
                    break
                say("Loading best parameters so far and refining (%d) "
                    "with decreased learn rate ..." % refinement_steps,
                    BColors.WARNING)
                last_improvement = 0
                patience = cfg.refinement_patience
                refinement_steps -= 1
                learn_rate = learn_rate * cfg.lr_multiplier
                state.params.load_state_dict(best_model)
                state.optimizer.load_state_dict(copy.deepcopy(best_opt_state))
            elif update_learning_rate is not None:
                # per-epoch lr hook (model.update_learning_rate, reference
                # run_train.py:113/:522-525)
                new_lr = update_learning_rate(learn_rate, epoch_idx)
                if new_lr is not None:
                    learn_rate = float(new_lr)
            ts.set_lr(state.optimizer, learn_rate)

            # written AFTER the early-stop / refinement branch: the file
            # holds exactly the state the next epoch starts from
            if resume_file is not None and is_writer:
                write_snapshot()

    except KeyboardInterrupt:
        say("\ntraining interrupted", BColors.WARNING)

    best = copy.deepcopy(state.params)
    best.load_state_dict(best_model)
    return best, prev_map_va
