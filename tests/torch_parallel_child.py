"""Child program of tests/test_torch_parallel.py: one rank of a gloo
process group of CPU processes, driving the port's data-parallel training
(``audio_sheet_retrieval_tpu_torch.parallel``) in one scenario and writing
what the parent compares into ``outdir``:

  step      one train step on this rank's half of a global batch: loss,
            corr, the summed gradients and the state after the step
  pools     a replicated DevicePool's batch slice; a ShardedDevicePool's
            planes, epoch indices and one assembled batch; the same from
            ``from_piece_loader``, with the pieces this rank loaded
  fit_full  a 4-epoch fit over a ShardedDevicePool (train) and a
            replicated DevicePool (valid), then the same fit stopped after
            epoch 2 with a resume file ("part1"), then one epoch over host
            pools (``HOST <rank> <batches>: ...``)
  fit_part2 that fit again, resumed from part1's file
  fit_one   a one-rank group: one fit epoch with the mesh and without

    python tests/torch_parallel_child.py <rank> <world> <init_method> <scenario> <outdir>

Each epoch prints ``EPOCH <rank> <n>: <losses and MRRs as float hex>``; the
last line is ``OK <rank>``. The module's input functions (``small_cfg``,
``corpus``, ``start_params``, ``step_batch``) are imported by the parent,
so both sides build the same inputs.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from audio_sheet_retrieval_tpu_torch.data import device_pool as dpool  # noqa: E402,E501
from audio_sheet_retrieval_tpu_torch.data import synthetic  # noqa: E402
from audio_sheet_retrieval_tpu_torch.data.pools import NO_AUGMENT  # noqa: E402,E501
from audio_sheet_retrieval_tpu_torch.models import cca_model  # noqa: E402
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config  # noqa: E402,E501

FULL = dict(NO_AUGMENT, system_translation=5, sheet_scaling=[0.95, 1.05],
            onset_translation=1, spec_padding=3)
BATCH = 16


def small_cfg():
    return get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                            dim_latent=8, batch_size=BATCH, k_samples=64,
                            patience=1, refinement_steps=1)


def corpus(seed, n_pieces):
    return synthetic.make_piece_list(seed, n_pieces, n_onsets=40)


def start_params(cfg, seed):
    """He-uniform weights, BN shift 0 and scale 1, random running BN
    statistics (which the step's EMA carries), on the CPU: the start of
    ``tests/test_torch_train.py``'s step tests."""
    params = cca_model.init_model(torch.Generator().manual_seed(seed), cfg,
                                  device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for enc in (params.view1, params.view2):
            for blk in enc.blocks:
                c = blk.mean.shape[0]
                for name, values in (
                        ("mean", rng.normal(0, 0.1, c)),
                        ("inv_std", rng.uniform(0.5, 1.0, c))):
                    getattr(blk, name).copy_(torch.from_numpy(
                        values.astype(np.float32)))
    return params


def step_batch(seed=5, n=BATCH):
    rng = np.random.default_rng(seed)
    x1 = (rng.random((n, 1, 160, 200)) * 255).astype(np.float32)
    x2 = rng.random((n, 1, 92, 42)).astype(np.float32)
    return x1, x2


def run_step(cfg, params, x1, x2, mesh):
    """One train step -> {loss, corr, grads, state after}."""
    from audio_sheet_retrieval_tpu_torch.train import engine
    from audio_sheet_retrieval_tpu_torch.train import state as ts

    st = ts.init_train_state(params, cfg)
    m = engine.make_train_step(cfg, mesh)(st, torch.from_numpy(x1),
                                          torch.from_numpy(x2))
    out = {"loss": m["loss"].numpy(), "corr": m["corr"].numpy()}
    for i, p in enumerate(params.parameters()):
        out[f"grad_{i}"] = p.grad.numpy()
    for k, v in params.state_dict().items():
        out[f"state_{k}"] = v.numpy()
    return out


def scenario_step(mesh, outdir):
    cfg = small_cfg()
    x1, x2 = step_batch()
    out = run_step(cfg, start_params(cfg, 7), mesh.shard(x1), mesh.shard(x2),
                   mesh)
    np.savez(os.path.join(outdir, f"step_{mesh.rank}.npz"), **out)


def scenario_pools(mesh, outdir):
    from audio_sheet_retrieval_tpu_torch.parallel import sharded_pool as sp

    out = {}
    rep = dpool.DevicePool(*corpus(11, 3), data_augmentation=FULL,
                           rng=np.random.default_rng(0), mesh=mesh)
    x1, x2 = rep.batch(np.arange(BATCH), train=True)
    out.update(rep_x1=x1.numpy(), rep_x2=x2.numpy())

    images, specs, o2cs = corpus(5, 4)
    pool = sp.ShardedDevicePool(images, specs, o2cs, mesh=mesh,
                                data_augmentation=FULL,
                                rng=np.random.default_rng(1))
    idx = pool.epoch_indices(3, BATCH)
    seed = pool.generator.initial_seed()
    x1, x2 = pool.assemble(pool.put(idx[0, mesh.rank]), train=True)
    out.update(strip=pool.strip.numpy(), spec=pool.spec.numpy(),
               coords=pool.coords_plane.numpy(),
               onsets=pool.onsets_plane.numpy(), idx=idx,
               shape=pool.shape[0], per_shard=pool.entities_per_shard,
               seed=seed, x1=x1.numpy(), x2=x2.numpy())

    loaded = []

    def loader(i):
        loaded.append(i)
        return images[i], specs[i], o2cs[i]

    lpool = sp.ShardedDevicePool.from_piece_loader(
        loader, n_pieces=4, mesh=mesh, widths=[im.shape[1] for im in images],
        data_augmentation=FULL, rng=np.random.default_rng(2))
    out.update(l_strip=lpool.strip.numpy(), l_spec=lpool.spec.numpy(),
               l_coords=lpool.coords_plane.numpy(),
               l_onsets=lpool.onsets_plane.numpy(),
               l_idx=lpool.epoch_indices(3, BATCH), l_shape=lpool.shape[0],
               l_loaded=np.asarray(loaded), l_pieces=lpool.loaded_pieces)
    np.savez(os.path.join(outdir, f"pools_{mesh.rank}.npz"), **out)


def run_fit(mesh, out_path, max_epochs, resume_file=None, sharded=True):
    from audio_sheet_retrieval_tpu_torch.parallel import sharded_pool as sp
    from audio_sheet_retrieval_tpu_torch.train import engine

    cfg = small_cfg()
    if sharded:
        images, specs, o2cs = corpus(21, 4)
        train = sp.ShardedDevicePool(images, specs, o2cs, mesh=mesh,
                                     data_augmentation=FULL,
                                     rng=np.random.default_rng(0))
        tr_it = sp.ShardedBatchIterator(batch_size=BATCH, k_samples=64)
    else:
        train = dpool.DevicePool(*corpus(21, 4), data_augmentation=FULL,
                                 rng=np.random.default_rng(0), mesh=mesh,
                                 device="cpu")
        tr_it = dpool.DeviceBatchIterator(batch_size=BATCH, k_samples=64)
    valid = dpool.DevicePool(*corpus(22, 2), data_augmentation=NO_AUGMENT,
                             shuffle=False, rng=np.random.default_rng(1),
                             mesh=mesh, device="cpu")
    va_it = dpool.DeviceBatchIterator(batch_size=BATCH, shuffle=False,
                                      train=False)
    records = []
    best, best_map = engine.fit(
        start_params(cfg, 3), {"train": train, "valid": valid}, cfg, tr_it,
        va_it, device="cpu", out_path=out_path, verbose=False,
        on_epoch=records.append, num_epochs=max_epochs,
        resume_file=resume_file, mesh=mesh)
    rank = 0 if mesh is None else mesh.rank
    for r in records:
        print(f"EPOCH {rank} {r['number']}: " + " ".join(
            float(r[k]).hex() for k in ("train_loss", "valid_loss",
                                        "map_tr", "map_va")), flush=True)
    w = best.view1.blocks[0].w.detach().numpy()
    print(f"BEST {rank}: {float(best_map).hex()} "
          f"{float(np.abs(w).sum()).hex()}", flush=True)


def run_host_fit(mesh, out_path):
    """One epoch over host pools: every rank builds each global batch in
    its producer thread and trains on its slice."""
    from audio_sheet_retrieval_tpu_torch.data.iterators import (
        MultiviewPoolIteratorUnsupervised,
    )
    from audio_sheet_retrieval_tpu_torch.train import engine

    cfg = small_cfg()
    data = synthetic.load_synthetic_retrieval(n_train=2, n_valid=1, n_test=1,
                                              seed=3, augment=FULL,
                                              n_onsets=40)
    records = []
    engine.fit(start_params(cfg, 3), data, cfg,
               MultiviewPoolIteratorUnsupervised(batch_size=BATCH,
                                                 k_samples=64),
               MultiviewPoolIteratorUnsupervised(batch_size=BATCH,
                                                 shuffle=False),
               device="cpu", out_path=out_path, verbose=False,
               on_epoch=records.append, num_epochs=1, mesh=mesh)
    r = records[0]
    print(f"HOST {mesh.rank} {r['n_batches']}: " + " ".join(
        float(r[k]).hex() for k in ("train_loss", "valid_loss", "map_tr",
                                    "map_va")), flush=True)


def scenario_fit_full(mesh, outdir):
    run_fit(mesh, os.path.join(outdir, "full"), 4)
    run_fit(mesh, os.path.join(outdir, "part"), 2,
            os.path.join(outdir, "fit_state.pkl"))
    run_host_fit(mesh, os.path.join(outdir, "host"))


def scenario_fit_part2(mesh, outdir):
    run_fit(mesh, os.path.join(outdir, "part"), 4,
            os.path.join(outdir, "fit_state.pkl"))


def scenario_fit_one(mesh, outdir):
    run_fit(mesh, os.path.join(outdir, "mesh"), 1, sharded=False)
    run_fit(None, os.path.join(outdir, "none"), 1, sharded=False)


def main():
    rank, world, init, scenario, outdir = (int(sys.argv[1]),
                                           int(sys.argv[2]), sys.argv[3],
                                           sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    import torch.distributed as dist

    from audio_sheet_retrieval_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh("gloo", init_method=init, rank=rank,
                        world_size=world)
    try:
        globals()["scenario_" + scenario](mesh, outdir)
    finally:
        dist.destroy_process_group()
    print(f"OK {rank}", flush=True)


if __name__ == "__main__":
    main()
