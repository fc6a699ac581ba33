"""Multi-rank dry run of the port: every collective pattern of
``parallel/`` once, at narrow widths (the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -m audio_sheet_retrieval_tpu_torch.parallel.dryrun --ranks N \\
        [--data D --db M] [--device cpu]
    torchrun --standalone --nproc_per_node=N \\
        -m audio_sheet_retrieval_tpu_torch.parallel.dryrun [--data D --db M]

Started by hand, it starts ``N`` gloo ranks of itself (a rendezvous file
in a directory of its own, each rank's output in a file of its own, one
deadline for all) and prints
rank 0's output; on the card every rank uses ``cuda:<rank % cards>``, so on
one card the ranks share ``cuda:0`` (NCCL cannot place two ranks on one
card). Under ``torchrun`` each process joins its group with NCCL on
``cuda:<LOCAL_RANK>`` (gloo with ``--device cpu``). The ranks run on the
card unless ``--device cpu`` is given, and a missing card fails the run.

The mesh is ``data x db`` (``parallel.mesh.make_hybrid_mesh``): by default
``N/2 x 2`` for an even ``N >= 4``, else ``N x 1``. Training is
data-parallel over every rank (``parallel.mesh.DataMesh``). The sections,
each printed as ``[dryrun +<seconds>s] <section> done``: a train step; a
gallery search sharded over ``db``; a CCA refit over ``data``; an epoch
over a replicated device pool; an epoch over a piece-sharded pool; the
serving matrix (the sharded sheet and audio builds over the rANS wires,
and both fused queries, the sheet query over the rle2 wire), as the JAX
package's dry run has it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SECTIONS = 6


def layout(n: int, data: Optional[int] = None,
           db: Optional[int] = None):
    """-> (data, db) for ``n`` ranks: as given, else ``n/2 x 2`` for an
    even ``n >= 4`` (the JAX dry run's mesh), else ``n x 1``."""
    if data is None and db is None:
        return (n // 2, 2) if n % 2 == 0 and n >= 4 else (n, 1)
    if data is None:
        data = n // db
    if db is None:
        db = n // data
    if data * db != n:
        raise ValueError(f"mesh {data} x {db} does not hold {n} ranks")
    return data, db


def spawn_ranks(argv_of_rank, world: int, logdir: str, name: str,
                timeout: float) -> List[str]:
    """Start ``world`` processes (``argv_of_rank(rank)``) and wait for
    them under one deadline -> each one's output. Each writes into a file
    of its own under ``logdir``: a pipe that no one reads while the caller
    waits on another rank could block a rank's write, and with it a
    collective. A process left at the deadline is killed; a process that
    fails raises ``RuntimeError`` with its output's tail."""
    logs = [os.path.join(logdir, f"{name}_rank{r}.log")
            for r in range(world)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as fp:
                procs.append(subprocess.Popen(
                    argv_of_rank(r), stdout=fp, stderr=subprocess.STDOUT,
                    cwd=REPO))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        with open(log) as fp:
            outs.append(fp.read())
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{name} rank {r} exited {p.returncode}:\n"
                               f"{out[-6000:]}")
    return outs


def rendezvous(directory: str) -> str:
    """A ``file://`` init method for ``init_process_group`` in
    ``directory`` (a fresh file the spawned ranks share). Unlike a free
    TCP port picked ahead of the ranks, which another process may bind
    between the pick and rank 0's listen, a file of the spawn's own
    directory cannot collide with any other group."""
    path = os.path.join(os.path.abspath(directory), "rendezvous")
    if os.path.exists(path):
        raise ValueError(f"{path} exists: one rendezvous a directory")
    return "file://" + path


def rank_device(device: str, rank: int) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA card (pass --device cpu to run "
                         "on the CPU)")
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")


FULL = dict(system_translation=5, sheet_scaling=[0.95, 1.05],
            onset_translation=1, spec_padding=3)


def dryrun(dmesh, hmesh, n: int) -> str:
    """The six sections on this rank -> its summary line."""
    from audio_sheet_retrieval_tpu_torch.data import device_pool as dpool
    from audio_sheet_retrieval_tpu_torch.data import synthetic
    from audio_sheet_retrieval_tpu_torch.data.pools import NO_AUGMENT
    from audio_sheet_retrieval_tpu_torch.models import cca_model
    from audio_sheet_retrieval_tpu_torch.models.configs import (
        get_model_config,
    )
    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.parallel import gallery as pg
    from audio_sheet_retrieval_tpu_torch.parallel import sharded_pool as sp
    from audio_sheet_retrieval_tpu_torch.train import engine
    from audio_sheet_retrieval_tpu_torch.train import state as ts

    t0 = time.time()

    def mark(section: str) -> None:
        print(f"[dryrun +{time.time() - t0:6.1f}s] {section} done",
              flush=True)

    dev = dmesh.device
    augment = dict(NO_AUGMENT, **FULL)
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=8,
                           dim_latent=16, batch_size=2 * n)
    b = cfg.batch_size

    def init(seed):
        return cca_model.init_model(torch.Generator().manual_seed(seed), cfg,
                                    device=dev)

    # a step with the batch sharded over every rank
    rng = np.random.default_rng(0)
    x1 = (rng.random((b, 1, 160, 200)) * 255).astype(np.float32)
    x2 = rng.random((b, 1, 92, 42)).astype(np.float32)
    metrics = engine.make_train_step(cfg, dmesh)(
        ts.init_train_state(init(0), cfg),
        torch.from_numpy(dmesh.shard(x1)).to(dev),
        torch.from_numpy(dmesh.shard(x2)).to(dev))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite training loss: {loss}"
    mark("train step (batch over every rank: BN, CCA and gradient sums)")

    gallery = rng.standard_normal((64 * n, cfg.dim_latent)).astype(
        np.float32)
    queries = rng.standard_normal((4, cfg.dim_latent)).astype(np.float32)
    s, i = pg.sharded_gallery_search(hmesh, gallery, queries, k=5)
    assert np.isfinite(s).all() and i.shape == (4, 5), (s, i)
    mark("gallery search over db (kernel 1 a block, all_gather, re-rank)")

    h1 = rng.standard_normal((16 * n, cfg.dim_latent)).astype(np.float32)
    h2 = rng.standard_normal((16 * n, cfg.dim_latent)).astype(np.float32)
    res = pg.sharded_cca_fit(hmesh, h1, h2, axis="data")
    assert torch.isfinite(res.coeffs).all(), res.coeffs
    mark("CCA refit over data (moments all_reduce)")

    pool = dpool.DevicePool(*synthetic.make_piece_list(3, 2, n_onsets=40),
                            data_augmentation=augment,
                            rng=np.random.default_rng(0), mesh=dmesh)
    ent = (np.arange(2 * b) % pool.shape[0]).reshape(2, b)
    losses2, _ = dpool.make_epoch_runner(cfg, pool)(
        ts.init_train_state(init(1), cfg), ent)
    assert torch.isfinite(losses2).all(), losses2
    mark("device-pool epoch (replicated pool, batch slices)")

    spool = sp.ShardedDevicePool(
        *synthetic.make_piece_list(5, n, n_onsets=30), mesh=dmesh,
        data_augmentation=augment, rng=np.random.default_rng(1))
    losses3, _ = dpool.make_epoch_runner(cfg, spool)(
        ts.init_train_state(init(2), cfg), spool.epoch_indices(2, b))
    assert torch.isfinite(losses3).all(), losses3
    mark("sharded-pool epoch (pieces partitioned over the ranks)")

    # the serving matrix on the init's encoders, identity projections
    params = init(0).fold()
    eye = torch.eye(cfg.dim_latent, device=dev)
    params = params._replace(cca=params.cca._replace(U=eye, V=eye))
    rng2 = np.random.default_rng(7)
    strips = []
    for _ in range(3):
        strip = np.full((170, 600), 255, np.uint8)
        for x in rng2.integers(0, 580, 25):
            strip[rng2.integers(10, 140):, x:x + 4][:10] = 0
        strips.append(strip)
    sheet = pg.build_sharded_sheet_gallery_coded(hmesh, params, cfg, strips)
    payload, scale = win.spec_quantize(
        (rng2.random((92, 100)) * 4).astype(np.float32), bits=16)
    counts = pg.make_sharded_piece_query(
        hmesh, params, cfg, sheet, sheet.ids, 3, n_candidates=5)(
            payload, scale, win.linspace_starts(100, 42, 6)).cpu().numpy()
    assert counts.shape == (3,) and counts.sum() == 6 * 5, counts
    specs = [(rng2.random((92, t)) * 4).astype(np.float32)
             for t in (100, 80, 120)]
    audio = pg.build_sharded_audio_gallery(hmesh, params, cfg, specs,
                                           quantize=8, coded=True)
    counts2 = pg.make_sharded_sheet_query(
        hmesh, params, cfg, audio, audio.ids, 3, n_candidates=5,
        strip_shape=strips[0].shape)(
            *win.rle_bitmap2_encode_strip(strips[0]),
            win.linspace_starts(600, 200, 5)).cpu().numpy()
    assert counts2.shape == (3,) and counts2.sum() == 5 * 5, counts2
    mark("serving matrix (coded sharded builds, both fused queries)")
    return (f"dryrun({n}) OK: loss={loss:.4f}, "
            f"device-pool loss={float(losses2[-1]):.4f}, "
            f"sharded-pool loss={float(losses3[-1]):.4f}, "
            f"mesh={hmesh.shape}, device={dev}")


def run_rank(backend: str, device: torch.device, data: int, db: int,
             init_method: str = "env://", rank: Optional[int] = None,
             world: Optional[int] = None) -> None:
    import torch.distributed as dist

    from audio_sheet_retrieval_tpu_torch.models import encoder
    from audio_sheet_retrieval_tpu_torch.parallel import mesh as pm

    encoder.pin_full_f32()
    dmesh = pm.make_mesh(backend, device=device, init_method=init_method,
                         rank=rank, world_size=world)
    if device.type == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // dmesh.world_size))
    try:
        hmesh = pm.make_hybrid_mesh((1, db), (data, 1), device=device)
        line = dryrun(dmesh, hmesh, dmesh.world_size)
    finally:
        dist.destroy_process_group()
    print(line, flush=True)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Multi-rank dry run of the port's parallel paths")
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks to start (gloo); under torchrun, its group")
    p.add_argument("--data", type=int, default=None, help="data axis size")
    p.add_argument("--db", type=int, default=None, help="db axis size")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds the ranks may take together")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        world = int(os.environ["WORLD_SIZE"])
        data, db = layout(world, args.data, args.db)
        rank = int(os.environ["RANK"])
        device = (torch.device("cpu") if args.device == "cpu" else
                  torch.device(f"cuda:{os.environ.get('LOCAL_RANK', rank)}"))
        run_rank("gloo" if args.device == "cpu" else "nccl", device, data,
                 db)
        return 0
    if args.ranks is None:
        raise SystemExit("dryrun: give --ranks N (or start it by torchrun)")
    data, db = layout(args.ranks, args.data, args.db)
    if args.rank is not None:                                # a rank
        run_rank("gloo", rank_device(args.device, args.rank), data, db,
                 args.init, args.rank, args.ranks)
        return 0
    rank_device(args.device, 0)      # no card: fail here, not in N ranks
    with tempfile.TemporaryDirectory() as logdir:
        init = rendezvous(logdir)
        outs = spawn_ranks(
            lambda r: [sys.executable, "-m", __spec__.name, "--ranks",
                       str(args.ranks), "--data", str(data), "--db",
                       str(db), "--device", args.device, "--rank", str(r),
                       "--init", init],
            args.ranks, logdir, "dryrun", args.timeout)
    sys.stdout.write(outs[0])
    marks = [line for line in outs[0].splitlines()
             if line.startswith("[dryrun") and line.endswith(" done")]
    if len(marks) != SECTIONS or any(f"dryrun({args.ranks}) OK" not in out
                                     for out in outs):
        raise SystemExit(f"dryrun: {len(marks)} of {SECTIONS} sections on "
                         f"rank 0, or a rank without its OK line")
    return 0


if __name__ == "__main__":
    sys.exit(main())
