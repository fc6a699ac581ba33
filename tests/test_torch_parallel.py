"""The port's data-parallel training (``parallel/``, ``fit(mesh=...)``) on
the CPU: two ranks of a gloo process group, each a subprocess running
``tests/torch_parallel_child.py``, against one process on the
concatenated batch and against the JAX package.

Every spawn has its own rendezvous file (``parallel.dryrun.rendezvous``:
a free TCP port picked ahead of the ranks can be taken by another process
before rank 0 listens on it) and its own deadline, so no test can hang the
suite or meet another's group. Sizes are small (``num_filters=4``,
``dim_latent=8``, batch 16, as the JAX package's ``tests/test_fit_mesh.py``).

Tolerances, each with its reason:
  * the two-rank step against one rank on the concatenated batch: the loss
    1e-5; every gradient element within 1e-4 of the step's largest
    gradient element; BN and CCA running state within 1e-4 of each
    tensor's largest element, and 1e-6 absolute (at BN shift 0 the CCA
    means are sums that cancel to about 1e-8). The BN and CCA sums run in
    another order (per rank, then across ranks). The last block's BN shift
    cancels in the CCA layer's centring, so its gradient is rounding noise
    and only a bound relative to the whole step's gradients means
    anything;
  * the one-rank step against JAX's: ``tests/test_torch_train.py``'s;
  * pools, planes, indices, batches: none (integer and gather arithmetic);
  * kill and resume, and a one-rank group against no group: bit for bit
    (losses and MRRs as float hex).
"""

import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from audio_sheet_retrieval_tpu.models import cca_model as jcm
from audio_sheet_retrieval_tpu.ops import cca as jcca
from audio_sheet_retrieval_tpu.parallel import sharded_pool as jsp
from audio_sheet_retrieval_tpu_torch.data import device_pool as tdp
from audio_sheet_retrieval_tpu_torch.data.pools import (
    SHEET_CONTEXT,
    SPEC_CONTEXT,
    SYSTEM_HEIGHT,
)
from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
from audio_sheet_retrieval_tpu_torch.parallel import dryrun
from audio_sheet_retrieval_tpu_torch.parallel import sharded_pool as tsp

import torch_parallel_child as child
import torch_port_helpers  # noqa: F401  (one torch thread a test process)
from test_torch_device_pool import jax_draws
from test_torch_train import configs, grad_atol, jax_grads, port_grad_pairs

CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_parallel_child.py")
TIMEOUT = 240   # seconds a spawn may take; a run takes a few


def spawn(scenario, outdir, world=2) -> list:
    """Run ``scenario`` on ``world`` ranks -> each rank's output. Each
    rank writes into a file of its own (a pipe that no one reads while
    the parent waits on another rank could block a rank's write, and with
    it a collective), and all ranks share one deadline."""
    init = dryrun.rendezvous(outdir)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    logs = [os.path.join(outdir, f"{scenario}_rank{r}.log")
            for r in range(world)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as fp:
                procs.append(subprocess.Popen(
                    [sys.executable, CHILD, str(r), str(world), init,
                     scenario, str(outdir)], stdout=fp,
                    stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + TIMEOUT
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
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
        assert p.returncode == 0, f"{scenario} rank {r}:\n{out[-4000:]}"
        assert f"OK {r}" in out, out[-2000:]
    return outs


def epoch_lines(out: str, rank: int) -> list:
    return re.findall(rf"EPOCH {rank} (\d+: .+)", out)


# --- the step -----------------------------------------------------------------


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("step")
    spawn("step", out)
    return [dict(np.load(out / f"step_{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def one_rank_step():
    cfg = child.small_cfg()
    x1, x2 = child.step_batch()
    return child.run_step(cfg, child.start_params(cfg, 7), x1, x2, None)


def test_two_rank_step_equals_one_rank_on_the_concatenated_batch(
        step_run, one_rank_step):
    one = one_rank_step
    # both ranks took the same step
    for k in step_run[0]:
        np.testing.assert_array_equal(step_run[0][k], step_run[1][k],
                                      err_msg=k)
    two = step_run[0]
    np.testing.assert_allclose(two["loss"], one["loss"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(two["corr"], one["corr"], atol=1e-5, rtol=0)
    grads = [k for k in one if k.startswith("grad_")]
    assert len(grads) == 54
    g_max = max(np.abs(one[k]).max() for k in grads)
    for k in grads:
        np.testing.assert_allclose(two[k], one[k], atol=1e-4 * g_max,
                                   rtol=0, err_msg=k)
    state = [k for k in one if k.startswith("state_")
             and (k.endswith(("mean", "inv_std")) or "_head." in k)]
    assert len(state) == 2 * 2 * 9 + 7
    for k in state:
        np.testing.assert_allclose(
            two[k], one[k], atol=max(1e-4 * np.abs(one[k]).max(), 1e-6),
            rtol=0, err_msg=k)


def test_one_rank_step_equals_jax_on_the_concatenated_batch(one_rank_step):
    """The reference the two ranks are held to, held to JAX's train step at
    ``tests/test_torch_train.py``'s tolerances."""
    jcfg, cfg = configs(batch_size=child.BATCH)
    params = child.start_params(cfg, 7)
    tree = tli.train_params_to_numpy(params)
    jparams = jax.tree.map(jnp.asarray, jcm.ModelParams(
        tree.view1, tree.view2, jcca.CCAState(*tree.cca)))
    x1, x2 = child.step_batch()
    jloss, jg = jax_grads(jcfg, jparams, x1, x2)
    np.testing.assert_allclose(one_rank_step["loss"], jloss, rtol=1e-4)
    pairs = list(port_grad_pairs(params, jg))
    assert len(pairs) == 54
    for i, (p, want) in enumerate(pairs):
        np.testing.assert_allclose(one_rank_step[f"grad_{i}"], want,
                                   atol=grad_atol(p, params), rtol=0)


# --- the pools ----------------------------------------------------------------


@pytest.fixture(scope="module")
def pools_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("pools")
    spawn("pools", out)
    return [dict(np.load(out / f"pools_{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.array(jax.devices()[:2]), ("data",))


def test_replicated_pool_batch_equals_the_unsharded_batch(pools_run):
    """JAX's test_device_pool_mesh.py:23: a DevicePool on the mesh gives
    each rank its slice of the batch the pool without a mesh gives (here
    with every augmentation on: the same draws, sliced)."""
    pool = tdp.DevicePool(*child.corpus(11, 3), data_augmentation=child.FULL,
                          rng=np.random.default_rng(0), device="cpu")
    x1, x2 = pool.batch(np.arange(child.BATCH), train=True)
    np.testing.assert_array_equal(
        np.concatenate([r["rep_x1"] for r in pools_run]), x1.numpy())
    np.testing.assert_array_equal(
        np.concatenate([r["rep_x2"] for r in pools_run]), x2.numpy())


@pytest.mark.parametrize("loader", [False, True],
                         ids=["constructor", "from_piece_loader"])
def test_sharded_pool_planes_and_indices_equal_jax(pools_run, mesh2,
                                                   loader):
    """Each rank's planes (padding and wrap-around entity fill included),
    the entity total and the epoch indices equal JAX's ShardedDevicePool
    on a two-device mesh built from the same pieces and seed."""
    images, specs, o2cs = child.corpus(5, 4)
    if loader:
        jpool = jsp.ShardedDevicePool.from_piece_loader(
            lambda i: (images[i], specs[i], o2cs[i]), n_pieces=4,
            mesh=mesh2, widths=[im.shape[1] for im in images],
            data_augmentation=child.FULL, rng=np.random.default_rng(2))
        pre = "l_"
    else:
        jpool = jsp.ShardedDevicePool(images, specs, o2cs, mesh=mesh2,
                                      data_augmentation=child.FULL,
                                      rng=np.random.default_rng(1))
        pre = ""
    jidx = jpool.epoch_indices(3, child.BATCH)
    planes = {"strip": jpool.strip, "spec": jpool.spec,
              "coords": jpool.coords_plane, "onsets": jpool.onsets_plane}
    for r, run in enumerate(pools_run):
        assert int(run[pre + "shape"]) == jpool.shape[0]
        np.testing.assert_array_equal(run[pre + "idx"], jidx)
        for name, plane in planes.items():
            want = np.asarray(plane)[r]
            got = run[pre + name]
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    if not loader:
        assert int(pools_run[0]["per_shard"]) == jpool.entities_per_shard


def test_each_rank_loads_only_its_own_pieces(pools_run):
    loaded = [sorted(r["l_loaded"].tolist()) for r in pools_run]
    assert loaded == [sorted(r["l_pieces"].tolist()) for r in pools_run]
    assert set(loaded[0]).isdisjoint(loaded[1])
    assert sorted(loaded[0] + loaded[1]) == [0, 1, 2, 3]
    images = child.corpus(5, 4)[0]
    assert loaded == [sorted(g) for g in tsp.partition_pieces(
        [im.shape[1] for im in images], 2)]


def test_partition_pieces_equals_jax():
    rng = np.random.default_rng(0)
    for n_shards in (2, 3, 4, 8):
        widths = rng.integers(100, 5000, 13).tolist()
        assert tsp.partition_pieces(widths, n_shards) == \
            jsp.partition_pieces(widths, n_shards)


def test_sharded_batch_equals_jax_per_shard_assembly(pools_run, mesh2):
    """From the same planes, indices and draws, the port's assembly of a
    shard's slice equals JAX's (its shard_map body: the key folded with
    the shard index); and each rank's own batch is its slice of the
    shared generator's global draws."""
    images, specs, o2cs = child.corpus(5, 4)
    jpool = jsp.ShardedDevicePool(images, specs, o2cs, mesh=mesh2,
                                  data_augmentation=child.FULL,
                                  rng=np.random.default_rng(1))
    key = jax.random.PRNGKey(3)
    idx = pools_run[0]["idx"][0]
    b = child.BATCH // 2
    assemble = tdp.make_assemble(child.FULL, SHEET_CONTEXT, SYSTEM_HEIGHT,
                                 SPEC_CONTEXT, jpool.strip_h, jpool.bins)
    gen = torch.Generator().manual_seed(int(pools_run[0]["seed"]))
    own = tdp.draw(gen, child.BATCH, child.FULL, True)
    for r, run in enumerate(pools_run):
        planes = [torch.from_numpy(run[k]) for k in ("strip", "spec",
                                                     "coords", "onsets")]
        local = torch.from_numpy(idx[r]).long()
        jkey = jax.random.fold_in(key, r)
        jx1, jx2 = jpool._local_assemble[True](
            jpool.strip[r], jpool.spec[r], jpool.coords_plane[r][idx[r]],
            jpool.onsets_plane[r][idx[r]], jkey)
        x1, x2 = assemble(planes[0], planes[1], planes[2][local],
                          planes[3][local],
                          jax_draws(jkey, b, child.FULL, True), True)
        np.testing.assert_array_equal(x1.numpy(), np.asarray(jx1))
        np.testing.assert_array_equal(x2.numpy(), np.asarray(jx2))
        sl = slice(r * b, (r + 1) * b)
        x1, x2 = assemble(planes[0], planes[1], planes[2][local],
                          planes[3][local],
                          tdp.Draws(*(d[sl] for d in own)), True)
        np.testing.assert_array_equal(run["x1"], x1.numpy())
        np.testing.assert_array_equal(run["x2"], x2.numpy())


def test_sharded_iterator_refuses_a_host_loop():
    it = tsp.ShardedBatchIterator(batch_size=child.BATCH)
    with pytest.raises(TypeError, match="mesh"):
        iter(it)


# --- fit ----------------------------------------------------------------------


def test_two_rank_fit_kill_and_resume_is_bit_identical(tmp_path):
    """JAX's tests/test_multiprocess.py:87, sharded: a two-rank fit over a
    ShardedDevicePool stopped after epoch 2 and resumed on both ranks from
    rank 0's snapshot continues bit for bit as the uninterrupted run; the
    ranks agree epoch for epoch (and over host pools, JAX's
    tests/test_fit_mesh.py)."""
    first = spawn("fit_full", tmp_path)
    assert os.path.exists(tmp_path / "fit_state.pkl")
    resumed = spawn("fit_part2", tmp_path)
    for r in range(2):
        lines = epoch_lines(first[r], r)
        assert len(lines) == 6, first[r][-2000:]
        full, part1 = lines[:4], lines[4:]
        assert part1 == full[:2]
        assert epoch_lines(resumed[r], r) == full[2:]
        best = re.findall(rf"BEST {r}: (.+)", first[r])
        assert re.findall(rf"BEST {r}: (.+)", resumed[r]) == best[:1]
    assert epoch_lines(first[0], 0) == epoch_lines(first[1], 1)
    # over host pools too, the ranks train and evaluate as one
    host = [re.findall(rf"HOST {r} (.+)", first[r]) for r in range(2)]
    assert host[0] == host[1] and len(host[0]) == 1
    n_batches, numbers = host[0][0].split(": ")
    assert int(n_batches) == 4
    assert all(np.isfinite(float.fromhex(v)) for v in numbers.split())
    # only rank 0 wrote the curves
    assert os.path.exists(tmp_path / "full" / "results.pkl")


def test_one_rank_group_fits_bit_identically_to_no_group(tmp_path):
    """A world-size-1 group through fit (replicated pools) is bit for bit
    the fit without a mesh: broadcasts, the gradient all-reduce and the
    decision broadcast change nothing on one rank."""
    out = spawn("fit_one", tmp_path, world=1)[0]
    lines = epoch_lines(out, 0)
    assert len(lines) == 2 and lines[0] == lines[1]
    best = re.findall(r"BEST 0: (.+)", out)
    assert len(best) == 2 and best[0] == best[1]


@pytest.mark.parametrize("given", [dict(backend="nccl"),
                                   dict(rank=1, world_size=2)],
                         ids=["backend", "rank_and_world"])
def test_make_mesh_refuses_a_group_it_does_not_match(given, tmp_path):
    """A group already running is joined only as it runs: another backend,
    rank or world size than the caller names raises."""
    import torch.distributed as dist

    from audio_sheet_retrieval_tpu_torch.parallel import mesh as pm

    m = pm.make_mesh("gloo", init_method=dryrun.rendezvous(str(tmp_path)),
                     rank=0, world_size=1)
    try:
        assert (m.rank, m.world_size, m.device) == (0, 1, torch.device("cpu"))
        args = dict(dict(backend="gloo", rank=0, world_size=1), **given)
        with pytest.raises(ValueError, match="process group"):
            pm.make_mesh(args.pop("backend"), **args)
        assert pm.make_mesh("gloo", rank=0, world_size=1) == m
    finally:
        dist.destroy_process_group()
