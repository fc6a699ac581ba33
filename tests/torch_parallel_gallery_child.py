"""Child program of tests/test_torch_parallel_gallery.py: one rank of a
gloo process group of CPU processes, laid out as a ``data x db`` mesh
(``parallel.mesh.make_hybrid_mesh``), driving the port's sharded gallery
(``audio_sheet_retrieval_tpu_torch.parallel.gallery``) over the cases the
parent wrote into ``outdir/cases.pkl`` and writing its results into
``outdir/out_<rank>.pkl``:

  mesh          this rank's axis indices, sizes and group ranks; whether
                ``make_hybrid_mesh`` refuses a ``db`` axis across nodes
                (CUDA ranks, ``LOCAL_WORLD_SIZE=2``)
  search        ``sharded_gallery_search`` -> (scores, rows)
  topk_valid    ``make_sharded_topk(..., with_valid=True)`` on this rank's
                block and its validity -> (scores, rows)
  cca           ``sharded_cca_fit`` over the case's axis
  piece_query   ``make_sharded_piece_query`` over host rows -> counts
  sheet_build   ``build_sharded_sheet_gallery`` (with ``coded``:
                ``build_sharded_sheet_gallery_coded``): this rank's block,
                its offset, the row count, ids, n_real; the piece query's
                counts over it
  audio_build   ``build_sharded_audio_gallery`` (``coded`` as given): as
                ``sheet_build``; ``make_sharded_sheet_query``'s counts over
                it, raw and over the rle2 wire

    python tests/torch_parallel_gallery_child.py <rank> <world> \\
        <init_method> <data> <db> <outdir>

The last line is ``OK <rank>``. Parameter trees arrive as plain tuples and
dicts of numpy arrays (the JAX package's tree without its classes).
"""

import os
import pickle
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli  # noqa: E402,E501
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config  # noqa: E402,E501
from audio_sheet_retrieval_tpu_torch.ops import windows as win  # noqa: E402
from audio_sheet_retrieval_tpu_torch.parallel import gallery as pg  # noqa: E402,E501
from audio_sheet_retrieval_tpu_torch.parallel import mesh as pm  # noqa: E402


def model(case):
    return (get_model_config("mutopia_ccal_cont_rsz", **case["cfg"]),
            tli.params_from_numpy(case["tree"], device="cpu"))


def gallery_out(gal: pg.ShardedGallery) -> dict:
    return dict(rows=gal.rows.numpy(), offset=gal.offset, total=gal.total,
                ids=gal.ids, n_real=gal.n_real)


def run_search(mesh, case):
    return pg.sharded_gallery_search(mesh, case["gallery"], case["queries"],
                                     case["k"])


def run_topk_valid(mesh, case):
    fn, _ = pg.make_sharded_topk(mesh, case["k"], with_valid=True)
    rows = case["gallery"].shape[0] // mesh.shape["db"]
    mine = slice(mesh.axis_index("db") * rows,
                 (mesh.axis_index("db") + 1) * rows)
    s, i = fn(torch.from_numpy(case["gallery"][mine]),
              torch.from_numpy(case["queries"]), case["valid"][mine])
    return s.numpy(), i.numpy()


def run_cca(mesh, case):
    res = pg.sharded_cca_fit(mesh, case["H1"], case["H2"], axis=case["axis"])
    return {k: v.numpy() for k, v in res._asdict().items()}


def run_piece_query(mesh, case):
    cfg, params = model(case)
    query = pg.make_sharded_piece_query(
        mesh, params, cfg, case["codes"], case["ids"], case["n_pieces"],
        n_candidates=case["n_candidates"])
    return [query(*q).numpy() for q in case["queries"]]


def run_sheet_build(mesh, case):
    cfg, params = model(case)
    build = (pg.build_sharded_sheet_gallery_coded if case.get("coded")
             else pg.build_sharded_sheet_gallery)
    gal = build(mesh, params, cfg, case["strips"])
    query = pg.make_sharded_piece_query(
        mesh, params, cfg, gal, gal.ids, len(case["strips"]),
        n_candidates=case["n_candidates"], n_real=gal.n_real)
    return dict(gallery_out(gal),
                counts=[query(*q).numpy() for q in case["queries"]])


def run_audio_build(mesh, case):
    cfg, params = model(case)
    gal = pg.build_sharded_audio_gallery(mesh, params, cfg, case["specs"],
                                         quantize=case["quantize"],
                                         coded=case.get("coded", False))
    out = gallery_out(gal)
    if case.get("strips"):
        query = pg.make_sharded_sheet_query(
            mesh, params, cfg, gal, gal.ids, len(case["specs"]),
            n_candidates=case["n_candidates"], coding="raw")
        out["counts"] = [query(s, st).numpy() for s, st in case["strips"]]
        out["counts_rle2"] = []
        for s, st in case["strips"]:
            query = pg.make_sharded_sheet_query(
                mesh, params, cfg, gal, gal.ids, len(case["specs"]),
                n_candidates=case["n_candidates"], strip_shape=s.shape,
                block_k=(32, 64))
            out["counts_rle2"].append(query(
                *win.rle_bitmap2_encode_strip(s), st).numpy())
    return out


def mesh_facts(mesh, world):
    """This rank's axes; make_hybrid_mesh's refusal of a db axis across
    two nodes of two ranks each, on CUDA ranks (raised before any group
    is created, so every rank raises alike)."""
    out = {name: dict(index=ax.index, size=ax.size, ranks=list(ax.ranks))
           for name, ax in mesh.axes.items()}
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        pm.make_hybrid_mesh((1, world), (1, 1), device="cuda")
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    return out


def main():
    rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    data, db, outdir = int(sys.argv[4]), int(sys.argv[5]), sys.argv[6]
    torch.set_num_threads(1)
    import torch.distributed as dist

    pm.make_mesh("gloo", init_method=init, rank=rank, world_size=world)
    try:
        mesh = pm.make_hybrid_mesh((1, db), (data, 1), device="cpu")
        with open(os.path.join(outdir, "cases.pkl"), "rb") as fp:
            cases = pickle.load(fp)
        out = {"mesh": mesh_facts(mesh, world)}
        for name, case in cases.items():
            out[name] = globals()["run_" + case["kind"]](mesh, case)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"out_{rank}.pkl"), "wb") as fp:
        pickle.dump(out, fp)
    print(f"OK {rank}", flush=True)


if __name__ == "__main__":
    main()
