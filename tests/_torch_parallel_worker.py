"""One rank of a CPU ``torch.distributed`` world (gloo) for the port's
multi-process tests (tests/test_torch_parallel.py, tests/test_torch_multihost.py).

Run as ``python tests/_torch_parallel_worker.py <cases.pt> <out_dir>`` with
torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``), one process per rank.  It imports torch and
mmtpu_torch only, never jax or mmtpu.  Every case of the file runs in
order on every rank; each rank writes ``<out_dir>/<case>_rank<r>.pt``
(numpy arrays; the test process compares them with mmtpu's and with the
single-process runs).
"""

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mmtpu_torch.convert import to_numpy, to_torch  # noqa: E402
from mmtpu_torch.parallel import collectives as col  # noqa: E402
from mmtpu_torch.parallel.fit import (fit_e2e_mesh, fit_latents_mesh, make_fit_mesh,  # noqa: E402
                                      place_fit_inputs)
from mmtpu_torch.parallel.mesh import build_mesh, init_world, make_mesh  # noqa: E402
from mmtpu_torch.train import e2e as te2e  # noqa: E402
from mmtpu_torch.train import latents as tl  # noqa: E402


def _hp(hp: dict) -> dict:
    return {k: (v if isinstance(v, int) else torch.tensor(v)) for k, v in hp.items()}


def run_fit(case):
    mesh = make_fit_mesh(*case["mesh"])
    args = dict(init_embed=torch.tensor(case["init"]), decoder_params=to_torch(case["dec"]),
                data=to_torch(case["data"]), vocab_emb=torch.tensor(case["vocab"]),
                hp=_hp(case["hp"]), perms=case["perms"])
    if case["op"] == "e2e":
        spec = te2e.E2EFitSpec(**case["spec"])
        embed, dec, sen, losses = fit_e2e_mesh(
            mesh, senti_params=to_torch(case["senti"]), labels=torch.tensor(case["labels"]),
            spec=spec, senti_mask=torch.tensor(case["mask"]), **args)
        return {"embed": embed, "dec": dec, "senti": sen, "losses": losses}
    embed, dec, losses = fit_latents_mesh(mesh, spec=tl.LatentFitSpec(**case["spec"]), **args)
    return {"embed": embed, "dec": dec, "losses": losses}


def run_ops(case):
    """The sharded partition and Gaussian, values and the gradients of a
    loss that adds a replicated term (the heads' stand-in) to Z."""
    lat = torch.tensor(case["lat"], requires_grad=True)
    w = torch.tensor(case["w"])
    mesh = make_fit_mesh(*case["mesh"])
    z = col.sharded_angular_partition(lat, torch.tensor(case["vocab"]), mesh, "vocab")
    (g_lat,) = torch.autograd.grad(torch.sum(z * w) + torch.sum(lat * lat), lat)
    out = {"z": z.detach(), "g_lat": g_lat}
    seq = build_mesh([mesh.ranks.size], ["seq"])
    mu = torch.tensor(case["mu"], requires_grad=True)
    sigma = torch.tensor(case["sigma"], requires_grad=True)
    lp = col.sharded_gaussian_logpdf(mu, sigma, torch.tensor(case["values"]),
                                     torch.tensor(case["mask"]), seq)
    g_mu, g_sigma = torch.autograd.grad(torch.sum(lp * torch.arange(1.0, len(lp) + 1)),
                                        [mu, sigma])
    out.update(lp=lp.detach(), g_mu=g_mu, g_sigma=g_sigma)
    return out


def run_step(case):
    """One step of the batch- and vocab-sharded joint loss: the global
    batch's latent gradient, assembled from each rank's block."""
    mesh = make_fit_mesh(*case["mesh"])
    spec = tl.LatentFitSpec(n_epochs_max=1, batch_size=case["lat"].shape[0],
                            train_decoder=True, unimodal=False, batch_shard_axis="data")
    vocab, spec = place_fit_inputs(mesh, torch.tensor(case["vocab"]), spec, "data", "vocab")
    hp = _hp(case["hp"])
    lat_all = torch.tensor(case["lat"])
    shard = tl.batch_shard(spec, mesh, hp, lat_all)
    blk = shard.block(lat_all.shape[0])
    rows = lat_all[blk].clone().requires_grad_()
    b = {k: v[blk] for k, v in to_torch(case["data"]).items()}
    valid = torch.tensor(case["valid"])
    loss = tl.batch_neg_log_prob(rows, to_torch(case["dec"]), b, vocab, hp, spec, valid[blk],
                                 shard, torch.sum(valid))
    (g,) = torch.autograd.grad(loss, rows)
    return {"loss": shard.total(loss), "g_lat": shard.rows(g, lat_all.shape[0])}


def _tiny_prep(kw):
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.synthetic import synthesize_dataset

    return prepare_device_data(synthesize_dataset(**kw["dataset"]), **kw["prepare"])


def _result(res):
    out = {"config_nums": res.config_nums, "run_idxs": res.run_idxs,
           "final_train_loss": res.final_train_loss, "diverged": res.diverged,
           **{f"m:{k}": v for k, v in res.metrics.items()}}
    if res.embeddings is not None:
        out.update({f"emb_{s}": e for s, e in res.embeddings.items()})
    if res.predictions is not None:
        out["predictions"] = res.predictions
    return out


def run_sweep_case(case):
    from mmtpu_torch.parallel.multihost import run_sweep_multihost
    from mmtpu_torch.sweep.runner import run_chunk

    prep = _tiny_prep(case["prep"])
    if case["op"] == "chunk":
        return _result(run_chunk(case["configs"], prep, mesh=make_mesh(), device="cpu",
                                 **case["kw"]))
    return _result(run_sweep_multihost(case["configs"], prep, verbose=False, device="cpu",
                                       **case["kw"]))


def run_mesh_sweep(case):
    """``run_sweep`` over a config mesh of every rank, the part of rank
    ``fail_rank`` failing (``error`` "oom": out of memory, else a
    ``ValueError``) in every chunk whose block there is wider than
    ``fail_above`` configs.  Returns the result (none if the sweep raised),
    the block widths this rank queued, the retry lines it printed and the
    name of the error it raised ("" if none)."""
    import contextlib
    import io

    import mmtpu_torch.sweep.runner as srunner

    prep = _tiny_prep(case["prep"])
    rank = torch.distributed.get_rank()
    queue, tried = srunner._queue, []

    def failing(configs, *args, **kw):
        tried.append(len(configs))
        if rank == case["fail_rank"] and len(configs) > case["fail_above"]:
            raise (torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
                   if case["error"] == "oom" else ValueError("injected"))
        return queue(configs, *args, **kw)

    printed = io.StringIO()
    srunner._queue = failing
    out, raised = {}, ""
    try:
        with contextlib.redirect_stdout(printed):
            out = _result(srunner.run_sweep(case["configs"], prep, mesh=make_mesh(),
                                            device="cpu", verbose=True, **case["kw"]))
    except Exception as exc:
        raised = type(exc).__name__
    finally:
        srunner._queue = queue
    lines = [ln for ln in printed.getvalue().splitlines() if "failed on device" in ln]
    return dict(out, tried=tried, retries=lines, raised=raised)


RUN = {"latents": run_fit, "e2e": run_fit, "ops": run_ops, "step": run_step,
       "chunk": run_sweep_case, "multihost": run_sweep_case, "mesh_sweep": run_mesh_sweep}


def main() -> None:
    cases_path, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    init_world("cpu")
    rank = torch.distributed.get_rank()
    for case in torch.load(cases_path, weights_only=False):
        out = to_numpy(RUN[case["op"]](case))
        torch.save(out, os.path.join(out_dir, f"{case['name']}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
