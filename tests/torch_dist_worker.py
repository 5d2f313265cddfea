"""Worker process of the two-process torch.distributed test of the port
(tests/test_torch_parallel.py). Run as:

    python tests/torch_dist_worker.py <host:port> <rank> <nprocs> <out.npz>

Joins a gloo process group on localhost through
diffbindfr_torch/parallel/dist.py, takes its contiguous share of a job
table, all-reduces the gradients of a small linear model over the ranks'
shares of a batch, and samples its rows of a global replica batch (noise
drawn for the whole batch from one seeded generator, each rank taking its
rows); the ranks' poses are gathered and written with the rest.
"""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from diffbindfr_torch import sampler as sp  # noqa: E402
from diffbindfr_torch.parallel import dist as D  # noqa: E402

torch.set_num_threads(1)

NREP = 4  # global replica batch of the sampler
SAMPLE = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache/3mhw_r12.npz")


def sampler_inputs():
    """(params, net config, sampler config, global host batch, global
    noise) of the small net on NREP copies of the 3mhw cache: the same on
    every rank and in the test's single-process run."""
    from diffbindfr_torch.data.sample import _load_sample_npz, stack_samples
    from diffbindfr_torch.models import score_net as sn

    cfg = sn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2)
    params = sn.init_params(torch.Generator().manual_seed(3), cfg)
    scfg = sp.SamplerConfig(inference_steps=4, actual_steps=2)
    host = stack_samples([_load_sample_npz(SAMPLE)] * NREP)
    noise = sp.draw_noise(host, scfg, torch.Generator().manual_seed(11))
    return params, cfg, scfg, host, noise


def main():
    coord, rank, nprocs, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch.distributed as td

    pi, pc = D.init_distributed(coordinator_address=coord, num_processes=nprocs,
                                process_id=rank, device="cpu")
    assert (pi, pc) == (rank, nprocs), (pi, pc)
    assert td.get_backend() == "gloo"
    jobs = D.shard_jobs_for_host([f"job{i}" for i in range(10)])

    # gradients of mean((x @ w)^2) over the ranks' rows, all-reduced
    rows = 4
    x = torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3) + 100.0 * pi
    w = torch.ones(3, requires_grad=True)
    loss = ((x @ w) ** 2).mean()
    (g,) = torch.autograd.grad(loss, w)
    td.all_reduce(g)
    g /= pc
    ltot = loss.detach().clone()
    td.all_reduce(ltot)
    full = torch.cat([torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3) + 100.0 * p
                      for p in range(pc)])
    wf = torch.ones(3, requires_grad=True)
    exp_loss = ((full @ wf) ** 2).mean()
    (exp_g,) = torch.autograd.grad(exp_loss, wf)

    # the sampler over this rank's rows of the global batch
    params, cfg, scfg, host, noise = sampler_inputs()
    per = NREP // pc
    mine = list(range(pi * per, (pi + 1) * per))
    batch = type(host)(*[torch.as_tensor(v[mine[0] : mine[-1] + 1]) for v in host])
    with torch.no_grad():
        res = sp.sample(params, cfg, scfg, batch, noise.select(mine), use_kernels=False)
    parts = [torch.empty_like(res.lig_pos) for _ in range(pc)]
    td.all_gather(parts, res.lig_pos.contiguous())
    td.barrier()
    np.savez(out, rank=pi, nprocs=pc, is_main=D.is_main_process(), jobs=np.array(jobs),
             loss=float(ltot / pc), exp_loss=float(exp_loss), grad=g.numpy(),
             exp_grad=exp_g.numpy(), rows=np.array(mine), lig_pos=res.lig_pos.numpy(),
             gathered=torch.cat(parts).numpy())
    td.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
