"""One rank of a data-parallel run of the port's train step, for
``tests/test_torch_parallel.py`` (collects no tests; imports torch and the
port only, so a spawned rank starts fast).

    python tests/torch_dp_worker.py JOBS STORE RANK WORLD OUT

JOBS is a ``torch.save`` list of jobs, each {"name", "cfg" (the port's
config JSON), "batch" (numpy arrays: the GLOBAL batch), "steps", "grads"
(keep step 1's gradients), "state" (optional {network: state_dict} to start
from instead of the config's seeded init)}.  The rank joins a gloo group
through ``file://STORE``, runs every job through ``make_mesh``,
``replicate_state``, ``shard_batch`` and ``make_train_step``, and saves
{name: {"aux": [metrics of each step], "grads": step 1's (summed)
gradients, "params": the parameters after the last step}} to OUT.
``run_jobs`` runs the same jobs in one process (world 1) for the reference.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aas_enhancement_tpu_torch.config import Config  # noqa: E402
from aas_enhancement_tpu_torch.parallel.mesh import (DataMesh, make_mesh,  # noqa: E402
                                                     replicate_state, shard_batch)
from aas_enhancement_tpu_torch.train.loop import init_state  # noqa: E402
from aas_enhancement_tpu_torch.train.steps import make_train_step  # noqa: E402


def run_job(job: dict, mesh: DataMesh) -> dict:
    cfg = Config.from_json(job["cfg"])
    state = init_state(cfg, cfg.train.seed, mesh.device)
    for name, sd in (job.get("state") or {}).items():
        getattr(state, name).load_state_dict(sd)
    replicate_state(mesh, state)
    step = make_train_step(cfg, mesh=mesh)
    batch = shard_batch(mesh, job["batch"], cfg.train.grad_accum)
    out = {"aux": []}
    if job.get("grads"):
        grads, _ = step.batch_grads(state, batch)
        out["grads"] = {net: {n: g.detach().cpu() for n, g in gs.items()}
                        for net, gs in grads.items()}
    for _ in range(job["steps"]):
        state, aux = step(state, batch)
        out["aux"].append({k: float(v) for k, v in aux.items()})
    out["params"] = {net: {n: p.detach().cpu().clone()
                           for n, p in getattr(state, net).named_parameters()}
                     for net in ("g", "d", "am") if getattr(state, net) is not None}
    return out


def run_jobs(jobs: list[dict], mesh: DataMesh) -> dict:
    return {job["name"]: run_job(job, mesh) for job in jobs}


def main(argv: list[str]) -> None:
    jobs_path, store, rank, world, out_path = argv
    torch.set_num_threads(1)
    jobs = torch.load(jobs_path, weights_only=False)
    mesh = make_mesh(Config.from_json(jobs[0]["cfg"]).mesh, "cpu",
                     init_method=f"file://{store}", rank=int(rank),
                     world_size=int(world))
    try:
        results = run_jobs(jobs, mesh)
    finally:
        mesh.close()
    torch.save(results, out_path)


if __name__ == "__main__":
    main(sys.argv[1:])
