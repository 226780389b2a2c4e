"""Run a function on a group of CPU ranks for the data-parallel tests
(``tests/test_torch_mesh.py``, ``tests/test_torch_dp.py``): each rank is a
spawned process in a gloo group that meets through a file under the
test's temporary directory (no ports, so parallel test workers do not
clash), one thread each. ``fn(rank, *args)`` must be importable by name
(a module-level function of a module that imports neither JAX nor the
JAX package); its result comes back pickled through a file."""

import datetime
import os
import pickle
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def _rank(fn, rank: int, world: int, tmp: str, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "store"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(rank, *args)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, world: int, tmp, *args) -> list:
    """→ [fn's result on rank r for r in range(world)]; a rank that fails
    fails the call with its traceback."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(fn, r, world, tmp, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S + 60)
    for p in procs:
        if p.is_alive():
            p.kill()
    errors = []
    for r, p in enumerate(procs):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    assert not errors, "\n".join(errors)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
