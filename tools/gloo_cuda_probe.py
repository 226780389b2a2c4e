"""Whether this PyTorch build's gloo backend runs the collectives of
``parallel/mesh.py`` on a card's tensors: ``python3 tools/gloo_cuda_probe.py``.

Two ranks on card 0 (NCCL refuses two ranks on one device, so a gloo
group is the only group two ranks on one card can form) each call
``all_reduce``, ``all_gather`` and ``broadcast`` on CUDA tensors directly,
without a host copy. For each collective it prints whether it ran, and if
so whether the result is right, or the exception it raised. The last line
of stdout is one JSON object with those results, the PyTorch and CUDA
versions and the card's name and power limit.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import traceback


def rank_main(rank: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    res = {}

    def probe(name, fn):
        try:
            ok = bool(fn())
            res[name] = "ran, " + ("right" if ok else "WRONG")
        except Exception as e:          # the finding is the exception
            res[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"

    def all_reduce():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return torch.equal(t.cpu(), torch.full((4,), 3.0))

    def all_gather():
        t = torch.full((2,), float(rank), device=dev)
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        return torch.equal(torch.cat(parts).cpu(),
                           torch.tensor([0.0, 0.0, 1.0, 1.0]))

    def broadcast():
        t = torch.full((3,), float(rank + 7), device=dev)
        dist.broadcast(t, 0)
        return torch.equal(t.cpu(), torch.full((3,), 7.0))

    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("broadcast", broadcast)):
        probe(name, fn)
        dist.barrier()
    torch.cuda.synchronize()
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def main() -> int:
    import torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        procs = [ctx.Process(target=rank_main,
                             args=(r, os.path.join(tmp, "store"), outs[r]))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
        codes = [p.exitcode for p in procs]
        ranks = []
        for o in outs:
            try:
                with open(o) as f:
                    ranks.append(json.load(f))
            except OSError:
                ranks.append(None)
    for r, res in enumerate(ranks):
        print(f"rank {r} (exit {codes[r]}): {res}")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": card, "exit_codes": codes, "ranks": ranks}))
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
