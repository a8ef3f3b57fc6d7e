#!/usr/bin/env python3
"""Does gloo send and receive CUDA tensors?  Two ranks on ``cuda:0`` post a
send and a receive of a CUDA tensor to each other (``batch_isend_irecv``)
and print whether it worked or what it raised; gloo may also abort both
ranks from its own thread (``gloo::IoException``), which the parent
outlives.  ``parallel.mesh.ppermute`` stages a CUDA tensor through the
host under gloo because of the answer.

Run on a machine with a card: ``python3 tools/gloo_p2p_probe.py``.
"""

import datetime
import os
import subprocess
import sys
import tempfile


def _rank(r, tmp):
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=2, rank=r,
                            timeout=datetime.timedelta(seconds=30))
    t = torch.full((4,), float(r), device="cuda")
    got = torch.empty_like(t)
    try:
        ops = [dist.P2POp(dist.isend, t, 1 - r),
               dist.P2POp(dist.irecv, got, 1 - r)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        print(f"rank {r}: gloo sent and received CUDA tensors: "
              f"{got.tolist()}", flush=True)
    except RuntimeError as e:
        print(f"rank {r}: gloo send/recv of CUDA tensors raised: "
              f"{str(e)[:300]}", flush=True)
        os._exit(0)         # the peer's half failed too: leave at once
    dist.destroy_process_group()


def main():
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, __file__, str(r), tmp])
                 for r in range(2)]
        for p in procs:
            try:
                p.wait(timeout=90)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                print("the probe timed out", flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3:
        _rank(int(sys.argv[1]), sys.argv[2])
    else:
        main()
