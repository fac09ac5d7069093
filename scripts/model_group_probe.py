"""Where the model group's host staging spends its time on one card.

Two gloo ranks on the one card (a node over a model axis of 2, as
``chip_smoke.py`` phase 3g spreads Yi-9B): each rank holds ``n`` fp32
elements (default 350,000,000, about 1.4 GB: a rank's shard of a 1-layer
Yi-9B tree) and times, three times over, each step of a staged exchange --
the device-to-host copy into pageable and into pinned memory, gloo's own
all-gather of the host buffer, the host-to-device copies -- and the
``ModelGroup``'s whole ``all_gather`` and ``reduce_scatter`` (one message
to the peer by send / recv through pinned buffers kept for the next call).
Prints each rank's seconds by step as JSON.

    python3 -m torch.distributed.run --standalone --nproc-per-node 2 \\
        scripts/model_group_probe.py [n]

Needs a CUDA device; run from the root of the repository.
"""
import datetime
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_group_mesh

    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=300))
    group = make_group_mesh(1, device="cuda", model=2).model_group
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 350_000_000
    x = torch.randn(n, device="cuda")
    raw = x.view(torch.uint8)

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    out = []
    for _ in range(3):
        t = [clock()]
        host = raw.cpu()
        t.append(clock())
        bufs = [torch.empty_like(host) for _ in range(2)]
        dist.all_gather(bufs, host, group=group.group)
        t.append(clock())
        back = bufs[1 - group.index].to("cuda")
        t.append(clock())
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        t.append(clock())
        pinned.copy_(raw)
        t.append(clock())
        back = pinned.to("cuda")
        t.append(clock())
        full = group.all_gather([x], [0])[0]
        t.append(clock())
        group.reduce_scatter([full], [0])
        t.append(clock())
        steps = ("d2h_pageable", "gloo_all_gather", "h2d_pageable", "pin_alloc", "d2h_pinned",
                 "h2d_pinned", "group_all_gather", "group_reduce_scatter")
        out.append({k: round(b - a, 4) for k, a, b in zip(steps, t, t[1:])})
        del host, bufs, back, pinned, full
    print(dist.get_rank(), f"{raw.numel()} bytes a rank", json.dumps(out), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
