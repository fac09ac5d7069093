"""Peak device memory of ``chip_smoke.py`` phase 3e's codec runs by node count.

Runs phase 3e's sync QSGD, CHOCO top-k on the neighbour wire and CHOCO on
the dense wire (Qwen2-VL-2B at full width, the phase's depth, DSE-MVR
through the kernels) on ``ring(n)`` for each node count ``n`` given, each
run in a process of its own for 2 rounds, and prints each run's report, or
the peak allocated memory and the frames where it ran out of the card,
with the tensors alive there summed by the frames that allocated them (the
allocator's record, ``torch.cuda.memory._record_memory_history``).

    python3 scripts/sharded_memory_probe.py 4 3

Needs a CUDA device; run from the root of the repository.
"""
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAGS = ("qsgd", "choco", "choco_dense")


def alive_by_frame(top: int = 14) -> list:
    """The allocator's blocks alive now, summed by the innermost three
    ``repro_torch`` / ``chip_smoke`` frames that allocated them: ``(GiB,
    blocks, frames)``, the largest first."""
    import torch

    groups = {}
    for seg in torch.cuda.memory._snapshot()["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            frames = [f"{Path(f['filename']).name}:{f['line']} {f['name']}"
                      for f in blk.get("frames", ())
                      if "repro_torch" in f["filename"] or "chip_smoke" in f["filename"]][:3]
            key = " < ".join(frames) or "(no python frame)"
            g = groups.setdefault(key, [0, 0])
            g[0] += blk["size"]
            g[1] += 1
    rows = sorted(((b / 2**30, n, k) for k, (b, n) in groups.items()), reverse=True)
    return rows[:top]


def one(tag: str, nodes: int) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import api
    from repro_torch.launch.mesh import make_test_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    _, kw, mode = cs.SHARD_RUNS[tag]
    cs.SHARD_RUNS[tag] = (nodes, kw, mode)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    torch.cuda.memory._record_memory_history(stacks="python", max_entries=100_000)
    t = time.perf_counter()
    try:
        run = cs.sharded_run(api, lambda n: make_test_mesh(n, device="cuda"), tag, 2)
    except torch.OutOfMemoryError as e:
        for gib, n, key in alive_by_frame():
            print(f"probe {tag} on {nodes} nodes: alive at the failure {gib:.2f} GiB in {n} "
                  f"blocks from {key}", flush=True)
        frames = [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                  for f in traceback.extract_tb(e.__traceback__)
                  if "repro_torch" in f.filename][-6:]
        print(f"probe {tag} on {nodes} nodes ({smi}): out of memory after "
              f"{time.perf_counter() - t:.1f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB; {str(e).splitlines()[0][:160]}; frames {frames}", flush=True)
        return 1
    cs.shard_report(run, smi)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        return one(sys.argv[2], int(sys.argv[3]))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.kernels import _cuda

    _cuda.build(["top_k", "flash_attention"])
    fits = {}
    for nodes in [int(a) for a in sys.argv[1:]] or [4, 3]:
        for tag in TAGS:
            out = subprocess.run([sys.executable, __file__, "--one", tag, str(nodes)],
                                 capture_output=True, text=True, timeout=600)
            print(out.stdout[-6000:].strip() or out.stderr[-6000:], flush=True)
            fits[f"{tag}@{nodes}"] = out.returncode == 0
    print(fits)
    return 0


if __name__ == "__main__":
    sys.exit(main())
