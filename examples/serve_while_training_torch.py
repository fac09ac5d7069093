"""Serve-while-training on the PyTorch port: inference replicas subscribed
to a live decentralized training run.

The counterpart of ``examples/serve_while_training.py`` on ``repro_torch``.
A tiny LM trains on a 4-node ring (DSE-MVR through the Simulator, its
update arithmetic through the fused-op kernels).  After every
communication round the node-mean parameters are published -- through a
snapshot codec, CHOCO-style difference publishing -- to a ``ReplicaSet``
whose replicas hold dequantized snapshots under per-replica staleness
bounds (the freshness SLO).  Between rounds the freshest replica answers
requests with the continuous-batching ``RequestDriver``.

  PYTHONPATH=src python examples/serve_while_training_torch.py        # on CUDA
  PYTHONPATH=src python examples/serve_while_training_torch.py \
      --codec qsgd --bounds 1,4 --device cpu --smoke

Exits non-zero if the freshness SLO is violated or the identity/bound-1
mirror is not bit-identical to the live params.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import NodeData, Simulator, make_algorithm, ring
from repro_torch.core.simulate import node_mean
from repro_torch.device import resolve_device
from repro_torch.models import Model, ModelConfig
from repro_torch.serving import ReplicaSet, RequestDriver
from repro_torch.tree import tree_leaves, tree_map

VOCAB, SEQ, N_NODES = 128, 16, 4


def make_token_data(seed=0, n_per_node=64):
    """Noisy modular-walk token streams -- learnable in a few rounds."""
    rng = np.random.default_rng(seed)

    def sequences(n):
        toks = np.zeros((n, SEQ + 1), np.int32)
        toks[:, 0] = rng.integers(0, VOCAB, n)
        for t in range(SEQ):
            step = np.where(rng.random(n) < 0.9, 3, rng.integers(1, VOCAB, n))
            toks[:, t + 1] = (toks[:, t] + step) % VOCAB
        return toks[:, :-1], toks[:, 1:]

    xs, ys = zip(*(sequences(n_per_node) for _ in range(N_NODES)))
    return NodeData(x=np.stack(xs), y=np.stack(ys))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--codec", default="qsgd",
                   help="snapshot wire codec: identity, qsgd, top_k:0.1, ...")
    p.add_argument("--bounds", default="1,4",
                   help="comma list of per-replica staleness bounds")
    p.add_argument("--rounds", type=int, default=12)
    p.add_argument("--tau", type=int, default=2)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--smoke", action="store_true", help="reduced run: 4 rounds")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    bounds = tuple(int(b) for b in args.bounds.split(","))
    rounds = 4 if args.smoke else args.rounds

    # -- the training side: a 2-layer LM on a 4-node ring ------------------
    model = Model(ModelConfig(
        name="lm-serve-example", arch_type="dense", n_layers=2, d_model=32,
        n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=VOCAB,
    ))

    def lm_loss(params, batch):
        # the Simulator's loss is node-stacked: one Model.loss per node slice
        xb, yb = batch
        return torch.stack([
            model.loss(tree_map(lambda p: p[i], params),
                       {"tokens": xb[i], "targets": yb[i]}, dtype=torch.float32)
            for i in range(xb.shape[0])])

    alg = make_algorithm("dse_mvr", lr=0.05, alpha=0.1, tau=args.tau, use_fused=True)
    sim = Simulator(alg, ring(N_NODES), lm_loss, make_token_data(), batch_size=8,
                    device=dev, seed=2)
    params = model.init(0, dtype=torch.float32, device=dev)
    state = sim.init_state(params)

    # -- the serving side: replicas subscribed through the snapshot wire ---
    # an identity set rides along to demonstrate the bit-identity guarantee
    replicas = ReplicaSet(params, codec=args.codec, bounds=bounds)
    mirror = ReplicaSet(params, codec="identity", bounds=(1,))
    driver = RequestDriver(model, slots=2, max_len=SEQ, device=dev)
    prompt = make_token_data(seed=7).x[0, 0, : SEQ // 2].tolist()
    workload = [(prompt, SEQ // 2)] * args.requests

    print(f"[serve_while_training] codec={replicas.publisher.tag} "
          f"bounds={bounds} rounds={rounds} on {dev}")
    for r in range(rounds):
        t0 = time.time()
        state = sim.run_rounds(state, 1)             # one training round
        live = node_mean(state.params)
        info = replicas.publish(live)                # snapshot tick
        mirror.publish(live)
        # serve from the FRESHEST replica while the next round trains
        driver.reset()
        stats = driver.run(replicas.params_for(0), workload)
        replicas.metrics.record_requests(
            stats["completed"], int(stats["tokens_per_sec"] * stats["elapsed_s"]),
            stats["elapsed_s"])
        print(f"  round {r:2d}: sent={info['sent'].astype(int).tolist()} "
              f"age={info['age'].tolist()} "
              f"rps={stats['requests_per_sec']:.1f} "
              f"({time.time() - t0:.2f}s)")

    # -- the guarantees -----------------------------------------------------
    replicas.assert_slo()                            # age_r < bound_r, always
    live = node_mean(state.params)
    for a, b in zip(tree_leaves(mirror.params_for(0)), tree_leaves(live)):
        assert torch.equal(a, b), "the identity mirror differs from the live params"
    streams = replicas.metrics.streams()
    kb = replicas.link_bytes() / 1e3
    print(f"[serve_while_training] SLO ok: {replicas.slo_report()}")
    print(f"[serve_while_training] identity/bound-1 mirror bit-identical to "
          f"live params after {rounds} rounds")
    print(f"[serve_while_training] send_rate={streams['send_rate'].mean():.2f} "
          f"link kbytes/replica={np.round(kb, 1).tolist()} "
          f"mean rps={streams['requests_per_sec'].mean():.1f}")
    print("[serve_while_training] OK")
    return {"slo": replicas.slo_report(), "link_bytes": replicas.link_bytes(),
            "streams": streams}


if __name__ == "__main__":
    main()
