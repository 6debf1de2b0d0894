"""Streaming ingest: a mutable kNN store serving while it changes.

Port of the repository's ``examples/streaming_ingest.py``; ``--device``
is the card unless ``cpu`` is given.  The paper's Algorithm 2 assumes a
static point set; this demo drives the mutable sharded store
(``store.MutableStore``) through its whole lifecycle under a live
server, with locality-aware placement (``placement="affinity"`` +
``redeal="proximity"``) so pruned routing pays on the mutable store too:

  1. stream a *clustered* insert mix in staged batches (host mirrors ->
     one scatter to the device -> epoch swap; affinity placement routes
     each point to its nearest live shard centroid),
  2. query mid-stream: answers report the generation they ran against
     and how many shards routing had to touch,
  3. delete points and check that tombstones never surface in answers,
  4. force a compaction: the proximity re-deal re-tightens the shard
     summaries, and the same query touches no more shards than before,
  5. run queries *concurrently* with an ingest thread: every request
     resolves (epoch swaps drop nothing), spanning many generations,
  6. finale (the operator layer): the declared latency SLO's burn-rate
     snapshot and one per-query explain report, why the last query
     touched the shards it touched, from ``QueryResult.explain()``.

Every answer is checked against brute force over the live points.

  PYTHONPATH=src python -m repro_torch.examples.streaming_ingest
  PYTHONPATH=src python -m repro_torch.examples.streaming_ingest \\
      --device cpu
"""

from __future__ import annotations

import argparse
import threading

import numpy as np

from repro_torch.configs.knn_service import CONFIG
from repro_torch.data import sharded_clusters
from repro_torch.runtime import KnnServer
from repro_torch.store import MutableStore

K = 8            # machines (shards)
CAP = 512        # slots per shard: fixes every device shape
DIM = 16
L = 8


def brute_ids(store, q, l):
    ids, pts = store.live_arrays()
    if not len(ids):
        return set()
    d = ((q[None].astype(np.float64) - pts.astype(np.float64)) ** 2).sum(-1)
    return set(ids[np.argsort(d, kind="stable")[:l]].tolist())


def main(argv=None):
    """Run the lifecycle and its checks; returns a summary dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--concurrent", type=int, default=32,
                    help="requests served while the ingest thread runs")
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    cfg = CONFIG.replace(dim=DIM, l=L, l_max=32, bucket_sizes=(1, 2, 4, 8),
                         store_capacity_per_shard=CAP,
                         store_compact_imbalance_frac=0.25,
                         route="pruned",            # summary-pruned routing
                         placement="affinity",      # locality-aware inserts
                         redeal="proximity",        # cluster-coherent repack
                         slo_latency_p99_s=0.5)     # a declared promise
    store = MutableStore(DIM, shards=K, device=args.device,
                         **cfg.store_kwargs())
    server = KnnServer(store=store, cfg=cfg, device=args.device)
    server.warmup()
    clusters, centers = sharded_clusters(K, 150, DIM, seed=2)
    stream = clusters[rng.permutation(len(clusters))]   # interleaved arrival
    q = (centers[3] + rng.normal(size=DIM)).astype(np.float32)

    # -- 1. streaming clustered inserts, affinity-placed -----------------
    print(f"capacity {K * CAP} slots ({K} shards x {CAP}); "
          f"placement={store.placement} redeal={store.redeal}")
    for batch in range(4):
        store.insert(stream[batch * 300:(batch + 1) * 300])
        gen = store.flush()
        print(f"  batch {batch}: +300 points -> generation {gen}, "
              f"live {store.live_count}")

    # -- 2. query mid-stream --------------------------------------------
    res = server.query_batch(q[None], [L])[0]
    assert set(res.ids.tolist()) == brute_ids(store, q, L)
    touched_before = res.shards_touched
    print(f"query @ generation {res.generation}: "
          f"nearest ids {sorted(res.ids.tolist())} (matches brute force), "
          f"shards touched {touched_before}/{K}")

    # -- 3. deletes: tombstones never surface ---------------------------
    victims = set(res.ids[:3].tolist())
    store.delete(sorted(victims))
    gen = store.flush()
    res = server.query_batch(q[None], [L])[0]
    assert not (set(res.ids.tolist()) & victims)
    assert set(res.ids.tolist()) == brute_ids(store, q, L)
    print(f"deleted {sorted(victims)} -> generation {gen}; new answer "
          f"excludes them and matches brute force")

    # -- 4. compaction: proximity re-deal tightens the routing ----------
    store.compact()
    res = server.query_batch(q[None], [L])[0]
    assert set(res.ids.tolist()) == brute_ids(store, q, L)
    touched_after = res.shards_touched
    print(f"compaction (reason: {store.stats.last_compact_reason}) "
          f"re-dealt by proximity -> generation {res.generation}; "
          f"same answer, shards touched {touched_before} -> "
          f"{touched_after}")
    print(f"  live histogram {server.placement_stats()['live_per_shard']}, "
          f"prune rate so far "
          f"{server.placement_stats()['prune_rate']:.2f}")

    # -- 5. queries under concurrent ingest -----------------------------
    stop = threading.Event()
    errors = []

    def ingest():
        # net-zero churn (delete everything inserted): two epoch swaps a
        # cycle, and the stream never fills the store
        r = np.random.default_rng(1)
        try:
            while not stop.is_set():
                ids = store.insert(r.normal(size=(64, DIM)).astype(
                    np.float32))
                store.flush()
                store.delete(ids)
                store.flush()
        except Exception as e:      # surfaced below, after the join
            errors.append(e)

    t = threading.Thread(target=ingest, daemon=True)
    gens = []
    with server.serving():
        t.start()
        try:
            futures = [server.submit(rng.normal(size=DIM).astype(np.float32),
                                     L) for _ in range(args.concurrent)]
            for f in futures:
                gens.append(f.result(timeout=120).generation)
        finally:
            stop.set()
            t.join(timeout=120)
    if t.is_alive() or errors:
        raise RuntimeError(f"the ingest thread failed: {errors}")
    print(f"{len(gens)}/{args.concurrent} concurrent queries resolved while "
          f"ingest ran; generations spanned {min(gens)}..{max(gens)} "
          f"(zero dropped by {max(gens) - min(gens)} epoch swaps)")
    print(f"final: generation {store.generation}, live {store.live_count}, "
          f"stats {store.stats}")

    # -- 6. the operator layer: SLO burn rate + a query-explain report --
    slo = server.obs_snapshot()["slo"]
    lat = slo["objectives"]["latency_p99"]
    print(f"slo latency_p99 <= {lat['bound']}s: "
          f"burn fast/slow {lat['burn_fast']:.2f}/{lat['burn_slow']:.2f} "
          f"over {lat['slow_events']} requests, "
          f"{slo['alerts_fired']} alerts fired "
          f"({len(slo['firing'])} firing now)")
    rep = server.explain_last(1)[0]
    kept = rep["routing"]["kept_shards"]
    print(f"explain (last query, batch {rep['batch']['id']} @ generation "
          f"{rep['batch']['generation']}):")
    print(f"  routing [{rep['routing']['mode']}/"
          f"{rep['routing']['compute']}]: kept shards {kept} of {K} "
          f"(threshold_eff {rep['routing']['threshold_eff']:.1f})")
    for s in rep["routing"]["shards"]:
        mark = "KEEP " if s["kept"] else "prune"
        print(f"    shard {s['shard']}: {mark} lower {s['lower']:.1f} "
              f"upper {s['upper']:.1f}")
    print(f"  timings: queued {rep['timings']['queued_s'] * 1e3:.2f}ms, "
          f"kernel {rep['timings']['kernel_s'] * 1e3:.2f}ms, "
          f"total {rep['timings']['latency_s'] * 1e3:.2f}ms; "
          f"maintenance raced: {rep['maintenance']['raced_commit']}")
    server.close()
    return {"touched_before": touched_before, "touched_after": touched_after,
            "generations": (min(gens), max(gens)), "resolved": len(gens),
            "final_generation": store.generation}


if __name__ == "__main__":
    main()
