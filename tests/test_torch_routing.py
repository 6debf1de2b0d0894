"""Pruned shard routing in the port against the JAX reference, on the CPU.

The instances are those of tests/test_routing.py (k = 8 shards of 64
points, dim 8, B = 4; families clustered / uniform / equidistant /
offset), made with numpy from a seed and handed to both packages.

* The summaries build (1, 2 and 4 pivots, with and without a valid
  mask) equals the reference's within 1e-9 relative; live counts, pivot
  counts and per-ball credits (the assignment) are equal.
* The masks are equal bit for bit: the port's host ``route_shards``, the
  reference's, the reference's ``kops.route_mask`` (the Pallas kernel in
  interpret mode, tests/conftest.py) and the port's ``ops.route_mask``
  (its plain version on the CPU).
* Served answers: the port's pruned server (host and device routing)
  answers byte-identically to its exact server, matches the JAX pruned
  server within rtol 1e-4 / atol 1e-3 with the same ``shards_touched``,
  and bills fewer messages than exact on the clustered instances.
"""

import numpy as np
import pytest
import torch

from repro.configs.knn_service import CONFIG as JCONFIG
from repro.data import sharded_clusters as jclusters
from repro.kernels import ops as jops
from repro.kernels import routing as jrouting
from repro.runtime import KnnServer as JaxServer
from repro.store import build_summaries as jbuild
from repro.store import route_shards as jroute
from repro.store.adaptive import compute_pivots as jpivots
from repro_torch.configs import CONFIG
from repro_torch.data import sharded_clusters
from repro_torch.kernels import ops as tops
from repro_torch.kernels import routing as trouting
from repro_torch.runtime import KnnServer
from repro_torch.store import adaptive as tadaptive
from repro_torch.store import build_summaries, route_shards, routing_detail

# the cases are small: one intra-op thread a process is faster here than
# a pool, and leaves the cores to the other test processes
torch.set_num_threads(1)

K = 8
DIM = 8
M = 64
N = K * M
B = 4
L_MAX = 256
L_SET = (1, 8, 256)
FAMILIES = ("clustered", "uniform", "equidistant", "offset")
PIVOTS = (1, 2, 4)
SLACK = CONFIG.route_slack
TOL = dict(rtol=1e-4, atol=1e-3)


def _instance(family: str, seed: int, scale: float = 1.0):
    """tests/test_routing.py's instance: (points (N, DIM) f32, contiguous
    by shard, queries (B, DIM) f32)."""
    rng = np.random.default_rng(seed)
    if family in ("clustered", "offset"):
        shift = 2000.0 if family == "offset" else 0.0
        pts, centers = sharded_clusters(K, M, DIM, shift=shift, rng=rng)
        q = centers[rng.integers(0, K, B)] + rng.normal(size=(B, DIM))
    elif family == "uniform":
        pts = rng.normal(size=(N, DIM))
        q = rng.normal(size=(B, DIM))
    else:       # every point exactly equidistant from the origin
        eye = np.eye(DIM)[np.arange(N) % DIM]
        sign = np.where(rng.random(N) < 0.5, 1.0, -1.0)
        pts = eye * sign[:, None] * 3.0
        q = np.zeros((B, DIM))
        q[B // 2:] = eye[rng.integers(0, N, B - B // 2)] * 3.0
    return (pts * scale).astype(np.float32), (q * scale).astype(np.float32)


def _same_summaries(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "generation":
            assert x == y
        elif x is None:
            assert y is None, f
        elif f in ("live", "pivot_count", "pivot_live"):
            assert np.array_equal(x, y), f
        else:
            np.testing.assert_allclose(y, x, rtol=1e-9, atol=0, err_msg=f)


def _port_mask(q, la, summ):
    return tops.route_mask(torch.from_numpy(q), torch.from_numpy(la),
                           trouting.pack_summaries(summ),
                           slack=SLACK).numpy()


# ---- data and build --------------------------------------------------------

def test_sharded_clusters_matches_jax():
    a, ca = sharded_clusters(K, M, DIM, shift=5.0, seed=3)
    b, cb = jclusters(K, M, DIM, shift=5.0, seed=3)
    assert a.tobytes() == b.tobytes() and ca.tobytes() == cb.tobytes()
    # the torch path: same layout, deterministic in the seed
    t1, c1 = sharded_clusters(K, M, DIM, seed=3, device="cpu")
    t2, _ = sharded_clusters(K, M, DIM, seed=3, device="cpu")
    assert t1.shape == (N, DIM) and t1.dtype == torch.float32
    assert torch.equal(t1, t2)
    near = (t1.reshape(K, M, DIM).double().mean(1).numpy() - c1)
    assert np.abs(near).max() < 1.0          # shard j clusters at center j


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pivots", PIVOTS)
@pytest.mark.parametrize("family", FAMILIES)
def test_build_summaries_matches_jax(family, pivots, masked):
    pts, _ = _instance(family, 7)
    valid = None
    if masked:
        valid = np.random.default_rng(3).random(N) > 0.3
        valid[3 * M:4 * M] = False                  # one shard empty
    _same_summaries(jbuild(pts, K, valid=valid, num_pivots=pivots),
                    build_summaries(pts, K, valid=valid, num_pivots=pivots))


@pytest.mark.parametrize("m", [1, 3, 8])
def test_compute_pivots_matches_jax(m):
    pts, _ = _instance("clustered", 5)
    want = jpivots(pts[:M], m)
    got = tadaptive.compute_pivots(pts[:M], m)
    assert got[2] == want[2]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9, atol=0)


def test_build_summaries_from_a_tensor_equals_numpy():
    pts, _ = _instance("uniform", 2)
    a = build_summaries(pts, K, num_pivots=2)
    b = build_summaries(torch.from_numpy(pts), K, num_pivots=2)
    _same_summaries(a, b)


# ---- the masks, bit for bit ------------------------------------------------

@pytest.mark.parametrize("l", L_SET)
@pytest.mark.parametrize("pivots", PIVOTS)
@pytest.mark.parametrize("family", FAMILIES)
def test_route_mask_bit_equal_to_jax(family, pivots, l):
    for seed in (0, 7):
        pts, q = _instance(family, seed)
        la = np.full(B, l, np.int64)
        js = jbuild(pts, K, num_pivots=pivots)
        ts = build_summaries(pts, K, num_pivots=pivots)
        host = jroute(js, q, la, slack=SLACK)
        dev = np.asarray(jops.route_mask(q, la, jrouting.pack_summaries(js),
                                         slack=SLACK))
        assert np.array_equal(route_shards(ts, q, la, slack=SLACK), host)
        assert np.array_equal(_port_mask(q, la, ts), dev), (family, seed)
        assert np.array_equal(dev, host)


def test_route_mask_tombstones_and_mixed_ls():
    """tests/test_routing.py:249: dead rows in every shard, two shards
    fully dead, an empty set, and l mixing 0 with live requests."""
    rng = np.random.default_rng(11)
    pts, q = _instance("clustered", 11)
    la = np.array([0, 1, 8, 256], np.int64)
    for pivots in PIVOTS:
        valid = rng.random(N) > 0.3
        valid[:M] = False
        valid[3 * M:4 * M] = False
        js = jbuild(pts, K, valid=valid, num_pivots=pivots)
        ts = build_summaries(pts, K, valid=valid, num_pivots=pivots)
        want = np.asarray(jops.route_mask(
            q, la, jrouting.pack_summaries(js), slack=SLACK))
        got = _port_mask(q, la, ts)
        assert np.array_equal(got, want), pivots
        assert np.array_equal(route_shards(ts, q, la, slack=SLACK), want)
        assert not got[0].any()
        assert not got[:, 0].any() and not got[:, 3].any()
    empty = build_summaries(pts, K, valid=np.zeros(N, bool))
    assert not _port_mask(q, la, empty).any()


def test_route_mask_equidistant_ties_keep_everything():
    """tests/test_routing.py:273: every shard's bounds coincide, so the
    sort-free threshold prunes nothing, like the host's stable prefix."""
    pts, q = _instance("equidistant", 5)
    la = np.full(B, 8, np.int64)
    for pivots in PIVOTS:
        ts = build_summaries(pts, K, num_pivots=pivots)
        got = _port_mask(q, la, ts)
        assert got.all()
        assert np.array_equal(got, route_shards(ts, q, la, slack=SLACK))
        js = jbuild(pts, K, num_pivots=pivots)
        assert np.array_equal(got, np.asarray(jops.route_mask(
            q, la, jrouting.pack_summaries(js), slack=SLACK)))


def test_route_mask_plain_returns_int32_rows():
    pts, q = _instance("uniform", 23)
    ts = build_summaries(pts, K, num_pivots=2)
    packed = trouting.on_device(trouting.pack_summaries(ts), "cpu")
    rows = trouting.route_mask_plain(torch.from_numpy(q),
                                     torch.full((B,), 8, dtype=torch.int32),
                                     packed, slack=SLACK)
    assert rows.dtype == torch.int32 and rows.shape == (B, K)
    assert set(rows.unique().tolist()) <= {0, 1}


def test_routing_detail_prefix_and_padding():
    """Shards in the cumulative-live prefix survive; l = 0 rows route
    nowhere; the detail's keep is route_shards'."""
    pts, q = _instance("clustered", 3)
    s = build_summaries(pts, K)
    for l in (1, 8, 64, 256, 1024):
        active = route_shards(s, q, np.full(B, l))
        assert (s.live[None, :] * active).sum(-1).min() >= min(l, N)
    la = np.array([0, 8, 0, 1])
    det = routing_detail(s, q, la, slack=SLACK)
    assert not det["keep"][0].any() and not det["keep"][2].any()
    assert np.array_equal(det["keep"], route_shards(s, q, la, slack=SLACK))
    assert (det["lower"] <= det["upper"]).all()


# ---- served answers --------------------------------------------------------

KW = dict(dim=DIM, l=8, l_max=L_MAX, bucket_sizes=(4,))


def _port(pts, **kw):
    return KnnServer(pts, cfg=CONFIG.replace(**{**KW, **kw}), shards=K,
                     device="cpu")


def _identical(ra, rb):
    for a, b in zip(ra, rb):
        assert a.dists.tobytes() == b.dists.tobytes()
        assert np.array_equal(a.ids, b.ids)


def _close(ra, rb):
    for a, b in zip(ra, rb):
        np.testing.assert_allclose(a.dists, b.dists, **TOL)


@pytest.fixture(scope="module")
def jax_pruned(mesh8):
    """The JAX pruned servers (host routing on tests/test_routing.py:329's
    instance, device routing on :532's) and their answers, built once."""
    out = {}
    for name, seed, rc in (("host", 11, "host"), ("device", 17, "device")):
        pts, q = _instance("clustered", seed)
        srv = JaxServer(pts, cfg=JCONFIG.replace(**KW, route="pruned",
                                                 route_compute=rc),
                        mesh=mesh8, axis_name="x")
        out[name] = (pts, q, {tuple(ls): srv.query_batch(q, ls)
                              for ls in ([1, 8, 256, 40], [1, 8, 4, 2])})
    return out


@pytest.mark.parametrize("jax_rc", ["host", "device"])
@pytest.mark.parametrize("route_compute", ["host", "device"])
def test_server_pruned_matches_jax_and_exact(jax_pruned, jax_rc,
                                             route_compute):
    pts, q, jres = jax_pruned[jax_rc]
    ex = _port(pts)
    pr = _port(pts, route="pruned", route_compute=route_compute)
    touched = 0
    for ls, want in jres.items():
        ra, rb = ex.query_batch(q, list(ls)), pr.query_batch(q, list(ls))
        _identical(ra, rb)
        _close(rb, want)
        assert [r.shards_touched for r in rb] == [
            r.shards_touched for r in want]
        assert all(r.shards_touched == K for r in ra)
        touched += rb[0].shards_touched
    # the small-l batch prunes, and pays fewer messages than exact
    assert all(r.shards_touched < K for r in rb)
    assert all(b.messages < a.messages for a, b in zip(ra, rb))
    stats = pr.placement_stats()
    assert stats["routed_batches"] == 2 and stats["prune_rate"] > 0
    assert pr.stats.snapshot()["touched_shards"] == touched
    audit = pr.obs_snapshot()["audit"]["contract"]
    assert audit["checks"] == 2 and audit["violations"] == 0


def test_server_pruned_gather_identical_and_cheaper():
    """tests/test_routing.py:348: the gather sampler prunes identically."""
    pts, q = _instance("clustered", 13)
    for rc in ("host", "device"):
        ex = _port(pts, sampler="gather", l_max=32)
        pr = _port(pts, sampler="gather", l_max=32, route="pruned",
                   route_compute=rc)
        ra = ex.query_batch(q, [1, 8, 32, 5])
        rb = pr.query_batch(q, [1, 8, 32, 5])
        _identical(ra, rb)
        assert all(b.messages < a.messages for a, b in zip(ra, rb))


def test_server_pruned_identical_far_from_origin():
    """The offset family: the error margin keeps every shard whose
    computed distances could hold a winner; answers stay identical."""
    for seed in (0, 7):
        pts, q = _instance("offset", seed)
        ls = [1, 8, 256, 40]
        ra = _port(pts).query_batch(q, ls)
        for rc in ("host", "device"):
            _identical(ra, _port(pts, route="pruned", route_compute=rc,
                                 summary_pivots=2).query_batch(q, ls))


def test_device_router_counts_its_readback():
    """Device routing reads the touched set back once per batch."""
    pts, q = _instance("clustered", 11)
    host = _port(pts, route="pruned").query_batch(q, [1, 8, 4, 2])
    dev = _port(pts, route="pruned",
                route_compute="device").query_batch(q, [1, 8, 4, 2])
    assert [r.host_syncs for r in dev] == [r.host_syncs + 1 for r in host]
    assert all(r.generation == 0 and r.recall_mode == "exact" for r in dev)


@pytest.mark.parametrize("mode", ["route", "route+index", "index"])
def test_route_index_unions_are_the_rows_any(mode):
    """ops.route_index (the plain version on the CPU) in each mode: its
    rows are route_mask_plain's and index_mask_plain's on the packed
    buffer's views, and its unions their any(0), shards then buckets."""
    from repro_torch.store import IndexMaintainer
    pts, q = _instance("clustered", 3)
    la = torch.tensor([0, 1, 8, 256], dtype=torch.int32)
    qt = torch.from_numpy(q)
    ts = build_summaries(pts, K, num_pivots=2)
    idx = IndexMaintainer(K, M, DIM, 4)
    idx.rebuild(pts)
    sops = trouting.pack_summaries(ts)
    iops = trouting.pack_index(idx.freeze(0))
    want_rows = trouting.route_mask_plain(
        qt, la, trouting.on_device(sops, "cpu"), slack=SLACK)
    given = want_rows.clone()
    given[:, 5] = 0                              # caller rows gate shard 5
    packed = trouting.PackedRouting(
        None if mode == "index" else sops,
        None if mode == "route" else iops, device="cpu", k=K, slack=SLACK)
    rows, keep, unions = tops.route_index(
        qt, la, packed, given if mode == "index" else None)
    gate = given if mode == "index" else want_rows
    want = [gate.any(0)]
    if mode == "route":
        assert keep is None
    else:
        want_keep = trouting.index_mask_plain(
            qt, la, gate, trouting.on_device(iops, "cpu"))
        assert torch.equal(keep, want_keep)
        want.append(want_keep.any(0))
    if mode == "index":
        assert rows is None
    else:
        assert torch.equal(rows, want_rows)
    assert unions.dtype == torch.bool
    assert torch.equal(unions, torch.cat(want))
    alone = tops.route_index(qt, la, packed,
                             given if mode == "index" else None,
                             with_rows=False)
    assert alone[0] is None and alone[1] is None
    assert torch.equal(alone[2], unions)
    assert unions.shape == (K + (0 if mode == "route" else K * 4),)
    # rows go with index-only operands, which need them
    with pytest.raises(ValueError):
        tops.route_index(qt, la, packed, None if mode == "index" else given)


# ---- store generations -----------------------------------------------------

def store_generations(pivots: int, seed: int, *, buckets: int = 0,
                      rounds: int = 6):
    """A port store on drifting clusters (affinity placement, re-tightening,
    the proximity re-deal), churned round by round; yields ``(store,
    queries (B, DIM) f32 near the clusters)`` after each round's flush."""
    from repro_torch.data import drifting_clusters
    from repro_torch.store import MutableStore
    rng = np.random.default_rng(seed)
    st = MutableStore(DIM, capacity_per_shard=M, device="cpu",
                      staging_size=10**9, placement="affinity",
                      redeal="proximity", summary_pivots=pivots,
                      retighten_every=24, index_buckets=buckets)
    live = []
    for pts, centers in drifting_clusters(K, 6, DIM, steps=rounds, drift=3.0,
                                          seed=seed):
        live += st.insert(pts).tolist()
        if len(live) > 60:
            gone = rng.choice(live, 12, replace=False)
            st.delete(gone)
            live = [i for i in live if i not in set(gone.tolist())]
            moved = rng.choice(live, 6, replace=False)
            st.update(moved, (centers[rng.integers(0, K, 6)]
                              + rng.normal(size=(6, DIM))).astype(np.float32))
        st.flush()
        q = centers[rng.integers(0, K, B)] + rng.normal(size=(B, DIM))
        yield st, q.astype(np.float32)


@pytest.mark.parametrize("pivots", [1, 2])
def test_route_rows_per_store_generation_equal_host(pivots):
    """Each generation's summaries, packed anew per generation: the plain
    route_index rows equal the port's and the reference's host
    route_shards bit for bit (the loosened radii and undercounted pivot
    credits between rebuilds included)."""
    la = np.array([0, 1, 8, 40])
    lt = torch.from_numpy(la.astype(np.int32))
    for st, q in store_generations(pivots, 5):
        summ = st.summaries()
        packed = trouting.PackedRouting(trouting.pack_summaries(summ),
                                        device="cpu", slack=SLACK)
        rows, _, unions = tops.route_index(torch.from_numpy(q), lt, packed)
        want = route_shards(summ, q, la, slack=SLACK)
        assert np.array_equal(rows.numpy() != 0, want)
        assert np.array_equal(jroute(summ, q, la, slack=SLACK), want)
        assert torch.equal(unions, rows.any(0))
    assert st.stats.retightens + st.stats.compactions > 0


@pytest.mark.parametrize("sampler", ["selection", "gather"])
def test_pruned_equals_exact_across_store_generations(sampler):
    """Servers over one churned store: the pruned routes (host and device)
    answer byte-identically to the exact route at every generation, and
    the device rows' union is the host rows'."""
    servers = None
    touched = []
    for st, q in store_generations(2, 9):
        if servers is None:
            kw = dict(dim=DIM, l=8, l_max=16, bucket_sizes=(4,),
                      sampler=sampler, summary_pivots=2)
            servers = [KnnServer(store=st, cfg=CONFIG.replace(**kw, **rk),
                                 device="cpu")
                       for rk in (dict(), dict(route="pruned"),
                                  dict(route="pruned",
                                       route_compute="device"))]
        ls = [1, 4, 16, 8]
        ex, host, dev = (s.query_batch(q, ls) for s in servers)
        for a, b, c in zip(ex, host, dev):
            assert a.generation == b.generation == c.generation == (
                st.generation)
            for r in (b, c):
                assert a.dists.tobytes() == r.dists.tobytes()
                assert np.array_equal(a.ids, r.ids)
            assert b.shards_touched == c.shards_touched
        touched.append(host[0].shards_touched)
    assert min(touched) < K
