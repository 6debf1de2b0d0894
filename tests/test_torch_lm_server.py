"""The port's LM serving engine, CLI and kNN-LM example on the CPU.

``Server.generate`` at top_k = 1 must give the JAX ``Server``'s tokens,
token for token, on the reference's seeded weights carried across by
``convert.params_from_jax``: without a mesh, and on the reference's
``(4, 2)`` (data, model) mesh against the port's 2 vocabulary shards.
At top_k > 1 the draws come from different generators, so the port is
held to its own contract: selection and gather give the same tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import repro.configs as jconfigs
from repro.models import build_model as jbuild
from repro.models import sharding as shd
from repro.parallel.compat import set_mesh
from repro.runtime import ServeConfig as JServeConfig
from repro.runtime import Server as JServer
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.examples import knn_lm_serve
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models import transformer as ttr
from repro_torch.runtime import ServeConfig, Server

torch.set_num_threads(1)

ARCH = "qwen2-0.5b"


@pytest.fixture(scope="module")
def models():
    cfg = jconfigs.get(ARCH).reduced()
    api = jbuild(cfg)
    params = api.init_params(jax.random.PRNGKey(0))
    tcfg = tconfigs.get(ARCH).reduced()
    model = ttr.Transformer(tcfg)
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    return api, params, build_model(tcfg), model.requires_grad_(False)


@pytest.mark.parametrize("sampler", ["selection", "gather"])
@pytest.mark.parametrize("mesh_name", [None, "mesh42"])
def test_generate_equals_reference_at_top1(models, rng, request, mesh_name,
                                           sampler):
    api, params, tapi, model = models
    batch = {"tokens": rng.integers(0, api.cfg.vocab, (4, 8)).astype(
        np.int32)}
    steps = 6
    if mesh_name is None:
        srv = JServer(api, params, JServeConfig(max_seq=32, top_k=1,
                                                sampler=sampler),
                      cache_dtype=jnp.float32)
        want, jstats = srv.generate(batch, steps, key=jax.random.PRNGKey(1))
        shards = None
    else:
        mesh = request.getfixturevalue(mesh_name)
        with set_mesh(mesh):
            specs = api.param_specs()
            placed = jax.tree.map(
                lambda x, s: jax.device_put(
                    x, NamedSharding(mesh, shd.divisible(s, x.shape, mesh))),
                params, specs)
            srv = JServer(api, placed, JServeConfig(max_seq=32, top_k=1,
                                                    sampler=sampler),
                          mesh=mesh, cache_dtype=jnp.float32)
            want, jstats = srv.generate(batch, steps,
                                        key=jax.random.PRNGKey(1))
        shards = dict(mesh.shape)["model"]
    tsrv = Server(tapi, model, ServeConfig(max_seq=32, top_k=1,
                                           sampler=sampler), shards=shards)
    got, stats = tsrv.generate(batch, steps, key=1)
    assert got.dtype == np.int32 and got.shape == (4, steps)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert sorted(stats) == sorted(jstats)


@pytest.mark.parametrize("shards", [2, 8, 3])
def test_selection_and_gather_give_the_same_tokens(models, rng, shards):
    """``shards=3`` does not divide the vocabulary (256): -inf padding."""
    _, _, tapi, model = models
    batch = {"tokens": rng.integers(0, 256, (3, 8)).astype(np.int32)}
    seen = []

    def observe(logits, res):
        # every step's top-k is the stable descending sort of the row
        order = torch.argsort(-logits, dim=-1, stable=True)[:, :16]
        assert torch.equal(res.indices.long(), order)
        assert torch.equal(res.values, logits.gather(-1, order))
        seen.append((res.iterations, res.host_syncs))

    out = {}
    for sampler in ("selection", "gather"):
        srv = Server(tapi, model, ServeConfig(max_seq=32, top_k=16,
                                              sampler=sampler),
                     shards=shards, observe=observe)
        out[sampler], _ = srv.generate(batch, 8, key=5)
    np.testing.assert_array_equal(out["selection"], out["gather"])
    assert len(seen) == 2 * 7
    assert all(it > 0 and sy == it + 1 for it, sy in seen[:7])
    assert all(it == 0 for it, _ in seen[7:])


def test_serve_step_without_shards_samples_the_top_k(models, rng):
    _, _, tapi, model = models
    tok = torch.from_numpy(rng.integers(0, 256, (5,)).astype(np.int32))
    logits, _ = tapi.decode_step(model, tok,
                                 tapi.init_cache(5, 8, device="cpu"))
    top = torch.argsort(-logits, dim=-1, stable=True)[:, :4]
    for key in range(6):
        nxt, _ = tapi.serve_step(model, tok,
                                 tapi.init_cache(5, 8, device="cpu"), key,
                                 top_k=4, temperature=1.0)
        assert nxt.dtype == torch.int32
        assert bool((nxt[:, None] == top).any(1).all())


def test_launch_serve_lm_on_cpu(capsys):
    gen, stats = tserve.main(["--arch", ARCH, "--reduced", "--tokens", "4",
                              "--batch", "2", "--shards", "2",
                              "--device", "cpu"])
    assert gen.shape == (2, 4) and (gen >= 0).all() and (gen < 256).all()
    assert sorted(stats) == ["decode_s", "prefill_s", "tok_per_s"]
    assert "generated tokens" in capsys.readouterr().out


def test_launch_serve_knn_on_cpu():
    """The l-NN service over gaussian_clusters: the answer equals a
    brute-force top-l, and each query's class is the vote of its
    winners' labels."""
    pred, d, ids = tserve.main(["--arch", "knn-service", "--device", "cpu",
                                "--knn-points", "4096", "--knn-k", "8"])
    from repro_torch.data import gaussian_clusters
    kcfg = tconfigs.get("knn-service")
    pts, labels = gaussian_clusters(4096, kcfg.dim, kcfg.num_classes, seed=0)
    qs = np.random.default_rng(7).normal(
        scale=8.0, size=(kcfg.query_batch, kcfg.dim)).astype(np.float32)
    full = ((qs[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    for b in range(len(qs)):
        want = np.argsort(full[b], kind="stable")[:8]
        assert sorted(ids[b].tolist()) == sorted(want.tolist())
        votes = np.bincount(labels[want], minlength=kcfg.num_classes)
        assert pred[b] == int(np.argmax(votes))


@pytest.mark.parametrize("sampler", ["selection", "gather"])
def test_knn_lm_example_on_cpu(sampler, capsys):
    gen = knn_lm_serve.main(["--device", "cpu", "--steps", "4",
                             "--sampler", sampler])
    assert gen.shape == (knn_lm_serve.B, 5)
    assert (gen >= 0).all() and (gen < 256).all()
    assert "kNN-LM decode" in capsys.readouterr().out


def test_knn_lm_example_mixture(rng):
    """The example's loop: each step's mixed distribution sums to 1 and
    the drawn token lies in its top-k."""
    cfg = tconfigs.get(ARCH).reduced()
    api = build_model(cfg)
    params = api.init_params(0, device="cpu")
    keys = rng.normal(size=(8 * 64, cfg.d_model)).astype(np.float32)
    values = rng.integers(0, cfg.vocab, size=(8 * 64,)).astype(np.int32)
    server = knn_lm_serve.datastore_server(keys, values, device="cpu")
    prompt = rng.integers(0, cfg.vocab, (4, 6)).astype(np.int32)
    steps = []

    def observe(i, s):
        mixed = s["mixed"].transpose(0, 1).reshape(4, -1)
        assert torch.allclose(mixed.exp().sum(-1), torch.ones(4),
                              atol=1e-5)
        top = torch.argsort(-mixed, dim=-1,
                            stable=True)[:, :knn_lm_serve.TOP_K]
        assert bool((s["token"][:, None].long() == top).any(1).all())
        for b, r in enumerate(s["results"]):
            np.testing.assert_array_equal(r.values, values[r.ids])
        steps.append(i)

    with server.serving():
        gen, _ = knn_lm_serve.knn_lm_decode(api, params, server, prompt, 3,
                                            observe=observe)
    assert steps == [0, 1, 2] and gen.shape == (4, 4)


def test_synthetic_generators_equal_reference():
    """uniform_points and gaussian_clusters: the reference's seeded output
    exactly."""
    from repro.data import synthetic as jsyn
    from repro_torch.data import synthetic as tsyn
    np.testing.assert_array_equal(tsyn.uniform_points(100, 3, seed=4),
                                  jsyn.uniform_points(100, 3, seed=4))
    for got, want in zip(tsyn.gaussian_clusters(300, 5, 4, seed=2),
                         jsyn.gaussian_clusters(300, 5, 4, seed=2)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
