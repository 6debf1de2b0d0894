"""The families with a modality stub, reduced, on the port against the
JAX package: vlm (pixtral-12b: patch embeddings ahead of the tokens, the
loss over the token positions only) and audio (seamless-m4t-v2: the
encoder over stub frames, the decoder with cross-attention).  Forward
logits, the loss and its gradients, prefill and decode, decode against
teacher forcing, one train step, greedy generation (cases and
tolerances: ``tests/torch_family_cases.py``); then the entry points on
the CPU, and the vlm cache's size, where the port departs from the
reference's launcher.
"""

import argparse
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import serve as jserve
import repro_torch.configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import build_model
from repro_torch.runtime import ServeConfig, Server

import torch_family_cases as cases

torch.set_num_threads(1)

ARCHS = ["pixtral-12b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_reference(arch, rng):
    cases.forward(arch, rng)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_reference(arch, rng):
    cases.loss_and_gradients(arch, rng)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_reference(arch, rng):
    cases.prefill_and_decode(arch, rng)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch, rng):
    cases.decode_matches_teacher_forcing(arch, rng)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_reference(arch, rng):
    cases.train_step(arch, rng)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference_at_top1(arch, rng):
    cases.generate_equals_reference(arch, rng, shards=2)


def test_encdec_cache_holds_the_encoder_states(rng):
    """seamless: the prefill writes the encoder's output into the
    cache's ``enc_out`` in place, and decode reads it from there."""
    api, _, tapi, model = cases.pair("seamless-m4t-large-v2")
    b = cases.batch(api.cfg, rng, labels=False)
    cache = tapi.init_cache(2, 24, device="cpu")
    enc = cache["enc_out"]
    assert tuple(enc.shape) == (2, api.cfg.frontend_frames, api.cfg.d_model)
    _, cache = tapi.prefill(model, b, cache)
    assert cache["enc_out"] is enc and float(enc.abs().max()) > 0
    from repro_torch.models import encdec
    with torch.no_grad():
        want = encdec.encode(model, torch.from_numpy(b["frames"]))
    assert torch.equal(enc, want)


# ---- entry points -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_on_cpu(arch, capsys):
    gen, stats = tserve.main(["--arch", arch, "--reduced", "--tokens", "4",
                              "--batch", "2", "--shards", "2",
                              "--device", "cpu"])
    vocab = tconfigs.get(arch).reduced().vocab
    assert gen.shape == (2, 4) and (gen >= 0).all() and (gen < vocab).all()
    assert sorted(stats) == ["decode_s", "prefill_s", "tok_per_s"]
    assert "generated tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_on_cpu(arch, capsys):
    step, losses = tlaunch.main(["--arch", arch, "--reduced", "--steps", "2",
                                 "--batch", "2", "--seq", "16",
                                 "--device", "cpu"])
    assert step == 2 and len(losses) == 2
    assert all(math.isfinite(x) for x in losses)
    assert "done: steps=2 first_loss=" in capsys.readouterr().out


# ---- the vlm prefix and the cache's size ---------------------------------------

def _big_prefix(configs_mod, arch="pixtral-12b"):
    return dataclasses.replace(configs_mod.get(arch).reduced(),
                               num_prefix_embeds=32)


def test_vlm_cache_sized_for_the_prefix(monkeypatch, capsys):
    """The reference's launcher sizes the cache prompt + tokens + 8 and
    leaves out the prefix: with 32 prefix embeds, an 8-token prompt and
    4 new tokens its prefill of 40 positions does not fit 20, and it
    fails.  The port's launcher adds the prefix (52) and serves."""
    jcfg = _big_prefix(jconfigs)
    monkeypatch.setattr(jserve.configs, "get", lambda name: jcfg)
    args = argparse.Namespace(arch="pixtral-12b", reduced=False, batch=2,
                              prompt=8, tokens=4, top_k=1,
                              sampler="selection", num_pivots=1, mesh=None,
                              seed=0)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jserve.serve_lm(args)
    tcfg = _big_prefix(tconfigs)
    monkeypatch.setattr(tserve.configs, "get", lambda name: tcfg)
    gen, _ = tserve.main(["--arch", "pixtral-12b", "--prompt", "8",
                          "--tokens", "4", "--batch", "2", "--top-k", "1",
                          "--device", "cpu"])
    assert gen.shape == (2, 4)


def test_prefill_into_a_small_cache_raises_naming_both_sizes(rng):
    """A prefill whose prefix and prompt (40 positions) do not fit the
    cache (20) raises ``ValueError`` naming both, as a full cache does
    in decode."""
    tcfg = _big_prefix(tconfigs)
    api = build_model(tcfg)
    model = api.init_params(0, device="cpu")
    b = cases.batch(tcfg, rng, b=2, s=8, labels=False)
    srv = Server(api, model, ServeConfig(max_seq=20, top_k=1))
    with pytest.raises(ValueError, match="prefill of 40 positions .* 20"):
        srv.generate(b, 4)
    gen, _ = Server(api, model, ServeConfig(max_seq=52, top_k=1)).generate(
        b, 4)
    assert gen.shape == (2, 4) and np.isfinite(gen).all()
