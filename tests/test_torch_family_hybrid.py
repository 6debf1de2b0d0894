"""The hybrid family (jamba-1.5-large: Mamba with attention at position 7
of each 8, MoE at the odd positions), reduced, on the port against the
JAX package: forward logits and aux, the loss and its gradients, prefill
and decode, decode against teacher forcing, one train step, and greedy
generation.  Cases and tolerances: ``tests/torch_family_cases.py``."""

import pytest
import torch

import torch_family_cases as cases

torch.set_num_threads(1)

ARCHS = ["jamba-1.5-large-398b"]


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
    cases.generate_equals_reference(arch, rng, shards=None)


def test_layer_pattern():
    """jamba reduced: 16 layers, attention at 7 and 15, MoE at the odd
    positions."""
    model = cases.pair("jamba-1.5-large-398b")[3]
    assert [b.mixer for b in model.blocks] == (["mamba"] * 7 + ["attn"]) * 2
    assert [b.ffn_kind for b in model.blocks] == ["ffn", "moe"] * 8
