"""The moe family (granite-moe-3b, phi3.5-moe-42b), reduced, on the port
against the JAX package: forward logits and aux, the loss and its
gradients, prefill and decode, decode against teacher forcing (with the
continuous-routing control), one train step, and greedy generation.
Cases and tolerances: ``tests/torch_family_cases.py``."""

import pytest
import torch

import torch_family_cases as cases

torch.set_num_threads(1)

ARCHS = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"]


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


def test_moe_decode_continuous_routing_control(rng):
    cases.continuous_routing_control("phi3.5-moe-42b-a6.6b", rng)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_reference(arch, rng):
    cases.train_step(arch, rng)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference_at_top1(arch, rng):
    cases.generate_equals_reference(arch, rng, shards=2)
