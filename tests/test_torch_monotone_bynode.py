"""The bynode case of ``tests/test_torch_monotone_penalty.py`` in a file of
its own, so that ``--dist loadfile`` trains it beside the other two:
``feature_fraction_bynode=0.5`` in the intermediate mode, which both
packages train on their synchronous bodies, against the JAX package's
fused engine (the same trees, predictions monotone in x0).
"""
import pytest
import torch

import test_torch_monotone_penalty as penalty

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["bynode"])
def trained(request):
    return penalty.train_both(request.param)


def test_trees_match_jax(trained):
    penalty.test_trees_match_jax(trained)


def test_monotone_in_x0(trained):
    penalty.test_monotone_in_x0(trained)
