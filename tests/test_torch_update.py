"""The port's ``Booster.update()`` against the JAX package's epilogue path
on the configurations that compile a JAX step of their own (kept apart
from tests/test_torch_epilogue.py so the two files run side by side):
63 leaves, and the stop when no split meets the requirements. Same data,
comparison and tolerances as tests/test_torch_epilogue.py.
"""
import pytest
import torch

from torch_parity import assert_update_matches_jax, make_data

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    return make_data()


def test_update_matches_jax_leaves63(data):
    """63 leaves spend the budget mid-schedule, so the deferred route is
    not the last scheduled level's. L2: the fixture's binary label is a
    function of two features, and a 63-leaf binary tree splits noise whose
    gains tie exactly between different partitions."""
    assert_update_matches_jax(data, {"objective": "regression",
                                     "num_leaves": 63})


def test_update_matches_jax_no_split_stop(data):
    """Every tree has two leaves (min_data_in_leaf=1400 of 3,000 rows);
    the fourth tree's gain falls under min_gain_to_split, so both packages
    stop with three trees and the port drops its carry."""
    assert_update_matches_jax(data, {"min_data_in_leaf": 1400,
                                     "min_gain_to_split": 1000.0}, trees=3)
