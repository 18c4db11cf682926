"""Distributed tree learning over ``torch.distributed``.

PyTorch counterpart of ``lightgbm_tpu/parallel/`` (ref: src/network/*,
src/treelearner/{data,feature,voting}_parallel_tree_learner.cpp). One
process drives one device; the JAX package's in-jit ``psum`` / ``pmax``
over a mesh axis become all-reduces over a process group
(``ops/collectives.py``):

- data-parallel:    rows sharded; histogram all-reduce replaces the
                    reduce-scatter + SyncUpGlobalBestSplit exchange
                    (data_parallel_tree_learner.cpp:155-189,260).
- voting-parallel:  data-parallel + per-rank top-k feature voting caps the
                    all-reduced payload (voting_parallel_tree_learner.cpp:
                    151).
- feature-parallel: rows replicated, feature slices per rank; only split
                    records are exchanged
                    (feature_parallel_tree_learner.cpp:60-77).

The trainer (``boosting/gbdt.py``) runs ``tree_learner=data`` and
``voting`` over the default group with one rank per device, each rank
passing only its own rows (``multiproc.MultiProcLayout``); feature-parallel
needs every row on every rank and runs at the grower level
(``make_feature_parallel_grow_fn``). The JAX package's launcher and its
external-collectives bridge are not here yet (ROADMAP Queue A items 10
and 11).
"""
from . import distributed
from .data_parallel import make_sharded_grow_fn
from .mesh import DATA_AXIS, FEATURE_AXIS, shard_rows
from .tree_parallel import (make_feature_parallel_grow_fn,
                            make_voting_parallel_grow_fn, pad_features)

__all__ = [
    "DATA_AXIS", "FEATURE_AXIS", "shard_rows", "make_sharded_grow_fn",
    "make_feature_parallel_grow_fn", "make_voting_parallel_grow_fn",
    "pad_features", "distributed",
]
