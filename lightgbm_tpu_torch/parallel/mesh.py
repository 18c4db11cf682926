"""Process groups of the distributed learners.

PyTorch counterpart of ``lightgbm_tpu/parallel/mesh.py``. The JAX package
names axes on one device mesh that one process drives; in PyTorch one
process drives one device, so the "mesh" is a ``torch.distributed``
process group with one rank per device, and a grower's ``group`` takes the
place of the JAX growers' ``psum_axis`` (``None`` = serial).

- ``DATA_AXIS`` / ``FEATURE_AXIS`` keep the JAX axis names (the learners'
  modes and the logs use them).
- :func:`rank_device`: this rank's device, ``cuda:<local_rank %
  device_count>``, unless the caller asks for the CPU; a rank whose card
  is missing raises, it never carries on on the CPU.
- :func:`choose_backend`: ``nccl`` when every local rank has a card of its
  own, ``gloo`` otherwise (CPU tensors, or ranks sharing a card: NCCL
  refuses two ranks on one device). The choice is logged and returned.
- :func:`host_group`: a second, CPU ``gloo`` group for the host plane
  (row counts, binning samples, metadata, digests), the counterpart of
  JAX's ``process_allgather``; under a ``gloo`` default group it is that
  group.
- :func:`shard_rows`: this rank's contiguous block of a host array, rows
  padded to a multiple of the world size (``mesh.py:87-100``; the pad rows
  carry zero weight downstream).

The JAX device-placement helpers (``replicate``, ``make_mesh_2d``,
``shard_map``, ``donate_argnums``) have no torch counterpart: a rank holds
its own tensors on its own device, replicated state is the same Python
program run on every rank, and PyTorch updates buffers in place without
donation.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np

from ..utils import log

DATA_AXIS = "data"
FEATURE_AXIS = "feature"

# every group's collective timeout: a rank that dies fails its peers
# within this many seconds instead of blocking them for good
DEFAULT_TIMEOUT_S = 120.0

_host = {"group": None}


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``; the
    global rank when unset)."""
    import torch.distributed as dist
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device_type: str = "cuda", rank: Optional[int] = None):
    """This rank's device: ``cuda:<local rank % device_count>``, or the
    CPU when ``device_type`` is ``cpu``. Raises when a card is asked for
    and none is present."""
    import torch
    if str(device_type).lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        log.fatal("rank %d asked for device_type=%r but no CUDA device is "
                  "present; pass device_type='cpu' to train on the CPU",
                  local_rank() if rank is None else rank, device_type)
    r = local_rank() if rank is None else rank
    return torch.device("cuda", r % torch.cuda.device_count())


def choose_backend(device_type: str = "cuda",
                   local_world_size: Optional[int] = None) -> str:
    """``nccl`` when the ranks train on cards and each local rank has a
    card of its own; ``gloo`` otherwise. Logs the rule's choice."""
    import torch
    lws = int(local_world_size if local_world_size is not None
              else os.environ.get("LOCAL_WORLD_SIZE", 1))
    if str(device_type).lower() == "cpu":
        backend, why = "gloo", "CPU tensors"
    elif not torch.cuda.is_available():
        backend, why = "gloo", "no CUDA device"
    elif lws > torch.cuda.device_count():
        backend, why = "gloo", (f"{lws} local ranks share "
                                f"{torch.cuda.device_count()} card(s)")
    else:
        backend, why = "nccl", (f"{lws} local rank(s) on "
                                f"{torch.cuda.device_count()} card(s)")
    log.info("distributed backend: %s (%s)", backend, why)
    return backend


def host_group():
    """The CPU ``gloo`` group of the host plane. Made on first use, which
    every rank reaches at the same point of the same program."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return None
    if _host["group"] is None:
        if dist.get_backend() == "gloo":
            _host["group"] = dist.group.WORLD
        else:
            _host["group"] = dist.new_group(
                backend="gloo", timeout=timedelta(seconds=DEFAULT_TIMEOUT_S))
    return _host["group"]


def reset_host_group() -> None:
    _host["group"] = None


def world() -> int:
    """Ranks in the default group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_rows(array, rank: int, world_size: int, pad_value=0) -> np.ndarray:
    """Rank ``rank``'s contiguous block of ``array``'s rows, the rows
    padded with ``pad_value`` to a multiple of ``world_size`` first."""
    array = np.asarray(array)
    n = array.shape[0]
    rem = (-n) % world_size
    if rem:
        pad_width = [(0, rem)] + [(0, 0)] * (array.ndim - 1)
        array = np.pad(array, pad_width, constant_values=pad_value)
    block = array.shape[0] // world_size
    return array[rank * block:(rank + 1) * block]
