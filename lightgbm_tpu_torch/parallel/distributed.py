"""Bringing the ranks up and down.

PyTorch counterpart of ``lightgbm_tpu/parallel/distributed.py``: the
reference's machine-list plumbing (ref: basic.py:2687
Booster.set_network -> LGBM_NetworkInit) maps onto
``torch.distributed.init_process_group``, one process per device.

    # on every host (rank r of N), or under torchrun with no arguments:
    from lightgbm_tpu_torch.parallel import distributed
    distributed.init_distributed("host0:1234", N, r)
    lgb.train({"tree_learner": "data", ...}, Dataset(my_rows, ...))

``init_distributed`` picks the backend by ``mesh.choose_backend`` (nccl
when each local rank has its own card, gloo otherwise), sets this rank's
card as the current CUDA device, gives the group a timeout, and makes the
host plane's CPU gloo group. ``set_network`` accepts the reference's
machine-list parameters; ``free_network`` tears the group down.
"""
from __future__ import annotations

from datetime import timedelta
from typing import Optional

from ..utils import log
from . import mesh

_INITIALIZED = False


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device_type: str = "cuda",
                     backend: Optional[str] = None,
                     timeout: float = mesh.DEFAULT_TIMEOUT_S) -> str:
    """Bring up the process group (ref: the Network::Init role,
    network.h:89) and return its backend. ``coordinator_address`` is
    ``host:port`` (``tcp://``), or a full init method (``file://...``,
    ``tcp://...``); with no arguments the group comes from torchrun's
    variables (``env://``), as JAX auto-detects on a pod. Idempotent."""
    global _INITIALIZED
    import torch
    import torch.distributed as dist
    if _INITIALIZED or dist.is_initialized():
        log.warning("distributed runtime already initialized; ignoring")
        _INITIALIZED = True
        return dist.get_backend()
    if coordinator_address is None:
        method = "env://"
    elif "://" in coordinator_address:
        method = coordinator_address
    else:
        method = f"tcp://{coordinator_address}"
    local_ws = None
    if method.startswith(("tcp://", "file://")) and num_processes:
        # every rank of a set_network / explicit launch may share one host
        local_ws = int(num_processes)
    if backend is None:
        backend = mesh.choose_backend(device_type, local_ws)
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend=backend, init_method=method,
                            timeout=timedelta(seconds=float(timeout)), **kw)
    if str(device_type).lower() != "cpu":
        torch.cuda.set_device(mesh.rank_device(device_type,
                                               dist.get_rank()))
    mesh.reset_host_group()
    mesh.host_group()
    _INITIALIZED = True
    log.info("distributed runtime up: rank %d/%d over %s",
             dist.get_rank(), dist.get_world_size(), backend)
    return backend


def set_network(machines: str, local_listen_port: int = 12400,
                num_machines: int = 1, time_out: int = 120) -> str:
    """Reference-parameter shim (ref: basic.py:2687 set_network): the
    first machine acts as the coordinator; this host's rank is its
    position in the comma-separated list. ``time_out`` (minutes in the
    reference) is the group's collective timeout here."""
    hosts = [m.strip() for m in machines.split(",") if m.strip()]
    if not hosts:
        raise ValueError("set_network: 'machines' must be a comma-separated "
                         "list of host[:port] entries, got an empty string")
    if num_machines > 1 and len(hosts) != num_machines:
        log.warning("machines lists %d hosts but num_machines=%d",
                    len(hosts), num_machines)
    import socket
    me = socket.gethostname()
    my_ids = {me}
    try:
        my_ids.add(socket.getfqdn())
        my_ids.add(socket.gethostbyname(me))
        my_ids.add("127.0.0.1")
        my_ids.add("localhost")
    except OSError:
        pass
    # rank: match host AND (when several entries share a host — multiple
    # processes per machine, as the reference format allows) this
    # process's local_listen_port
    candidates = [i for i, h in enumerate(hosts)
                  if h.split(":")[0] in my_ids]
    if not candidates:
        raise ValueError(
            f"set_network: none of the machines entries matches this host "
            f"({sorted(my_ids)}); list every worker's address, e.g. "
            f"'ip1:port,ip2:port'")
    if len(candidates) > 1:
        port_matches = [i for i in candidates
                        if ":" in hosts[i]
                        and hosts[i].rsplit(":", 1)[1].isdigit()
                        and int(hosts[i].rsplit(":", 1)[1])
                        == local_listen_port]
        if len(port_matches) != 1:
            raise ValueError(
                "set_network: multiple machines entries match this host; "
                "distinguish processes by giving each entry this "
                "process's local_listen_port")
        candidates = port_matches
    rank = candidates[0]
    # the coordinator is entry 0; its listed port wins over our local one
    c = hosts[0]
    if ":" in c and c.rsplit(":", 1)[1].isdigit():
        coord = f"{c.rsplit(':', 1)[0]}:{int(c.rsplit(':', 1)[1])}"
    else:
        coord = f"{c}:{local_listen_port}"
    return init_distributed(coord, len(hosts), rank,
                            timeout=60.0 * float(time_out))


def free_network() -> None:
    """(ref: basic.py:2721 free_network) Destroy the process group."""
    global _INITIALIZED
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh.reset_host_group()
    _INITIALIZED = False
