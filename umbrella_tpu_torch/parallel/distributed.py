"""Multi-process runs: processes (one a host, or one a group of cards) joined
by torch.distributed.

Counterpart of `umbrella_tpu/parallel/distributed.py`. The JAX package joins
hosts with `jax.distributed.initialize` and lays a (data=hosts, model=local
chips) mesh over the global device list, so tensor parallelism rides the
links inside a host and data parallelism crosses hosts. Here:

- `initialize` joins the process group through a TCPStore at the
  coordinator's address (tcp://host:port; process 0 serves it). Before the
  group exists, each process publishes the cards it drives (their UUIDs),
  and the backend follows from that layout: NCCL where every process has
  cards of its own, gloo where a process runs on the CPU or two processes
  share a card (NCCL refuses two ranks on one GPU). The choice is printed; it
  is never reached by catching a failure. A single process is a no-op.
- A device of the cluster is a `GlobalDevice(process, device)`.
  `order_by_process` groups an enumeration by process (stable), and
  `make_multihost_mesh` cuts the ordered list into a (data, model) grid whose
  model rows never straddle processes.
- `span()` is this process's place on an axis that spans every process
  (`ProcessSpan`): a gather over the group, which parallel/collectives.py
  uses to sum a tensor-parallel model's partials in global shard order, and
  training/data_parallel.py to sum the replicas' gradients in replica order.
  Gloo collectives run on host copies; NCCL on this process's first card.
"""
from __future__ import annotations

import datetime
import json
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


class GlobalDevice(NamedTuple):
    """A device of the cluster: the process that drives it and its torch.device there."""
    process: int
    device: torch.device


_STATE: dict = {}  # backend, devices (this process's) and span, once initialized
TIMEOUT = datetime.timedelta(minutes=5)  # for the store and every collective


def parse_address(address: str):
    """(host, port) of "host:port" or "tcp://host:port"."""
    if address is None:
        raise ValueError("a coordinator address (host:port) is needed for more than one process")
    host, _, port = address.split("://")[-1].rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not host:port")
    return host, int(port)


def default_devices() -> List[torch.device]:
    """Every visible card, or the CPU where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def card_ids(devices: Sequence) -> List[str]:
    """Each device's identity across processes: a card's UUID, or "cpu"."""
    ids = []
    for d in map(torch.device, devices):
        if d.type == "cuda":
            ids.append("cuda-" + str(torch.cuda.get_device_properties(d).uuid))
        else:
            ids.append(d.type)
    return ids


def choose_backend(layout: Sequence[Sequence[str]]):
    """(backend, why) for the processes' card_ids: gloo where a process runs
    on the CPU or a card belongs to two processes, else NCCL."""
    owner = {}
    for p, ids in enumerate(layout):
        for i in ids:
            if not i.startswith("cuda-"):
                return "gloo", f"process {p} runs on the {i}"
            if owner.setdefault(i, p) != p:
                return "gloo", (f"processes {owner[i]} and {p} share card {i[5:]} (NCCL "
                                "refuses two ranks on one GPU)")
    return "nccl", "each process has cards of its own"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               devices: Optional[Sequence] = None) -> Optional[str]:
    """Join this process to the group of `num_processes` (no-op if one or
    none); `devices` are the ones this process drives (default: every
    visible card, or the CPU). Returns the backend (None for the no-op)."""
    if num_processes is None or num_processes <= 1:
        return None
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is initialized already")
    host, port = parse_address(coordinator_address)
    local = [torch.device(d) for d in devices] if devices else default_devices()
    store = dist.TCPStore(host, port, num_processes, is_master=process_id == 0, timeout=TIMEOUT)
    store.set(f"cards/{process_id}", json.dumps(card_ids(local)))
    layout = [json.loads(store.get(f"cards/{p}")) for p in range(num_processes)]
    backend, why = choose_backend(layout)
    print(f"[distributed] process {process_id} of {num_processes}: backend {backend} ({why})",
          flush=True)
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes,
                            timeout=TIMEOUT)
    comm = local[0] if backend == "nccl" else torch.device("cpu")
    _STATE.update(backend=backend, devices=local, span=ProcessSpan(backend, comm))
    return backend


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_devices() -> List[torch.device]:
    """The devices this process drives (initialize's `devices`)."""
    return list(_STATE.get("devices") or default_devices())


def span() -> Optional["ProcessSpan"]:
    """This process's place on the axis over every process, or None for a
    single process."""
    return _STATE.get("span")


def global_devices() -> List[GlobalDevice]:
    """Every process's devices, in process order (each process's own list
    exchanged over the group)."""
    local = [str(d) for d in local_devices()]
    if not dist.is_initialized():
        return [GlobalDevice(0, torch.device(d)) for d in local]
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, local)
    return [GlobalDevice(p, torch.device(d)) for p, ds in enumerate(lists) for d in ds]


def _process_of(d) -> int:
    return getattr(d, "process", getattr(d, "process_index", 0))


def order_by_process(devices) -> list:
    """Devices stable-sorted into contiguous per-process blocks: a model row
    cut from an interleaved enumeration would otherwise straddle processes
    and put its every-layer sums on the link between them."""
    by_proc: dict = {}
    for d in devices:
        by_proc.setdefault(_process_of(d), []).append(d)
    return [d for p in sorted(by_proc) for d in by_proc[p]]


def make_multihost_mesh(model_per_host: Optional[int] = None, devices=None,
                        local_device_count: Optional[int] = None) -> List[list]:
    """A (data, model) grid over the cluster's devices: rows of
    `model_per_host` devices (default: a process's count), each inside one
    process; the data axis takes the rest, across processes. `devices` and
    `local_device_count` stand in for the live cluster in tests."""
    devices = list(devices) if devices is not None else global_devices()
    local = local_device_count or len(local_devices())
    model = model_per_host or local
    if local % model:
        raise ValueError(f"the model axis ({model}) must divide a process's {local} devices, "
                         "so that no model row leaves its process")
    ordered = order_by_process(devices)
    if len(ordered) % model:
        raise ValueError(f"{len(ordered)} devices do not make rows of {model}")
    rows = [ordered[r:r + model] for r in range(0, len(ordered), model)]
    for row in rows:
        if len({_process_of(d) for d in row}) != 1:
            raise ValueError(f"model row {row} straddles processes")
    return rows


def local_rows(grid: Sequence[Sequence[GlobalDevice]]) -> List[List[torch.device]]:
    """This process's rows of a make_multihost_mesh grid, as torch.devices."""
    me = process_index()
    return [[d.device for d in row] for row in grid if _process_of(row[0]) == me]


class ProcessSpan:
    """This process's place on an axis that spans every process of the
    group: `rank` of `size`. `gather` is the one collective; `calls` counts
    them (read by the chip check's collectives a step)."""

    def __init__(self, backend: str, comm_device: torch.device):
        self.backend = backend
        self.comm_device = comm_device
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.calls = 0

    def gather(self, parts: List[torch.Tensor], device) -> List[torch.Tensor]:
        """Every process's `parts` (the same count, shapes and dtype on each),
        process by process and in each process's order, on `device`."""
        self.calls += 1
        stacked = torch.stack([p.to(self.comm_device) for p in parts])
        out = [torch.empty_like(stacked) for _ in range(self.size)]
        dist.all_gather(out, stacked)
        return [t.to(device) for o in out for t in o.unbind(0)]
