"""The item-shard "mesh" of the sharded backend.

Port of ``tpu_cooccurrence/parallel/mesh.py``. The reference package lays
its shards on a 1-D ``jax.sharding.Mesh`` that one process drives through
``shard_map``; the port's single process drives a plain list of
``torch.device``s, one per shard, and sums the shards' partial row sums
itself (:mod:`.sharded`). A list may repeat a device: several shards on
one card, as the reference package's tests put eight shards on one host's
virtual devices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..device import resolve_device


def make_mesh(num_shards: Optional[int] = None,
              devices: Optional[Sequence] = None,
              device="cuda") -> List[torch.device]:
    """``num_shards`` devices, one per shard (default: every device).

    ``devices`` is an explicit list (it may repeat a device); without it,
    ``device="cuda"`` takes the visible cards and ``device="cpu"`` gives
    ``num_shards`` entries of the CPU. Raises when ``num_shards`` exceeds
    the devices, as the reference package's ``make_mesh`` does.
    """
    if devices is None:
        kind = resolve_device(device).type
        if kind == "cpu":
            devices = ["cpu"] * (1 if num_shards is None else num_shards)
        else:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if num_shards is None:
        num_shards = len(devices)
    if num_shards < 1:
        raise ValueError(f"--num-shards must be >= 1, got {num_shards}")
    if num_shards > len(devices):
        raise ValueError(
            f"requested {num_shards} shards but only {len(devices)} devices")
    return devices[:num_shards]


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
