"""Host-level sharding of the serving ladder (port of
``repro.dist.sharding``'s ``rung_shard``). The reference module's
device-level specs (PartitionSpecs for params, caches and inputs over a
mesh) come with the port of ``dist/`` on ``torch.distributed`` (ROADMAP
A10)."""
from __future__ import annotations

from typing import Sequence


def rung_shard(ladder_bits: Sequence[int], n_hosts: int
               ) -> dict[int, tuple[int, ...]]:
    """Assign ladder rungs to decode hosts, round-robin.

    The serving fleet's host-level rule (``serve_engine.fleet``): each
    decode host warms only its shard of the rung views, so the fleet's
    captured decode steps are flat in ladder depth x hosts rather than
    their product. Deterministic and total: every rung lands on at least
    one host and every host serves at least one rung; with more hosts than
    rungs the extra hosts replicate the ladder cyclically (capacity), with
    more rungs than hosts a host serves several rungs."""
    bits = sorted({int(b) for b in ladder_bits})
    if not bits or n_hosts <= 0:
        raise ValueError(f"need >=1 rung and >=1 host, got {bits!r} x "
                         f"{n_hosts}")
    shards: dict[int, set] = {h: set() for h in range(n_hosts)}
    for i in range(max(n_hosts, len(bits))):
        shards[i % n_hosts].add(bits[i % len(bits)])
    return {h: tuple(sorted(s)) for h, s in shards.items()}
