"""Key -> server assignment (EncodeDefaultKey, global.cc:566-677): the
``naive``, ``built_in``, ``djb2`` and ``sdbm`` hash functions and mixed
mode, with the same arithmetic as ``byteps_tpu.common.hashing``, so a
worker of either package sends each key to the same server.  The string
hashes hash the key's decimal string (global.cc:606-627).  The
consistent-hash ring (``fn="ring"``, :class:`HashRing`,
:class:`OwnershipMap`) is the ownership of the elastic resharding
plane, bit for bit the reference's and the C++ engine's."""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_MASK64 = 0xFFFFFFFFFFFFFFFF


def hash_naive(key: int, coef: int = 1) -> int:
    # fold the partition index into the declared-key half before scaling
    return (((key >> 16) + (key % 65536)) * 9973) & _MASK64


def hash_built_in(key: int, coef: int = 1) -> int:
    # a stable FNV-1a over the decimal string (Python's hash() is salted)
    h = 0xCBF29CE484222325
    for ch in str(key).encode():
        h ^= ch
        h = (h * 0x100000001B3) & _MASK64
    return (h * coef) & _MASK64


def hash_djb2(key: int, coef: int = 1) -> int:
    h = 5381
    for ch in str(key).encode():
        h = ((h << 5) + h + ch) & _MASK64
    return h


def hash_sdbm(key: int, coef: int = 1) -> int:
    h = 0
    for ch in str(key).encode():
        h = (ch + (h << 6) + (h << 16) - h) & _MASK64
    return h


_HASH_FNS: Dict[str, Callable[[int, int], int]] = {
    "naive": hash_naive,
    "built_in": hash_built_in,
    "djb2": hash_djb2,
    "sdbm": hash_sdbm,
}


def hash_mixed_mode(
    key: int, num_servers: int, num_workers: int, bound: int = 101
) -> int:
    """Hash_Mixed_Mode (global.cc:566-596): the first ``num_servers -
    num_workers`` ranks are dedicated servers and absorb the share
    ratio = 2s(w-1) / (w(w+s) - 2s) of the keys; the rest go to the
    servers colocated with workers."""
    noncolo = num_servers - num_workers
    if noncolo <= 0:
        raise ValueError("mixed mode needs more servers than workers")
    if bound < num_servers:
        raise ValueError(
            f"BYTEPS_MIXED_MODE_BOUND ({bound}) must be >= num_servers "
            f"({num_servers}) to cover each server"
        )
    ratio = (2.0 * noncolo * (num_workers - 1)) / (
        num_workers * (num_workers + noncolo) - 2 * noncolo
    )
    if not 0.0 <= ratio <= 1.0:
        raise ValueError(
            "more non-colocated servers than workers is not permitted in "
            "mixed mode (ratio out of [0,1])"
        )
    hash_res = hash_djb2(key) % bound
    if hash_res < ratio * bound:
        return hash_djb2(hash_res) % noncolo
    return noncolo + (hash_djb2(hash_res) % num_workers)


def _djb2_bytes(data: bytes) -> int:
    """djb2 over raw bytes — same recurrence as :func:`hash_djb2` (which
    hashes the key's decimal string), kept separate so virtual-node
    labels hash without an int round trip."""
    h = 5381
    for ch in data:
        h = ((h << 5) + h + ch) & _MASK64
    return h


def _mix64(z: int) -> int:
    """splitmix64 finalizer — spreads a hash over the full u64 space.
    djb2 alone is USELESS as a ring coordinate: over the short strings
    involved (vnode labels, decimal keys) its values cluster in a tiny
    numeric band near the bottom of the space, so every key would sort
    past every point, wrap, and land on whichever rank owns the first
    point — one rank owns the whole key space.  The finalizer is the
    same arithmetic as wire.h ``key_stripe``'s, so the C++ engine's
    redirect check (``ring_key_hash``) stays bit-identical."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def ring_key_hash(key: int) -> int:
    """A tensor key's ring coordinate: splitmix64(djb2(str(key))).
    Pinned against the live C++ twin (wire.h ``ring_key_hash`` via
    ``bps_wire_ring_hash``) in tests/test_torch_port_reshard.py — workers, Python
    servers, and the native engine must agree on ownership bit-for-bit."""
    return _mix64(hash_djb2(key))


class HashRing:
    """Consistent-hash ring over a set of server RANKS.

    Each rank contributes ``vnodes`` virtual points (splitmix64-finalized
    djb2 of ``"s<rank>#<v>"``); a key is owned by the first point
    clockwise of :func:`ring_key_hash`.  Adding or removing one rank
    re-homes only the
    key ranges adjacent to that rank's points (≈ 1/n of the key space),
    which is what makes live migration a bounded window instead of a
    full re-shuffle — the property the elastic resharding plane
    (docs/robustness.md "migration flow") is built on.

    Deterministic across processes and languages: djb2 is the repo's
    stable string hash (global.cc:606-616 parity), so workers, Python
    servers, and the C++ engine (which receives the point arrays via
    ``bps_native_server_set_ownership``) all agree on ownership.
    """

    __slots__ = ("ranks", "vnodes", "_hashes", "_ranks")

    def __init__(self, ranks: Sequence[int], vnodes: int = 64) -> None:
        self.ranks: Tuple[int, ...] = tuple(sorted({int(r) for r in ranks}))
        if not self.ranks:
            raise ValueError("hash ring needs at least one server rank")
        self.vnodes = max(1, int(vnodes))
        pts = sorted(
            (_mix64(_djb2_bytes(f"s{r}#{v}".encode())), r)
            for r in self.ranks
            for v in range(self.vnodes)
        )
        self._hashes = [h for h, _ in pts]
        self._ranks = [r for _, r in pts]

    def owner(self, key: int) -> int:
        i = bisect.bisect_right(self._hashes, ring_key_hash(key))
        if i >= len(self._hashes):
            i = 0  # wrap: past the last point → first point
        return self._ranks[i]

    def points(self) -> List[Tuple[int, int]]:
        """Sorted ``(point_hash, rank)`` pairs — the serialized form the
        native engine's ownership check consumes."""
        return list(zip(self._hashes, self._ranks))


class OwnershipMap:
    """Epoch-stamped key→server-rank ownership (docs/robustness.md
    "migration flow").

    The scheduler bumps ``epoch`` on every server-set change and ships
    (epoch, ranks) in address books; workers route by it, servers ship
    each re-homed key's state to its new owner and answer stale-map
    requests with ``Op.WRONG_OWNER`` carrying the epoch.  Ownership is
    the consistent-hash ring (minimal movement) **overlaid with an
    optional per-key override table** — the autotuner's weighted ring
    override (docs/autotune.md "hot_key_rebalance"): the scheduler
    ships ``ring_overrides`` beside the map epoch, and an overridden
    key is owned by its override rank instead of its ring arc.  The
    epoch covers ring AND overrides as one versioned placement, so a
    rebalance (or its rollback) rides the exact same adopt → migrate →
    redirect plane a server-set change does.  The legacy modulo hash
    fns remain the non-elastic default routing.
    """

    __slots__ = ("epoch", "ring", "overrides")

    def __init__(self, ranks: Sequence[int], epoch: int = 0,
                 vnodes: int = 64,
                 overrides: Optional[Dict[int, int]] = None) -> None:
        self.epoch = int(epoch)
        self.ring = HashRing(ranks, vnodes=vnodes)
        rankset = set(self.ring.ranks)
        # overrides naming a rank outside this map's list are dropped —
        # a book can never route a key at a server it doesn't carry
        self.overrides: Dict[int, int] = {
            int(k): int(r) for k, r in (overrides or {}).items()
            if int(r) in rankset
        }

    @property
    def ranks(self) -> Tuple[int, ...]:
        return self.ring.ranks

    def owner(self, key: int) -> int:
        ov = self.overrides.get(int(key))
        return ov if ov is not None else self.ring.owner(key)


#: rings for fn="ring" routing, keyed by (num_servers, vnodes) — ring
#: construction is O(n·vnodes·log); routing must stay O(log)
_RING_CACHE: Dict[Tuple[int, int], HashRing] = {}
_RING_CACHE_LOCK = threading.Lock()


def _ring_for(num_servers: int, vnodes: int = 64) -> HashRing:
    key = (num_servers, vnodes)
    with _RING_CACHE_LOCK:
        ring = _RING_CACHE.get(key)
        if ring is None:
            ring = _RING_CACHE[key] = HashRing(range(num_servers), vnodes)
        return ring


def assign_server(
    key: int,
    num_servers: int,
    fn: str = "djb2",
    coef: int = 1,
    mixed_mode: bool = False,
    mixed_bound: int = 101,
    num_workers: int = 1,
    ring_vnodes: int = 64,
) -> int:
    """The server rank that owns a partition key.  ``fn="ring"`` is the
    consistent-hash ring over ranks ``0..num_servers-1``: the resharding
    plane's ownership at epoch 0."""
    if num_servers <= 0:
        raise ValueError("num_servers must be positive")
    if mixed_mode or fn == "mixed":
        return hash_mixed_mode(key, num_servers, num_workers, mixed_bound)
    if fn == "ring":
        return _ring_for(num_servers, ring_vnodes).owner(key)
    if fn not in _HASH_FNS:
        raise ValueError(
            f"unsupported BYTEPS_KEY_HASH_FN {fn!r}; "
            "must be one of [naive, built_in, djb2, sdbm, mixed, ring]"
        )
    return _HASH_FNS[fn](key, coef) % num_servers
