"""Key -> server assignment (EncodeDefaultKey, global.cc:566-677): the
``naive``, ``built_in``, ``djb2`` and ``sdbm`` hash functions and mixed
mode, with the same arithmetic as ``byteps_tpu.common.hashing``, so a
worker of either package sends each key to the same server.  The string
hashes hash the key's decimal string (global.cc:606-627).  The
consistent-hash ring belongs to elastic resharding, which is not ported."""

from __future__ import annotations

from typing import Callable, Dict

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


def assign_server(
    key: int,
    num_servers: int,
    fn: str = "djb2",
    coef: int = 1,
    mixed_mode: bool = False,
    mixed_bound: int = 101,
    num_workers: int = 1,
) -> int:
    """The server rank that owns a partition key."""
    if num_servers <= 0:
        raise ValueError("num_servers must be positive")
    if mixed_mode or fn == "mixed":
        return hash_mixed_mode(key, num_servers, num_workers, mixed_bound)
    if fn == "ring":
        from byteps_tpu_torch.common.config import unported

        raise unported("reshard", "BYTEPS_KEY_HASH_FN=ring")
    if fn not in _HASH_FNS:
        raise ValueError(
            f"unsupported BYTEPS_KEY_HASH_FN {fn!r}; "
            "must be one of [naive, built_in, djb2, sdbm, mixed]"
        )
    return _HASH_FNS[fn](key, coef) % num_servers
