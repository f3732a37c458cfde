"""The round journal: the worker's bounded record of the pushes it sent,
as ``byteps_tpu.comm.journal`` keeps it.

The engine records every push before it leaves (key, round version, the
Cantor-encoded cmd, the exact wire payload, and whether it left inside a
fused pack).  A worker that used up its RPC retries against a server that
is still alive asks that server which rounds it absorbed
(Op.RESYNC_QUERY) and replays exactly the journaled rounds above them,
so it rejoins in place: no re-init barrier, no peer takes part.

Bounded two ways, since gradients are large and a heal only needs the
recent past (the round gate lets one round of a key out at a time, so a
live server is at most one round a key behind):

- ``BYTEPS_JOURNAL_ROUNDS``: rounds kept per key;
- ``BYTEPS_JOURNAL_BYTES``: payload bytes over all keys; the oldest
  rounds anywhere are evicted first.

Entries replay only into the round numbering they were recorded under:
the engine clears a key whenever its init barrier runs again.  The
payload is copied on record (the engine hands views whose buffers die
with the task); that copy is the journal's whole cost on the hot path.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class JournalEntry:
    """One journaled push: the bytes the engine sent for (key, version)."""

    version: int
    cmd: int
    payload: bytes
    #: sent inside an Op.FUSED pack (the replay is a plain per-key push,
    #: which the server sums the same way)
    fused: bool = False


class RoundJournal:
    """Thread-safe per-key push journal, bounded in rounds and bytes."""

    def __init__(self, max_rounds: int, max_bytes: int) -> None:
        self.max_rounds = max(1, int(max_rounds))
        self.max_bytes = max(1, int(max_bytes))
        self._lock = threading.Lock()
        #: key -> {version: entry}, in record order
        self._entries: Dict[int, "OrderedDict[int, JournalEntry]"] = {}
        #: (key, version) in record order over all keys: the byte cap
        #: evicts the oldest round anywhere
        self._fifo: "OrderedDict[tuple, None]" = OrderedDict()
        self._bytes = 0
        #: rounds dropped by either bound
        self.evicted = 0

    def record(self, key: int, version: int, cmd: int, payload,
               fused: bool = False) -> None:
        """Record one push's payload, replacing an entry of the same round
        (an unfused fallback sends a pack's round again)."""
        entry = JournalEntry(int(version), int(cmd), bytes(payload), fused)
        with self._lock:
            per = self._entries.get(key)
            if per is None:
                per = self._entries[key] = OrderedDict()
            old = per.pop(entry.version, None)
            if old is not None:
                self._bytes -= len(old.payload)
                self._fifo.pop((key, entry.version), None)
            per[entry.version] = entry
            self._fifo[(key, entry.version)] = None
            self._bytes += len(entry.payload)
            while len(per) > self.max_rounds:
                self._evict_locked(key, next(iter(per)))
            while self._bytes > self.max_bytes and self._fifo:
                ek, ev = next(iter(self._fifo))
                self._evict_locked(ek, ev)

    def _evict_locked(self, key: int, version: int) -> None:
        per = self._entries.get(key)
        if per is None:
            return
        dropped = per.pop(version, None)
        if dropped is not None:
            self._bytes -= len(dropped.payload)
            self.evicted += 1
        self._fifo.pop((key, version), None)
        if not per:
            del self._entries[key]

    def entries_after(self, key: int, version: int) -> List[JournalEntry]:
        """The key's journaled rounds newer than ``version`` (the server's
        absorbed watermark), oldest first: what a heal sends again."""
        with self._lock:
            per = self._entries.get(key)
            if per is None:
                return []
            return sorted((e for e in per.values() if e.version > version),
                          key=lambda e: e.version)

    def keys(self) -> List[int]:
        with self._lock:
            return list(self._entries)

    def clear_key(self, key: int) -> None:
        """Drop a key's entries: its init barrier runs again and its round
        numbering restarts."""
        with self._lock:
            per = self._entries.pop(key, None)
            if not per:
                return
            for version, e in per.items():
                self._bytes -= len(e.payload)
                self._fifo.pop((key, version), None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._fifo.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {"keys": len(self._entries), "rounds": len(self._fifo),
                    "bytes": self._bytes, "evicted": self.evicted}


#: the process's journal: the engine configures it at start, the PS
#: client's heal reads it; None when ``BYTEPS_JOURNAL_ROUNDS=0`` (a heal
#: then succeeds only where the server already absorbed every push)
_journal: Optional[RoundJournal] = None
_journal_lock = threading.Lock()


def configure_journal(max_rounds: int, max_bytes: int) -> Optional[RoundJournal]:
    """(Re)build the process's journal; an engine restart starts a new one,
    so no entry of an earlier generation survives."""
    global _journal
    with _journal_lock:
        _journal = RoundJournal(max_rounds, max_bytes) if max_rounds > 0 else None
        return _journal


def get_journal() -> Optional[RoundJournal]:
    with _journal_lock:
        return _journal
