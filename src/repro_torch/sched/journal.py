"""Write-ahead event journal for durable crash recovery.

A verbatim copy of ``repro.sched.journal`` (pure Python, standard library
only): the port imports nothing of the JAX package.

The journal is the service's source of truth across process deaths: an
append-only JSONL stream of records — one ``session`` config record, a
``submit`` record per task submission, every runtime ``ProgressEvent``
(the events.py vocabulary, which includes ``REPLAN`` plan adoptions),
a ``ckpt`` record per durable mid-task snapshot, and a ``serve`` record
per tune-to-serve winner artifact. Each append is flushed + fsynced
before returning, so anything the journal acknowledged survives a
``kill -9``.

Segment rotation is atomic: once ``rotate_every`` records accumulate in
``current.jsonl`` the file is sealed via ``os.replace`` into
``segment-%06d.jsonl`` (then the directory is fsynced) and a fresh
``current.jsonl`` starts. Replay reads sealed segments in order followed
by ``current.jsonl``; a torn final line of the final file (a crash
mid-append) is tolerated silently, while an unparseable line anywhere
else flags that file as corrupt — recovery then degrades to
requeue-from-zero for anything whose state the corrupt span may hide,
rather than crash.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional


class EventJournal:
    """Append-only fsynced JSONL journal under ``state_dir/journal/``."""

    def __init__(self, state_dir: str, rotate_every: int = 1024,
                 fsync: bool = True):
        assert rotate_every >= 1
        self.dir = os.path.join(state_dir, "journal")
        os.makedirs(self.dir, exist_ok=True)
        self.rotate_every = rotate_every
        self.fsync = fsync
        self._cur = os.path.join(self.dir, "current.jsonl")
        self._n = 0
        if os.path.exists(self._cur):       # reopen: continue appending
            with open(self._cur) as f:
                self._n = sum(1 for line in f if line.strip())
        self._f = open(self._cur, "a")

    def append(self, record: Dict) -> None:
        self._f.write(json.dumps(record, separators=(",", ":")) + "\n")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._n += 1
        if self._n >= self.rotate_every:
            self._rotate()

    def _segments(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.dir, "segment-*.jsonl")))

    def _rotate(self) -> None:
        self._f.close()
        segs = self._segments()
        idx = 1 + (int(os.path.basename(segs[-1])[8:-6]) if segs else 0)
        os.replace(self._cur,
                   os.path.join(self.dir, f"segment-{idx:06d}.jsonl"))
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._f = open(self._cur, "a")
        self._n = 0

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._f.close()


# terminal event kinds, by journal string value (avoid importing the enum
# at replay time for records written by any schema revision)
_TERMINAL = frozenset({"task_completed", "task_cancelled"})


@dataclasses.dataclass
class JournalReplay:
    """Parsed journal content plus corruption flags."""
    records: List[Dict]
    corrupt: List[str]          # files with an unparseable non-tail line
    torn_tail: bool             # final line of the final file was torn

    def session(self) -> Optional[Dict]:
        last = None
        for r in self.records:
            if r.get("rec") == "session":
                last = r
        return last

    def submits(self) -> List[Dict]:
        """Submit records, deduped by task name (last submit wins — a
        requeued task re-journals its submission), in first-seen order."""
        by_name: Dict[str, Dict] = {}
        for r in self.records:
            if r.get("rec") == "submit":
                by_name[r["name"]] = r
        return list(by_name.values())

    def terminal_tasks(self) -> frozenset:
        done = set()
        for r in self.records:
            if r.get("rec") == "event" and \
                    r["event"].get("kind") in _TERMINAL:
                done.add(r["event"]["task"])
        return frozenset(done)

    def checkpoints(self) -> Dict[str, Dict]:
        """Latest ``ckpt`` record per task."""
        out: Dict[str, Dict] = {}
        for r in self.records:
            if r.get("rec") == "ckpt":
                out[r["task"]] = r
        return out

    def serves(self) -> Dict[str, str]:
        """Task -> winner artifact path (tune-to-serve records)."""
        return {r["task"]: r["path"] for r in self.records
                if r.get("rec") == "serve"}


def replay_journal(state_dir: str) -> JournalReplay:
    """Parse every sealed segment plus ``current.jsonl``, in order."""
    jdir = os.path.join(state_dir, "journal")
    files = sorted(glob.glob(os.path.join(jdir, "segment-*.jsonl")))
    cur = os.path.join(jdir, "current.jsonl")
    if os.path.exists(cur):
        files.append(cur)
    records: List[Dict] = []
    corrupt: List[str] = []
    torn_tail = False
    for fi, path in enumerate(files):
        with open(path) as f:
            lines = f.read().splitlines()
        for li, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                if fi == len(files) - 1 and li == len(lines) - 1:
                    torn_tail = True        # crash mid-append: expected
                else:
                    corrupt.append(path)
                break                       # stop parsing this file
    return JournalReplay(records=records, corrupt=corrupt,
                         torn_tail=torn_tail)
