"""Append-only JSONL batch journal: checkpoint/resume for the streaming run
(the port's own copy of the reference's ``repro.launch.journal``).

A million-event campaign that dies at batch 9_999 must not recompute batches
0..9_998. ``stream_simulate`` records every completed batch here; a
``--resume`` run replays the journal, skips completed batches, and computes
only the remainder — bit-identically, because per-event ADCs derive only
from ``fold_in(key, event_id)`` and the fixed padded depo shape, neither of
which depends on which run computes the batch (proven SHA-for-SHA in
``tests/test_torch_stream.py``).

File format (one JSON object per line):

  line 1   : header — {"kind": "header", "version": 1, "fingerprint": ...,
             "num_events": ..., "batch_events": ..., "pad_to": ...}
  line 2.. : batch records — {"kind": "batch", "batch": b, "ids": [...],
             "events": n, "depos": n, "adc_sha": "...", "quarantined": n}

Durability contract: records append with flush + fsync, so a completed batch
survives a crash of the very next statement. A torn final line (the process
died mid-write) is tolerated on read — parsing stops at the first
undecodable line and everything before it counts as completed; the torn
batch simply recomputes. The header writes atomically (tmp + ``os.replace``)
so a half-created journal can never be mistaken for a resumable one.

The fingerprint pins the run parameters a resume must reproduce (config,
seed, batching, padding): resuming under a different config would silently
mix incompatible ADC streams, so it is an error instead.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional

JOURNAL_VERSION = 1


class JournalError(ValueError):
    """The journal cannot serve this run (missing, unreadable header, or a
    fingerprint mismatch — the run parameters differ from the recorded
    ones)."""


def run_fingerprint(cfg, **params: Any) -> str:
    """Digest of everything a resumed run must reproduce exactly: the full
    config repr (strategy fields included — they change the traced program)
    plus the streaming parameters (seed, batch_events, pad_to, ...)."""
    payload = repr(sorted(params.items())) + "|" + repr(cfg)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


class RunJournal:
    """One streaming run's append-only batch journal.

    ``resume=True`` loads an existing journal (validating version and
    fingerprint) and exposes its completed batches; otherwise a fresh
    journal is created, atomically replacing any stale file at ``path``.
    """

    def __init__(self, path: str, fingerprint: str, resume: bool = False):
        self.path = path
        self.fingerprint = fingerprint
        #: batch id -> recorded batch dict (completed in a previous run)
        self.completed: Dict[int, dict] = {}
        if resume:
            self._load_existing()
            self._f = open(self.path, "a")
        else:
            self._create(fingerprint)

    # -- creation / loading -------------------------------------------------

    def _create(self, fingerprint: str) -> None:
        header = {"kind": "header", "version": JOURNAL_VERSION,
                  "fingerprint": fingerprint}
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(header, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._f = open(self.path, "a")

    def _load_existing(self) -> None:
        try:
            with open(self.path) as f:
                lines = f.read().splitlines()
        except OSError as e:
            raise JournalError(
                f"cannot resume: journal {self.path!r} is unreadable "
                f"({e})") from e
        if not lines:
            raise JournalError(f"cannot resume: journal {self.path!r} is "
                               "empty (no header)")
        try:
            header = json.loads(lines[0])
        except json.JSONDecodeError as e:
            raise JournalError(f"cannot resume: journal {self.path!r} has "
                               "an unreadable header line") from e
        if not isinstance(header, dict) or header.get("kind") != "header":
            raise JournalError(f"cannot resume: {self.path!r} does not look "
                               "like a run journal (bad header)")
        if header.get("version") != JOURNAL_VERSION:
            raise JournalError(
                f"cannot resume: journal version {header.get('version')!r} "
                f"!= supported {JOURNAL_VERSION}")
        if header.get("fingerprint") != self.fingerprint:
            raise JournalError(
                "cannot resume: journal was written by a run with different "
                "parameters (config/seed/batching changed — fingerprint "
                f"{header.get('fingerprint')!r} != {self.fingerprint!r}); "
                "resuming would mix incompatible ADC streams")
        for line in lines[1:]:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break  # torn final write: everything before it is durable
            if isinstance(rec, dict) and rec.get("kind") == "batch":
                self.completed[int(rec["batch"])] = rec

    # -- appending ----------------------------------------------------------

    def append_batch(self, record: Dict[str, Any]) -> None:
        """Durably record one completed batch (single line, flush + fsync)."""
        rec = dict(record, kind="batch")
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        self.completed[int(rec["batch"])] = rec

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_journal_records(path: str) -> Optional[List[dict]]:
    """Read-only view of a journal's completed batch records, sorted by
    batch id (None when the file is missing/unreadable) — for post-run
    inspection and tests. Tolerates a torn final line like resume does."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    records: Dict[int, dict] = {}
    for line in lines[1:]:
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            break
        if isinstance(rec, dict) and rec.get("kind") == "batch":
            records[int(rec["batch"])] = rec
    return [records[b] for b in sorted(records)]
