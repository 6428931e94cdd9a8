"""Structured JSONL event log — one writer per process, rotation, stable
schema. A copy of ``mxnet_tpu/observability/events.py``; the host index is
the ``torch.distributed`` rank where a process group is up (0 otherwise).

Every record is one JSON object per line with a fixed envelope::

    {"ts": <unix seconds>, "run": "<run id>", "host": <process index>,
     "step": <monotonic step>, "event": "<name>", ...payload...}

``run`` is shared by every host of one training run (derived from time+pid
on host 0 semantics are fine for single-controller runs; multi-host runs
pass an explicit run id). ``step`` is whatever the step loop last declared
via :func:`set_step` unless the emitter overrides it, so asynchronous
emitters (the dispatch watchdog's timer thread) land on the step they
belong to and can be correlated with the profiler rows annotated by
``obs.span``.

Rotation: when the active file exceeds ``rotate_bytes`` the writer
gzip-compresses it into ``<path>.<seq>.gz`` (monotonically increasing
``seq`` — lowest is oldest) and reopens fresh. Total retained rotated
bytes are capped by the ``events_keep_bytes`` knob
(``MXNET_TPU_EVENTS_KEEP_BYTES``): the oldest segments are deleted until
the cap fits, and with the default ``0`` exactly one rotated segment is
kept — the pre-cap disk bound. :func:`read_events` reads rotated
segments (gzipped or the legacy plain ``.1``) plus the live file in
order, transparently.
"""
from __future__ import annotations

import gzip
import json
import os
import re
import threading
import time
from typing import Iterator, List, Optional

__all__ = ["EventLog", "LOG", "emit", "set_step", "configure", "close",
           "read_events", "current_step", "rotated_segments",
           "latest_rotated"]


def _segment_seq(base: str, path: str) -> Optional[int]:
    m = re.fullmatch(re.escape(os.path.basename(base))
                     + r"\.(\d+)(?:\.gz)?", os.path.basename(path))
    return int(m.group(1)) if m else None


def rotated_segments(path: str) -> List[str]:
    """Rotated predecessors of the live file at ``path``, oldest first
    (``<path>.N[.gz]`` ordered by N; the legacy single ``.1`` sorts the
    same way). When a segment briefly exists both plain and compressed
    (the background compressor replaced the ``.gz`` but has not removed
    the plain file yet) the ``.gz`` wins — it is complete by then."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    by_seq: dict = {}
    try:
        names = os.listdir(d)
    except OSError:
        return []
    for name in names:
        seq = _segment_seq(base, name)
        if seq is None:
            continue
        cur = by_seq.get(seq)
        if cur is None or name.endswith(".gz"):
            by_seq[seq] = name
    return [os.path.join(d, name)
            for _seq, name in sorted(by_seq.items())]


def latest_rotated(path: str) -> Optional[str]:
    segs = rotated_segments(path)
    return segs[-1] if segs else None


def segment_seq(path: str, segment: str) -> int:
    """Rotation index of one of ``path``'s rotated segments (0 when
    ``segment`` is not one)."""
    return _segment_seq(path, segment) or 0


def _open_text(path: str):
    """Text handle over a (possibly gzipped) JSONL segment."""
    if path.endswith(".gz"):
        return gzip.open(path, "rt", errors="replace")
    return open(path, "r", errors="replace")


_host_index_cache = None


def _host_index() -> int:
    # cached once a process group is up: emit() stamps every record with
    # the host index (a process's rank never changes once the group is up;
    # before that it is 0 either way)
    global _host_index_cache
    if _host_index_cache is None:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return 0
        _host_index_cache = int(dist.get_rank())
    return _host_index_cache


class EventLog:
    def __init__(self):
        self._fh = None
        self._path: Optional[str] = None
        self._run_id: Optional[str] = None
        self._rotate_bytes = 64 * 1024 * 1024
        self._keep_bytes = 0  # 0 = keep exactly one rotated segment
        self._size = 0
        self._seq = 1  # next rotation index (resumed from disk on configure)
        self._step = 0
        self._lock = threading.Lock()
        # in-flight background compress/sweep workers (joined on close so
        # a clean shutdown leaves only .gz segments behind)
        self._rot_threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------
    def configure(self, path: str, run_id: Optional[str] = None,
                  rotate_bytes: Optional[int] = None,
                  keep_bytes: Optional[int] = None) -> "EventLog":
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._path = path
            self._fh = open(path, "a", buffering=1)  # line-buffered
            # size tracked in-process: a tell() per emit is a syscall the
            # per-event budget can't afford
            self._size = self._fh.tell()
            self._run_id = run_id or f"{int(time.time())}-{os.getpid()}"
            if rotate_bytes is not None:
                self._rotate_bytes = int(rotate_bytes)
            if keep_bytes is not None:
                self._keep_bytes = int(keep_bytes)
            # resume the rotation sequence past whatever a previous
            # process (same path) already wrote
            segs = rotated_segments(path)
            last = _segment_seq(path, segs[-1]) if segs else 0
            self._seq = (last or 0) + 1
        return self

    @property
    def configured(self) -> bool:
        return self._fh is not None

    @property
    def path(self) -> Optional[str]:
        return self._path

    @property
    def run_id(self) -> Optional[str]:
        return self._run_id

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            threads, self._rot_threads = self._rot_threads, []
        for t in threads:  # outside the lock: workers never take it
            t.join(timeout=30.0)

    # -- write path ----------------------------------------------------------
    def set_step(self, step: int) -> None:
        self._step = int(step)

    def current_step(self) -> int:
        return self._step

    def emit(self, event: str, **fields) -> bool:
        """Write one record; returns False (and is a near-no-op) when the
        log was never configured — call sites don't need their own guard."""
        if self._fh is None:
            return False
        step = fields.pop("step", None)
        rec = {"ts": round(time.time(), 6), "run": self._run_id,
               "host": _host_index(),
               "step": self._step if step is None else int(step),
               "event": event}
        rec.update(fields)
        line = json.dumps(rec, default=_json_fallback)
        with self._lock:
            if self._fh is None:
                return False
            try:
                self._fh.write(line + "\n")
                self._size += len(line) + 1
                self._maybe_rotate()
            except (OSError, ValueError):
                # telemetry must NEVER fail the train loop: on a dead disk/
                # deleted dir, drop the log and keep training (metrics — in
                # memory — survive)
                try:
                    self._fh.close()
                except Exception:
                    pass
                self._fh = None
                import logging

                logging.getLogger("mxnet_tpu_torch.observability").warning(
                    "event log %s unwritable; disabling event emission",
                    self._path)
                return False
        return True

    def _maybe_rotate(self) -> None:
        if self._size < self._rotate_bytes:
            return
        try:
            self._fh.close()
            rot = f"{self._path}.{self._seq}"
            os.replace(self._path, rot)  # O(1) — this is all emit() pays
            self._seq += 1
            # gzip + retention sweep run OFF the emit lock on a daemon
            # thread: compressing a 64 MB segment inline would stall the
            # training step that happened to cross the threshold (and
            # every other emitting thread behind the lock). The plain
            # numbered segment stays readable until the .gz replaces it.
            t = threading.Thread(target=self._compress_and_sweep,
                                 args=(rot,), daemon=True,
                                 name="events-rotate")
            self._rot_threads.append(t)
            t.start()
        finally:
            # reopen even if the rotation failed (truncation beats a
            # closed handle); a reopen failure propagates to emit()'s
            # guard above
            self._fh = open(self._path, "a", buffering=1)
            self._size = self._fh.tell()

    def _compress_and_sweep(self, rot: str) -> None:
        try:
            with open(rot, "rb") as src, \
                    gzip.open(rot + ".gz.tmp", "wb") as dst:
                while True:
                    chunk = src.read(1 << 20)
                    if not chunk:
                        break
                    dst.write(chunk)
            os.replace(rot + ".gz.tmp", rot + ".gz")
            os.remove(rot)
        except OSError:
            pass  # the plain segment stays readable; retry never needed
        try:
            self._sweep_retention()
        except OSError:
            pass

    def _sweep_retention(self) -> None:
        """Delete oldest rotated segments until the retained total fits
        ``keep_bytes`` (0 = keep exactly one segment, the historical
        bound). The newest segment always survives — the fleet
        snapshotter recovers post-rotation bytes from it."""
        segs = rotated_segments(self._path)
        if not segs:
            return
        if self._keep_bytes <= 0:
            doomed = segs[:-1]
        else:
            sizes = {}
            for p in segs:
                try:
                    sizes[p] = os.path.getsize(p)
                except OSError:
                    sizes[p] = 0
            total = sum(sizes.values())
            doomed = []
            for p in segs[:-1]:
                if total <= self._keep_bytes:
                    break
                doomed.append(p)
                total -= sizes[p]
        for p in doomed:
            try:
                os.remove(p)
            except OSError:
                pass


def _json_fallback(o):
    try:
        return float(o)  # numpy scalars, 0-d tensors
    except Exception:
        return str(o)


def read_events(path: str) -> List[dict]:
    """Read every record from ``path`` (its rotated predecessors first,
    oldest to newest — gzipped ``.N.gz`` segments and the legacy plain
    ``.1`` both read transparently). ``path`` may also be a directory, in
    which case every ``events*.jsonl[.gz]`` file under it is read
    (multi-host runs write one file per host), or a single ``.gz``
    segment."""
    if os.path.isdir(path):
        files: List[str] = []
        names = sorted(os.listdir(path))
        # rotated segments first (oldest records), ordered per base file
        # by NUMERIC seq — lexically, .10.gz would sort before .2.gz
        rotated = []
        for name in names:
            seq = _segment_seq(name.split(".jsonl")[0] + ".jsonl", name)
            if name.startswith("events") and seq is not None:
                rotated.append((name.split(".jsonl")[0], seq, name))
        files.extend(os.path.join(path, name)
                     for _base, _seq, name in sorted(rotated))
        for name in names:
            if name.startswith("events") and (name.endswith(".jsonl")
                                              or name.endswith(".jsonl.gz")):
                files.append(os.path.join(path, name))
    elif path.endswith(".gz"):
        files = [path]
    else:
        files = rotated_segments(path) + [path]
    out: List[dict] = []
    for p in files:
        try:
            with _open_text(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue  # torn final line after a crash
        except (OSError, EOFError):
            continue  # vanished file / torn gzip trailer after a crash
    return out


def iter_events(path: str) -> Iterator[dict]:
    yield from read_events(path)


#: the process-wide default event log
LOG = EventLog()

emit = LOG.emit
set_step = LOG.set_step
current_step = LOG.current_step
configure = LOG.configure
close = LOG.close
