"""Measured profiling over ``torch.profiler``: trace capture, timelines,
measured reports. The port's counterpart of
``mxnet_tpu/observability/profiling.py``.

The data model is the JAX module's, copied: a :class:`Timeline` of
planes, lines and events; a :class:`MeasuredReport` of device op rows and
annotation spans (hot ops, per-device totals, step rows, span breakdown,
overlap, class seconds, ``summary``). Two readers fill it:

  - :func:`parse_xplane_bytes` — the JAX module's pure-stdlib protobuf
    wire reader (with :func:`encode_xplane`, its fixture writer), so a
    capture the JAX package took reads here;
  - :func:`parse_chrome_trace` — the Chrome-trace JSON that
    ``torch.profiler`` exports. Kernels land on one ``/device:GPU:{n}``
    plane per card, a line per stream; host rows on ``/host:CPU``. A CPU
    capture has no device plane: its ``aten::`` ops land on
    ``/device:CPU:0``, the CPU being the device it measured.

:func:`parse_trace` reads the newest session under a trace directory, in
either format. The capture side:

  - :func:`capture` — ``capture(fn, steps=K)`` runs ``K`` warmed-up calls
    under one ``torch.profiler`` session, each inside a ``prof_step``
    ``record_function`` and synchronised, exports the Chrome trace into a
    new session directory and parses it. A capture that asked for the card
    and whose timeline holds no device rows raises: it never returns a
    host-only report of a device program;
  - :class:`CaptureController` — live-loop wiring: periodic capture every
    ``MXNET_TPU_PROF_EVERY_N_STEPS`` steps, trigger-file capture (the fleet
    aggregator, or a serving replica's slow-request hook, drops a
    ``prof-request-h{rank}.json`` into the fleet dir; the rank's next
    step is traced and snapshotted into ``telemetry-h{rank}/prof-*``), and
    retention of capture dirs by ``MXNET_TPU_PROF_KEEP_BYTES``. A step
    that captures a CUDA graph is never traced: the probe defers to the
    next replay.

One trace session per process, as in the JAX module: :func:`capture`, the
controller and ``mx.profiler`` coordinate through :func:`trace_active`, and
a :class:`~mxnet_tpu_torch.ops.cuda_graph.StepGraph` whose capture falls
inside a session runs its step eagerly instead, capturing at its first call
after the session.

``calibrate`` (predicted against measured class seconds) needs the
schedule auditor of ``analysis/*``, which the port does not have yet: it
raises ``NotImplementedError``. ``GenerationEngine.profile`` and
``TrainStep.profile`` are the entry points; ``tools/torch_profreport.py``
renders a capture.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..ops import cuda_graph as _cg
from . import events as _events
from . import metrics as _metrics

__all__ = ["TraceEvent", "TraceLine", "TracePlane", "Timeline",
           "parse_xplane_bytes", "parse_chrome_trace", "parse_trace",
           "encode_xplane", "OpRow", "SpanRow", "MeasuredReport",
           "measured_report", "Capture", "capture", "op_class", "calibrate",
           "CaptureController", "step_capture_begin", "step_capture_end",
           "step_capture_abort", "write_snapshot", "latest_profile",
           "request_path", "trace_active", "PROF_STEP_SPAN"]

logger = logging.getLogger("mxnet_tpu_torch.observability.profiling")

#: the annotation :func:`capture` wraps each traced call in — the measured
#: step windows of the timeline
PROF_STEP_SPAN = "prof_step"

#: seconds between trigger-file probes of the step-boundary controller
TRIGGER_PROBE_SECONDS = 0.5


def _default_dir() -> str:
    from .. import config as _config

    return _config.get("profiler_dir") or os.path.join(
        tempfile.gettempdir(), "mxnet_tpu_profile")


# -- XPlane wire-format reader ------------------------------------------------
# XSpace proto schema (tsl/profiler/protobuf/xplane.proto), stable since
# 2020: XSpace{planes=1} XPlane{id=1,name=2,lines=3,event_metadata=4,
# stat_metadata=5,stats=6} XLine{id=1,name=2,timestamp_ns=3,events=4,
# duration_ps=9,display_name=11} XEvent{metadata_id=1,offset_ps=2,
# duration_ps=3,stats=4} XStat{metadata_id=1,double=2,uint64=3,int64=4,
# str=5,bytes=6,ref=7} X{Event,Stat}Metadata{id=1,name=2}.
def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    r = 0
    s = 0
    while True:
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << s
        if not b & 0x80:
            return r, i
        s += 7


def _fields(buf: bytes):
    """Yield ``(field_number, wire_type, value)`` triples of one message.
    Raises IndexError/ValueError on torn bytes — callers treat that as a
    corrupt proto, never fatal."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        if i > n:
            raise ValueError("truncated message")
        yield fnum, wt, v


@dataclasses.dataclass
class TraceEvent:
    """One timeline row: resolved name, absolute start, duration, stats."""

    name: str
    start_ns: float
    dur_ns: float
    stats: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def end_ns(self) -> float:
        return self.start_ns + self.dur_ns


@dataclasses.dataclass
class TraceLine:
    name: str
    timestamp_ns: int
    events: List[TraceEvent] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TracePlane:
    name: str
    lines: List[TraceLine] = dataclasses.field(default_factory=list)

    @property
    def is_device(self) -> bool:
        return self.name.startswith("/device:")


@dataclasses.dataclass
class Timeline:
    """Normalized plane → line → event tree of one trace (every trace
    file of the newest session dir merged)."""

    planes: List[TracePlane] = dataclasses.field(default_factory=list)
    source: str = ""
    parse_errors: int = 0  # torn/unreadable proto files skipped

    @property
    def n_events(self) -> int:
        return sum(len(ln.events) for p in self.planes for ln in p.lines)


def _parse_stat(buf: bytes, stat_md: Dict[int, str]) -> Tuple[Optional[str], object]:
    import struct

    sid: Optional[int] = None
    val: object = None
    for f, wt, v in _fields(buf):
        if f == 1:
            sid = v
        elif f == 2 and wt == 1:  # double_value
            val = struct.unpack("<d", v)[0]
        elif f in (3, 4) and wt == 0:  # uint64 / int64
            val = v
        elif f == 5:  # str_value
            val = v.decode("utf-8", "replace")
        elif f == 6:  # bytes_value
            val = v
        elif f == 7 and wt == 0:  # ref_value -> stat_metadata name
            val = stat_md.get(v, v)
    return (stat_md.get(sid) if sid is not None else None), val


def _parse_plane(buf: bytes) -> TracePlane:
    name = ""
    line_bufs: List[bytes] = []
    event_md: Dict[int, str] = {}
    stat_md: Dict[int, str] = {}
    for f, _wt, v in _fields(buf):
        if f == 2:
            name = v.decode("utf-8", "replace")
        elif f == 3:
            line_bufs.append(v)
        elif f in (4, 5):  # map<int64, X{Event,Stat}Metadata>
            k = md = None
            for f2, _w2, v2 in _fields(v):
                if f2 == 1:
                    k = v2
                elif f2 == 2:
                    md = v2
            if md is None:
                continue
            md_name = ""
            for f3, _w3, v3 in _fields(md):
                if f3 == 2:
                    md_name = v3.decode("utf-8", "replace")
            (event_md if f == 4 else stat_md)[k] = md_name
    plane = TracePlane(name=name)
    for lb in line_bufs:
        lname = ""
        ts_ns = 0
        ev_bufs: List[bytes] = []
        for f, _wt, v in _fields(lb):
            if f == 2:
                lname = v.decode("utf-8", "replace")
            elif f == 11 and not lname:
                lname = v.decode("utf-8", "replace")
            elif f == 3:
                ts_ns = v
            elif f == 4:
                ev_bufs.append(v)
        line = TraceLine(name=lname, timestamp_ns=ts_ns)
        for eb in ev_bufs:
            mdid = off_ps = dur_ps = 0
            stats: Dict[str, object] = {}
            for f, _wt, v in _fields(eb):
                if f == 1:
                    mdid = v
                elif f == 2:
                    off_ps = v
                elif f == 3:
                    dur_ps = v
                elif f == 4:
                    sk, sv = _parse_stat(v, stat_md)
                    if sk is not None:
                        stats[sk] = sv
            line.events.append(TraceEvent(
                name=event_md.get(mdid, str(mdid)),
                start_ns=ts_ns + off_ps / 1e3,
                dur_ns=dur_ps / 1e3, stats=stats))
        plane.lines.append(line)
    return plane


def parse_xplane_bytes(data: bytes, source: str = "<bytes>") -> Timeline:
    """Decode one serialized XSpace proto (a JAX capture's
    ``*.xplane.pb``) into a :class:`Timeline`, in pure stdlib. Raises
    ValueError on bytes that are not a well-formed proto."""
    try:
        planes = [_parse_plane(v) for f, _wt, v in _fields(data) if f == 1]
    except (IndexError, ValueError) as e:
        raise ValueError(f"torn xplane proto ({source}): {e}") from None
    return Timeline(planes=planes, source=source)


# -- torch.profiler Chrome-trace reader --------------------------------------
#: Chrome-trace categories of rows that ran on the card
_DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
#: host rows kept on the host plane (launches carry the correlation ids)
_HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime",
                        "cuda_driver"})
#: the trace file a port capture writes into its session directory
TRACE_FILE = "trace.pt.trace.json"


def _device_windows(host_steps, launches, kernels) -> List[Optional[tuple]]:
    """The device side of each host ``prof_step`` annotation: ``(start,
    end, busy)`` in µs, or None for a step that launched nothing.

    A captured step replays its graph with one ``cudaGraphLaunch``, long
    before its kernels end, so the host annotation does not bracket the
    device work. The port finds the step's device rows by the launch
    correlation ids: every runtime or driver launch whose host timestamp
    falls inside the annotation names, by its ``correlation`` id, the
    device rows it started. (The profiler's ``gpu_user_annotation`` rows
    are not used: which PyTorch builds emit them for graph replays is not
    settled.) The window runs from the first of those rows to the end of
    the last, idle gaps included: it is the step's measured device time.
    ``busy`` is the union of the rows' intervals, the time the card spent
    on the step. Tracing widens the window: CUPTI records each node of a
    replayed graph, so a traced ``cudaGraphLaunch`` returns late and the
    card idles in the step until it does (on the H100, a 345M decode
    step's 755 rows: 1.5-2.5 ms a launch, the window's gap before the
    graph's first kernel)."""
    by_corr: Dict[int, List[tuple]] = {}
    for k in kernels:
        c = k.get("correlation")
        if c is not None:
            by_corr.setdefault(c, []).append((k["ts"], k["ts"] + k["dur"]))
    out = []
    for s in host_steps:
        lo, hi = s["ts"], s["ts"] + s["dur"]
        rows = [r for ln in launches if lo <= ln["ts"] <= hi
                for r in by_corr.get(ln.get("correlation"), ())]
        if not rows:
            out.append(None)
            continue
        busy = sum(e - b for b, e in _merged_intervals(rows))
        out.append((min(r[0] for r in rows), max(r[1] for r in rows), busy))
    return out


def parse_chrome_trace(data, source: str = "<json>") -> Timeline:
    """A ``torch.profiler`` Chrome trace (the parsed JSON object, or its
    text) as a :class:`Timeline` (times in ns). Device rows go to
    ``/device:GPU:{n}`` (a line per stream); host rows to ``/host:CPU`` (a
    line per thread), where ``prof_step`` annotations become
    ``prof_step.host`` rows carrying their ``step`` stat. On its card's
    ``Steps`` line each step (:func:`_device_windows`) becomes a
    ``prof_step`` event over its device window, from the step's first
    device row to the end of its last (the step's device time), and a
    ``prof_step.busy`` event, from the same start, that lasts the card's
    busy time on the step's rows (the window less its idle gaps). A
    trace with no device rows is a CPU
    capture: its ``aten::`` ops and its ``prof_step`` windows land on
    ``/device:CPU:0``. Every other annotation gets the ``step`` stat of the
    ``prof_step`` it falls in. Raises ValueError on text that is not a
    trace."""
    if isinstance(data, (str, bytes)):
        try:
            data = json.loads(data)
        except ValueError as e:
            raise ValueError(f"torn chrome trace ({source}): {e}") from None
    if isinstance(data, list):
        data = {"traceEvents": data}
    if not isinstance(data, dict) or not isinstance(
            data.get("traceEvents"), list):
        raise ValueError(f"not a chrome trace ({source})")
    base_ns = float(data.get("baseTimeNanoseconds") or 0.0)
    rows = []
    for e in data["traceEvents"]:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat not in _DEVICE_CATS and cat not in _HOST_CATS:
            continue
        args = e.get("args") if isinstance(e.get("args"), dict) else {}
        try:
            rows.append({"cat": cat, "name": str(e.get("name", "")),
                         "ts": float(e["ts"]), "dur": float(e.get("dur", 0)),
                         "tid": e.get("tid"), "args": args,
                         "correlation": args.get("correlation")})
        except (KeyError, TypeError, ValueError):
            continue
    rows.sort(key=lambda r: (r["ts"], -r["dur"]))
    kernels = [r for r in rows if r["cat"] in _DEVICE_CATS]
    steps = [r for r in rows
             if r["cat"] == "user_annotation" and r["name"] == PROF_STEP_SPAN]
    on_card = bool(kernels)
    host = TracePlane(name="/host:CPU")
    planes: Dict[str, TracePlane] = {}
    lines: Dict[Tuple[str, str], TraceLine] = {}

    def line_of(plane: TracePlane, name: str) -> TraceLine:
        ln = lines.get((plane.name, name))
        if ln is None:
            ln = lines[(plane.name, name)] = TraceLine(name=name,
                                                       timestamp_ns=0)
            plane.lines.append(ln)
        return ln

    def plane_of(name: str) -> TracePlane:
        p = planes.get(name)
        if p is None:
            p = planes[name] = TracePlane(name=name)
        return p

    def ns(us: float) -> float:
        return base_ns + us * 1e3

    def step_at(ts: float) -> Optional[int]:
        for i, s in enumerate(steps):
            if s["ts"] <= ts <= s["ts"] + s["dur"]:
                return i
        return None

    cpu = plane_of("/device:CPU:0") if not on_card else None
    for r in rows:
        ev = TraceEvent(name=r["name"], start_ns=ns(r["ts"]),
                        dur_ns=r["dur"] * 1e3)
        if r["cat"] in _DEVICE_CATS:
            dev = r["args"].get("device", 0)
            stream = r["args"].get("stream", r["tid"])
            line_of(plane_of(f"/device:GPU:{dev}"),
                    f"stream {stream}").events.append(ev)
        elif r["cat"] == "user_annotation":
            i = step_at(r["ts"])
            if r["name"] == PROF_STEP_SPAN:
                i = steps.index(r)
                if on_card:
                    ev.name = PROF_STEP_SPAN + ".host"
                    ev.stats["step"] = i
                    line_of(host, f"thread {r['tid']}").events.append(ev)
                else:
                    ev.stats["step"] = i
                    line_of(cpu, "Steps").events.append(ev)
                continue
            if i is not None:
                ev.stats["step"] = i
            line_of(host, f"thread {r['tid']}").events.append(ev)
        elif r["cat"] == "cpu_op" and not on_card:
            line_of(cpu, f"thread {r['tid']}").events.append(ev)
        else:
            if r["correlation"] is not None:
                ev.stats["correlation"] = r["correlation"]
            line_of(host, f"thread {r['tid']}").events.append(ev)
    if on_card:
        launches = [r for r in rows if r["cat"] in ("cuda_runtime",
                                                    "cuda_driver")]
        dev_of = {k["correlation"]: k["args"].get("device", 0)
                  for k in kernels if k["correlation"] is not None}
        for i, (s, win) in enumerate(zip(steps, _device_windows(
                steps, launches, kernels))):
            if win is None:
                continue
            corr = next((ln["correlation"] for ln in launches
                         if s["ts"] <= ln["ts"] <= s["ts"] + s["dur"]
                         and ln["correlation"] in dev_of), None)
            plane = plane_of(f"/device:GPU:{dev_of.get(corr, 0)}")
            steps_line = line_of(plane, "Steps")
            steps_line.events.append(TraceEvent(
                name=PROF_STEP_SPAN, start_ns=ns(win[0]),
                dur_ns=(win[1] - win[0]) * 1e3, stats={"step": i}))
            steps_line.events.append(TraceEvent(
                name=PROF_STEP_SPAN + ".busy", start_ns=ns(win[0]),
                dur_ns=win[2] * 1e3, stats={"step": i}))
    tl = Timeline(source=source)
    tl.planes = [planes[k] for k in sorted(planes)] + [host]
    return tl


def _profile_run_dir(trace_dir: str) -> Optional[str]:
    """Newest session subdir under ``trace_dir`` (both packages write one
    ``plugins/profile/<timestamp>/`` per session); ``trace_dir`` may also
    BE a run dir already."""
    runs = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                         "*")))
    if runs:
        return runs[-1]
    if (glob.glob(os.path.join(trace_dir, "*.xplane.pb"))
            or glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))):
        return trace_dir
    return None


def _session_dir(trace_dir: str) -> str:
    """A new session directory under ``trace_dir``, named by its start
    time so that the newest sorts last."""
    t = time.time()
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S", time.gmtime(t))
    d = os.path.join(trace_dir, "plugins", "profile",
                     f"{stamp}_{int(t * 1e6) % 1000000:06d}")
    os.makedirs(d, exist_ok=True)
    return d


def parse_trace(trace_dir: str) -> Timeline:
    """Parse every trace file (``*.pt.trace.json`` of a port capture,
    ``*.xplane.pb`` of a JAX one) of the newest session under
    ``trace_dir`` into one merged :class:`Timeline`. Torn or unreadable
    files are skipped and counted (``parse_errors``); an empty or missing
    directory yields an empty timeline — a half-written trace snapshot
    must never take down its reader."""
    run_dir = _profile_run_dir(trace_dir)
    if run_dir is None:
        return Timeline(source=trace_dir)
    tl = Timeline(source=run_dir)
    paths = sorted(glob.glob(os.path.join(run_dir, "*.pt.trace.json"))
                   + glob.glob(os.path.join(run_dir, "*.xplane.pb")))
    for path in paths:
        try:
            with open(path, "rb") as f:
                data = f.read()
            sub = (parse_chrome_trace(data, source=path)
                   if path.endswith(".json")
                   else parse_xplane_bytes(data, source=path))
        except (OSError, ValueError):
            tl.parse_errors += 1
            continue
        tl.planes.extend(sub.planes)
    return tl


# -- fixture encoder ----------------------------------------------------------
def _enc_varint(v: int) -> bytes:
    if v < 0:  # arithmetic shift never terminates on negatives
        raise ValueError(f"varint fields are unsigned, got {v}")
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_field(fnum: int, wt: int, payload: bytes) -> bytes:
    return _enc_varint((fnum << 3) | wt) + payload


def _enc_len(fnum: int, payload: bytes) -> bytes:
    return _enc_field(fnum, 2, _enc_varint(len(payload)) + payload)


def encode_xplane(planes: Sequence[dict]) -> bytes:
    """Serialize a synthetic XSpace proto — the fixture writer (tests
    hold the wire reader, and both packages' reports, against bytes this
    produces).

    Each plane dict: ``{"name": str, "lines": [{"name": str,
    "timestamp_ns": int, "events": [{"name": str, "offset_ps": int,
    "duration_ps": int, "stats": {key: int|float|str}}]}]}``.
    """
    space = b""
    for p in planes:
        event_md: Dict[str, int] = {}
        stat_md: Dict[str, int] = {}
        line_bufs = []
        for ln in p.get("lines", ()):
            ev_bufs = b""
            for ev in ln.get("events", ()):
                mid = event_md.setdefault(ev["name"], len(event_md) + 1)
                body = _enc_field(1, 0, _enc_varint(mid))
                body += _enc_field(2, 0, _enc_varint(int(ev.get("offset_ps", 0))))
                body += _enc_field(3, 0, _enc_varint(int(ev.get("duration_ps", 0))))
                for sk, sv in ev.get("stats", {}).items():
                    sid = stat_md.setdefault(sk, len(stat_md) + 1)
                    st = _enc_field(1, 0, _enc_varint(sid))
                    if isinstance(sv, bool):
                        st += _enc_field(4, 0, _enc_varint(int(sv)))
                    elif isinstance(sv, int):
                        st += _enc_field(4, 0, _enc_varint(sv))
                    elif isinstance(sv, float):
                        import struct

                        st += _enc_field(2, 1, struct.pack("<d", sv))
                    else:
                        st += _enc_len(5, str(sv).encode())
                    body += _enc_len(4, st)
                ev_bufs += _enc_len(4, body)
            lbuf = _enc_len(2, ln.get("name", "").encode())
            lbuf += _enc_field(3, 0, _enc_varint(int(ln.get("timestamp_ns", 0))))
            lbuf += ev_bufs
            line_bufs.append(lbuf)
        pbuf = _enc_len(2, p.get("name", "").encode())
        for lb in line_bufs:
            pbuf += _enc_len(3, lb)
        for md, fnum in ((event_md, 4), (stat_md, 5)):
            for name, mid in md.items():
                entry = _enc_field(1, 0, _enc_varint(mid))
                entry += _enc_len(2, _enc_field(1, 0, _enc_varint(mid))
                                  + _enc_len(2, name.encode()))
                pbuf += _enc_len(fnum, entry)
        space += _enc_len(1, pbuf)
    return space


# -- op classification (shared with analysis.schedule's per-class fold) -------
_COLLECTIVE_CLASSES = {
    "all-reduce": "all_reduce", "all_reduce": "all_reduce",
    "all-gather": "all_gather", "all_gather": "all_gather",
    "reduce-scatter": "reduce_scatter", "reduce_scatter": "reduce_scatter",
    "all-to-all": "all_to_all", "all_to_all": "all_to_all",
    "collective-permute": "collective_permute",
    "collective_permute": "collective_permute",
    "collective-broadcast": "collective_broadcast",
    "collective_broadcast": "collective_broadcast",
}

_CLASS_OF = {
    "dot": "dot", "dot_general": "dot", "dot-general": "dot",
    "convolution": "conv", "conv": "conv",
    "fusion": "fusion",
    "custom-call": "custom_call", "custom_call": "custom_call",
    "copy": "copy", "copy-start": "copy", "copy_start": "copy",
    "copy-done": "copy", "copy_done": "copy",
}


def op_class(name: str) -> str:
    """Map an op/instruction name (either an HLO instruction like
    ``dot.3`` / ``all-reduce-start.1`` from a trace row, or a normalized
    op from the static auditors like ``all_reduce``) onto the small class
    vocabulary calibration compares across: ``dot`` / ``conv`` /
    ``fusion`` / one class per collective kind / ``custom_call`` /
    ``copy`` / ``other``."""
    base = name.split(".", 1)[0].strip().lower()
    for suffix in ("-start", "-done", "_start", "_done"):
        if base.endswith(suffix) and base[:-len(suffix)] in _COLLECTIVE_CLASSES:
            base = base[:-len(suffix)]
            break
    if base in _COLLECTIVE_CLASSES:
        return _COLLECTIVE_CLASSES[base]
    if base in _CLASS_OF:
        return _CLASS_OF[base]
    # CPU thunks name fused computations after their ops
    # ("broadcast_add_fusion"); TPU names them "fusion.N"
    if base.endswith("fusion"):
        return "fusion"
    # the card's library products (cuBLAS / CUTLASS kernel names), and
    # convolutions and copies named by cuDNN and the profiler
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma")):
        return "dot"
    if "conv" in low and "convert" not in low:
        return "conv"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "copy"
    return "other"


def is_collective_class(cls: str) -> bool:
    return cls in set(_COLLECTIVE_CLASSES.values())


# -- measured report ----------------------------------------------------------
#: stat keys under which traces spell the bytes an op touched (JAX device
#: planes carry "bytes accessed"; fixtures use the same key)
_BYTES_STATS = ("bytes accessed", "bytes_accessed")

#: device-plane lines that duplicate the op rows with derived/bookkeeping
#: views — skipped so one op is one row (a port trace's step windows sit
#: on "Steps")
_DERIVED_LINES = frozenset({"Steps", "XLA Modules", "Source",
                            "Framework Name Scope", "Framework Ops"})


@dataclasses.dataclass
class OpRow:
    """One executed-op occurrence on a device lane."""

    device: str       # plane name (one per device on TPU/GPU)
    lane: str         # line within the plane (stream / executor thread)
    name: str         # instruction name as traced (e.g. "dot.3")
    start_ns: float
    dur_ns: float
    hlo_op: Optional[str] = None      # the hlo_op stat when present
    program: Optional[str] = None     # hlo_module stat (program identity)
    bytes: Optional[int] = None       # bytes-accessed stat where derivable

    @property
    def end_ns(self) -> float:
        return self.start_ns + self.dur_ns

    @property
    def op_class(self) -> str:
        return op_class(self.hlo_op or self.name)


@dataclasses.dataclass
class SpanRow:
    """One annotation occurrence (``obs.span`` / ``prof_step``)."""

    name: str
    start_ns: float
    dur_ns: float
    step: Optional[int] = None

    @property
    def end_ns(self) -> float:
        return self.start_ns + self.dur_ns


def _merged_intervals(rows: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(rows):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _intersection_ns(a: List[Tuple[float, float]],
                     b: List[Tuple[float, float]]) -> float:
    total = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclasses.dataclass
class MeasuredReport:
    """What one trace says actually executed."""

    op_rows: List[OpRow]
    spans: List[SpanRow]
    parse_errors: int = 0
    source: str = ""

    # -- hot ops ---------------------------------------------------------------
    def hot_ops(self, n: int = 10) -> List[dict]:
        """Top ``n`` ops by total self time, aggregated per (device, op)
        — multi-device runs keep per-device rows apart (one slow chip's
        op must not average away under seven fast ones)."""
        agg: Dict[Tuple[str, str], dict] = {}
        self_ns = self._self_times()
        for r, sns in zip(self.op_rows, self_ns):
            d = agg.setdefault((r.device, r.name), {
                "device": r.device, "name": r.name,
                "op_class": r.op_class, "count": 0,
                "total_ns": 0.0, "self_ns": 0.0, "max_ns": 0.0,
                "bytes": 0, "has_bytes": False})
            d["count"] += 1
            d["total_ns"] += r.dur_ns
            d["self_ns"] += sns
            d["max_ns"] = max(d["max_ns"], r.dur_ns)
            if r.bytes is not None:
                d["bytes"] += int(r.bytes)
                d["has_bytes"] = True
        rows = sorted(agg.values(), key=lambda d: -d["self_ns"])[:n]
        for d in rows:
            if not d.pop("has_bytes"):
                d["bytes"] = None
        return rows

    def _self_times(self) -> List[float]:
        """Per-row self time: duration minus time covered by rows nested
        inside it on the same (device, lane) — tracer lanes nest frames;
        device op lanes are flat and keep self == duration. Memoized:
        hot_ops / per_device_totals / class_seconds all consume it, and
        a real trace holds 10^5+ rows."""
        memo = getattr(self, "_self_memo", None)
        if memo is not None and len(memo) == len(self.op_rows):
            return memo
        order = sorted(range(len(self.op_rows)),
                       key=lambda i: (self.op_rows[i].device,
                                      self.op_rows[i].lane,
                                      self.op_rows[i].start_ns,
                                      -self.op_rows[i].dur_ns))
        self_ns = [0.0] * len(self.op_rows)
        stack: List[int] = []
        prev_key = None
        for i in order:
            r = self.op_rows[i]
            key = (r.device, r.lane)
            if key != prev_key:
                stack = []
                prev_key = key
            while stack and self.op_rows[stack[-1]].end_ns <= r.start_ns:
                stack.pop()
            self_ns[i] = r.dur_ns
            if stack and r.end_ns <= self.op_rows[stack[-1]].end_ns + 1e-9:
                self_ns[stack[-1]] -= r.dur_ns  # nested: parent loses it
            stack.append(i)
        memo = [max(0.0, v) for v in self_ns]
        self._self_memo = memo
        return memo

    def per_device_totals(self) -> Dict[str, float]:
        """Total op seconds per device plane — the multi-device split the
        aggregate table must never collapse."""
        out: Dict[str, float] = {}
        for r, sns in zip(self.op_rows, self._self_times()):
            out[r.device] = out.get(r.device, 0.0) + sns / 1e9
        return out

    # -- step correlation -----------------------------------------------------
    def step_rows(self) -> List[SpanRow]:
        """The capture's per-step windows (``prof_step`` spans, ordered
        by step id): on the card, each step's device window, idle gaps
        included (``prof_step.busy`` spans hold the card's busy time on
        the step's rows)."""
        rows = [s for s in self.spans if s.name == PROF_STEP_SPAN]
        return sorted(rows, key=lambda s: (s.step if s.step is not None
                                           else -1, s.start_ns))

    def step_seconds(self) -> List[float]:
        return [s.dur_ns / 1e9 for s in self.step_rows()]

    def span_breakdown(self) -> Dict[str, dict]:
        """Per-annotation-name aggregates (count, total/mean seconds,
        the step ids they landed on) — the measured side of every
        ``obs.span`` region."""
        out: Dict[str, dict] = {}
        for s in self.spans:
            d = out.setdefault(s.name, {"count": 0, "seconds": 0.0,
                                        "max_seconds": 0.0, "steps": set()})
            d["count"] += 1
            d["seconds"] += s.dur_ns / 1e9
            d["max_seconds"] = max(d["max_seconds"], s.dur_ns / 1e9)
            if s.step is not None:
                d["steps"].add(int(s.step))
        for d in out.values():
            d["mean_seconds"] = d["seconds"] / d["count"]
            d["steps"] = sorted(d["steps"])
        return out

    # -- measured overlap -----------------------------------------------------
    def overlap(self) -> Tuple[float, float, float]:
        """``(collective_seconds, hidden_seconds, compute_seconds)``:
        per device, the union of collective-row intervals intersected
        with the union of concurrent compute-row intervals — hidden time
        is collective time during which that device was also computing.
        Sync collectives serialized on the compute lane intersect
        nothing and read fully exposed, matching the schedule model's
        sync rule."""
        coll_s = hid_s = comp_s = 0.0
        by_dev: Dict[str, Tuple[list, list]] = {}
        for r in self.op_rows:
            coll, comp = by_dev.setdefault(r.device, ([], []))
            (coll if is_collective_class(r.op_class)
             else comp).append((r.start_ns, r.end_ns))
        for coll, comp in by_dev.values():
            ci = _merged_intervals(coll)
            ki = _merged_intervals(comp)
            coll_s += sum(e - s for s, e in ci) / 1e9
            comp_s += sum(e - s for s, e in ki) / 1e9
            hid_s += _intersection_ns(ci, ki) / 1e9
        return coll_s, hid_s, comp_s

    @property
    def overlap_fraction(self) -> float:
        """Hidden / total collective seconds — directly comparable to
        ``ScheduleReport.overlap_fraction`` (a collective-free trace
        counts as fully hidden, same convention)."""
        coll, hid, _ = self.overlap()
        if coll <= 0:
            return 1.0
        return hid / coll

    def class_seconds(self) -> Dict[str, float]:
        """Total self seconds per op class — the measured side of
        :func:`calibrate`."""
        out: Dict[str, float] = {}
        for r, sns in zip(self.op_rows, self._self_times()):
            cls = r.op_class
            out[cls] = out.get(cls, 0.0) + sns / 1e9
        return out

    def devices(self) -> List[str]:
        return sorted({r.device for r in self.op_rows})

    def summary(self) -> dict:
        """JSON-safe digest — what capture snapshots write to
        ``profile.json`` and the reports render."""
        steps = self.step_seconds()
        coll, hid, comp = self.overlap()  # once — the fraction reuses it
        overlap_frac = (hid / coll) if coll > 0 else 1.0
        spans = self.span_breakdown()
        return {
            "source": self.source,
            "n_op_rows": len(self.op_rows),
            "parse_errors": self.parse_errors,
            "devices": self.devices(),
            "per_device_seconds": {k: round(v, 9) for k, v
                                   in sorted(self.per_device_totals().items())},
            "hot_ops": [
                {**d, "total_ns": round(d["total_ns"], 3),
                 "self_ns": round(d["self_ns"], 3),
                 "max_ns": round(d["max_ns"], 3)}
                for d in self.hot_ops(10)],
            "steps": len(steps),
            "step_seconds": {
                "mean": sum(steps) / len(steps) if steps else None,
                "min": min(steps) if steps else None,
                "max": max(steps) if steps else None,
            },
            "spans": {k: {"count": v["count"],
                          "seconds": round(v["seconds"], 9),
                          "mean_seconds": round(v["mean_seconds"], 9),
                          "steps": v["steps"][:64]}
                      for k, v in sorted(spans.items())},
            "collective_seconds": round(coll, 9),
            "hidden_collective_seconds": round(hid, 9),
            "compute_seconds": round(comp, 9),
            "overlap_fraction": round(overlap_frac, 6),
            "class_seconds": {k: round(v, 9)
                              for k, v in sorted(self.class_seconds().items())},
        }


def measured_report(timeline: Timeline) -> MeasuredReport:
    """Classify a :class:`Timeline` into device op rows + annotation
    spans. Op rows are: every event on a ``/device:*`` plane's op lines
    (derived bookkeeping lines skipped), plus host-plane events carrying
    an ``hlo_op`` stat — which is where the CPU backend's thunk executor
    puts per-op execution. Spans are TraceMe rows with a ``step`` stat or
    the :data:`PROF_STEP_SPAN` name."""
    ops: List[OpRow] = []
    spans: List[SpanRow] = []
    for plane in timeline.planes:
        for line in plane.lines:
            for ev in line.events:
                step = ev.stats.get("step")
                if (isinstance(step, int) and not isinstance(step, bool)) \
                        or ev.name == PROF_STEP_SPAN:
                    spans.append(SpanRow(
                        name=ev.name, start_ns=ev.start_ns,
                        dur_ns=ev.dur_ns,
                        step=int(step) if isinstance(step, int) else None))
                    continue
                if ev.dur_ns <= 0:
                    continue
                hlo_op = ev.stats.get("hlo_op")
                if plane.is_device:
                    if line.name in _DERIVED_LINES:
                        continue
                elif hlo_op is None:
                    continue  # host plane: python frames, dispatch, ...
                nbytes = None
                for key in _BYTES_STATS:
                    v = ev.stats.get(key)
                    if isinstance(v, int):
                        nbytes = v
                        break
                ops.append(OpRow(
                    device=plane.name, lane=line.name, name=ev.name,
                    start_ns=ev.start_ns, dur_ns=ev.dur_ns,
                    hlo_op=hlo_op if isinstance(hlo_op, str) else None,
                    program=ev.stats.get("hlo_module")
                    if isinstance(ev.stats.get("hlo_module"), str) else None,
                    bytes=nbytes))
    return MeasuredReport(op_rows=ops, spans=spans,
                          parse_errors=timeline.parse_errors,
                          source=timeline.source)


# -- capture ------------------------------------------------------------------
# one trace session per process: capture(), the step controller and
# mx.profiler coordinate through this flag instead of racing the profiler
_trace_lock = threading.Lock()
_trace_busy = False


def trace_active() -> bool:
    """True while a trace session of this process is open: a capture, a
    step capture, ``mx.profiler.set_state('run')``, or a
    ``torch.profiler`` session opened by the caller. A StepGraph never
    captures while this holds."""
    if _trace_busy:
        return True
    try:
        from .. import profiler as _mx_profiler

        if _mx_profiler._state.get("running"):
            return True
    except ImportError:
        pass
    import torch

    return bool(torch.autograd._profiler_enabled())


# a StepGraph asks this module whether a session is open
_cg.set_trace_probe(trace_active)


def _acquire_trace() -> bool:
    global _trace_busy
    with _trace_lock:
        if trace_active():
            return False
        _trace_busy = True
        return True


def _release_trace() -> None:
    global _trace_busy
    with _trace_lock:
        _trace_busy = False


def _activities(device) -> list:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if _on_card(device):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _on_card(device) -> bool:
    return device is not None and getattr(device, "type", str(device)) \
        .startswith("cuda")


#: seconds a session on the card stays quiet after it opens: a graph
#: replay launched as the session opened was seen (H100, torch 2.11) to come
#: back without its first kernels, from one replay to the next
QUIET_S = 0.2


def _start(device):
    """Open a ``torch.profiler`` session (the caller holds the trace
    flag); on the card, the queue drained and :data:`QUIET_S` waited
    before it returns."""
    import torch

    prof = torch.profiler.profile(activities=_activities(device))
    prof.__enter__()
    if _on_card(device):
        try:
            torch.cuda.synchronize(device)
            time.sleep(QUIET_S)
        except BaseException:
            prof.__exit__(None, None, None)
            raise
    return prof


def _stop(prof, trace_dir: str) -> str:
    """Close a session and export its Chrome trace into a new session
    directory under ``trace_dir``; returns that directory."""
    prof.__exit__(None, None, None)
    run_dir = _session_dir(trace_dir)
    prof.export_chrome_trace(os.path.join(run_dir, TRACE_FILE))
    return run_dir


def _check_device_rows(report: "MeasuredReport", device, source: str):
    if _on_card(device) and not any(r.device.startswith("/device:GPU")
                                    for r in report.op_rows):
        raise RuntimeError(
            f"the capture of a program on {device} holds no device rows "
            f"({source}): the profiler recorded no kernel, so there is "
            "nothing measured to report")


@dataclasses.dataclass
class Capture:
    """One windowed capture: where the trace landed and what it showed."""

    trace_dir: str
    run_dir: Optional[str]
    timeline: Timeline
    report: MeasuredReport
    seconds: float                 # wall clock of the traced window
    steps: int
    trigger: str = "api"

    def summary(self) -> dict:
        return {"trace_dir": self.trace_dir, "run_dir": self.run_dir,
                "seconds": round(self.seconds, 6), "steps": self.steps,
                "trigger": self.trigger, "report": self.report.summary()}


#: untraced calls beyond ``warmup`` that :func:`capture` may take to reach
#: a call that replays (a StepGraph warms up once and captures once)
SETTLE_CALLS = 3


def capture(fn, *args, steps: int = 2, warmup: int = 1,
            trace_dir: Optional[str] = None, trigger: str = "api",
            step_offset: int = 0, device=None, replays_only: bool = False,
            **kwargs) -> Capture:
    """Trace ``steps`` calls of ``fn(*args, **kwargs)`` after ``warmup``
    untraced ones. Each traced call runs inside a ``prof_step``
    ``record_function`` and is synchronised before the annotation closes.
    ``device`` (a torch device, or None for a host function) adds the
    card's activity to the session; a capture on the card whose timeline
    holds no device rows raises RuntimeError, as does a session already
    open in this process.

    ``replays_only`` (the entry points set it): ``fn`` dispatches captured
    step graphs, and only replays may be traced. Untraced calls continue
    past ``warmup`` (at most :data:`SETTLE_CALLS` more) until one call
    neither warms up nor captures a graph; a traced call that did raises
    RuntimeError. Returns a :class:`Capture`."""
    import torch

    def unreplayed():
        return _cg.unreplayed_calls() if replays_only else 0

    if trace_dir is None:
        trace_dir = os.path.join(_default_dir(), "capture")
    trace_dir = os.path.abspath(trace_dir)
    os.makedirs(trace_dir, exist_ok=True)
    settled = not replays_only
    for _ in range(max(0, warmup)):
        n0 = unreplayed()
        _block(fn(*args, **kwargs), device)
        settled = unreplayed() == n0
    for _ in range(SETTLE_CALLS if not settled else 0):
        n0 = unreplayed()
        _block(fn(*args, **kwargs), device)
        if unreplayed() == n0:
            settled = True
            break
    if not settled:
        raise RuntimeError(f"{fn!r} still warms up or captures a step graph "
                           f"after {max(0, warmup) + SETTLE_CALLS} calls: "
                           "there is no replay to trace")
    n_eager = unreplayed()
    if not _acquire_trace():
        raise RuntimeError("a profiler trace session is already active "
                           "in this process")
    try:
        prof = _start(device)
        t0 = time.perf_counter()
        try:
            for _ in range(max(1, steps)):
                with torch.profiler.record_function(PROF_STEP_SPAN):
                    _block(fn(*args, **kwargs), device)
        except BaseException:
            prof.__exit__(None, None, None)
            raise
        dt = time.perf_counter() - t0
        run_dir = _stop(prof, trace_dir)
    finally:
        _release_trace()
    if unreplayed() != n_eager:
        raise RuntimeError(f"{unreplayed() - n_eager} traced call(s) of "
                           f"{fn!r} did not replay their step graph")
    timeline = parse_trace(run_dir)
    report = measured_report(timeline)
    _check_device_rows(report, device, run_dir)
    if step_offset:
        for s in report.spans:
            if s.step is not None:
                s.step += int(step_offset)
    _metrics.REGISTRY.counter(
        "prof_captures_total",
        "windowed trace captures, by trigger").inc(trigger=trigger)
    _metrics.REGISTRY.histogram(
        "prof_capture_seconds",
        "wall clock of one traced capture window (trace overhead "
        "included)", unit="s").observe(dt)
    _metrics.REGISTRY.gauge(
        "prof_overlap_measured",
        "measured compute/collective overlap fraction of the last "
        "capture").set(report.overlap_fraction)
    return Capture(trace_dir=trace_dir, run_dir=run_dir, timeline=timeline,
                   report=report, seconds=dt, steps=max(1, steps),
                   trigger=trigger)


def _block(out, device=None) -> None:
    """Wait for the card's work behind ``out`` (host outputs need none)."""
    import torch

    if _on_card(device):
        torch.cuda.synchronize(device)
        return
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if torch.is_tensor(t) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def write_snapshot(cap: Capture, directory: str, **meta) -> str:
    """Persist a capture summary as ``{directory}/profile.json`` (the
    trace itself already lives under ``cap.trace_dir``, normally inside
    ``directory``); returns the json path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "profile.json")
    payload = {"meta": {"ts": round(time.time(), 6), **meta},
               **cap.summary()}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def latest_profile(directory: str) -> Optional[dict]:
    """Newest ``profile.json`` under ``directory`` (searched one and two
    levels deep — run dirs keep captures under ``prof*/``), parsed; None
    when there is none or it is torn."""
    paths = glob.glob(os.path.join(directory, "profile.json")) \
        + glob.glob(os.path.join(directory, "*", "profile.json")) \
        + glob.glob(os.path.join(directory, "*", "*", "profile.json"))

    def _mtime(p):  # a retention sweep may delete a dir mid-scan
        try:
            return os.path.getmtime(p)
        except OSError:
            return 0.0

    for path in sorted(paths, key=_mtime, reverse=True):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            continue
    return None


# -- calibration ----------------------------------------------------------------
def calibrate(schedule, measured: MeasuredReport, steps: Optional[int] = None,
              band: float = 3.0, emit: bool = True):
    """Predicted (the schedule auditor's per-op-class roofline seconds)
    against measured class seconds. The auditor is part of ``analysis/*``,
    which the port does not have yet."""
    raise NotImplementedError(
        "calibrate needs the schedule auditor (analysis.schedule_report of "
        "the JAX package's analysis/*), which the port does not have yet")


# -- live-loop wiring (periodic + trigger-file capture) -----------------------
def request_path(fleet_dir: str, rank: int) -> str:
    """The trigger-file contract between the fleet aggregator (or a serving
    replica's slow-request hook) and a rank's step loop: the writer drops
    this file; the rank's next step consumes it, traces itself, and
    snapshots the result into its ``telemetry-h{rank}/`` dir."""
    return os.path.join(fleet_dir, f"prof-request-h{rank}.json")


class CaptureController:
    """Step-boundary capture decisions for ONE process's train loop.

    Armed by :func:`step_capture_begin` from the TrainStep hot path. Two
    triggers:

      - ``every_n`` (``MXNET_TPU_PROF_EVERY_N_STEPS``): every N-th step
        is traced — a rolling measured baseline;
      - a pending ``prof-request-h{rank}.json`` in the fleet dir, probed at
        most every :data:`TRIGGER_PROBE_SECONDS`.

    A step that is not a replay (it warms up or captures its CUDA graph)
    is never traced: a due periodic capture waits for the next replay, and
    the trigger file is not probed. Captures land under
    ``{fleet_dir}/telemetry-h{rank}/prof-*`` when a fleet dir is
    configured, else under ``{base_dir}/prof/``. After every capture a
    retention sweep bounds the total bytes of kept capture dirs
    (``MXNET_TPU_PROF_KEEP_BYTES``; the newest always survives). Every
    failure path degrades to "no capture" — profiling must never take
    down the step it measures."""

    def __init__(self, every_n: int, fleet_dir: str, base_dir: str,
                 keep_bytes: int, rank: int, generation: int, device=None):
        self.every_n = int(every_n)
        self.fleet_dir = fleet_dir or ""
        self.rank = int(rank)
        self.generation = int(generation)
        self.keep_bytes = int(keep_bytes)
        self.device = device
        if self.fleet_dir:
            self.out_base = os.path.join(
                os.path.abspath(self.fleet_dir), f"telemetry-h{self.rank}")
        else:
            self.out_base = os.path.join(os.path.abspath(base_dir), "prof")
        self._since = 0
        self._next_probe = 0.0
        self._warned = False

    @property
    def armed(self) -> bool:
        return self.every_n > 0 or bool(self.fleet_dir)

    def begin_if_due(self, step: int, replay: bool = True,
                     device=None) -> Optional[dict]:
        """One cheap decision per step: a counter bump, and (at most every
        :data:`TRIGGER_PROBE_SECONDS`) one trigger-file stat. Starts the
        trace and returns the capture token when due. ``replay=False``
        (the step captures its graph) defers whatever is due."""
        trigger = None
        if self.every_n > 0:
            self._since = min(self._since + 1, self.every_n)
            if self._since >= self.every_n and replay:
                self._since = 0
                trigger = "periodic"
        if trigger is None and self.fleet_dir and replay:
            now = time.monotonic()
            if now >= self._next_probe:
                self._next_probe = now + TRIGGER_PROBE_SECONDS
                if self._consume_request():
                    trigger = "straggler"
        if trigger is None:
            return None
        return self._begin(step, trigger, device or self.device)

    def _consume_request(self) -> bool:
        path = request_path(self.fleet_dir, self.rank)
        try:
            os.remove(path)  # consumed exactly once
            return True
        except OSError:
            return False

    def _begin(self, step: int, trigger: str, device) -> Optional[dict]:
        import torch

        t_in = time.perf_counter()
        if not _acquire_trace():
            return None  # a capture()/profiler session is already live
        dest = os.path.join(
            self.out_base, f"prof-g{self.generation}-s{step}-{trigger}")
        try:
            os.makedirs(dest, exist_ok=True)
            prof = _start(device)
        except Exception as e:
            _release_trace()
            if not self._warned:
                logger.warning("step capture not started: %s", e)
                self._warned = True
            return None
        ann = torch.profiler.record_function(PROF_STEP_SPAN)
        ann.__enter__()
        t0 = time.perf_counter()
        return {"step": step, "trigger": trigger, "dir": dest, "t0": t0,
                "begin_s": t0 - t_in, "prof": prof, "ann": ann,
                "device": device}

    def abort(self, token: dict) -> None:
        """A traced step raised before completing: close the annotation
        and the trace session so profiling survives the failure (the
        partial trace dir is left for the retention sweep)."""
        try:
            token["ann"].__exit__(None, None, None)
        except Exception:
            pass
        try:
            token["prof"].__exit__(None, None, None)
        except Exception:
            pass
        _release_trace()

    def end(self, token: dict, outputs=None) -> Optional[str]:
        """Block the traced step to completion, stop the session, parse
        + snapshot (``profile.json`` beside the trace), sweep retention.
        Returns the snapshot path (None when anything failed — counted,
        never raised)."""
        try:
            _block(outputs, token["device"])
            token["ann"].__exit__(None, None, None)
        except Exception:
            pass
        dt = time.perf_counter() - token["t0"]
        try:
            run_dir = _stop(token["prof"], token["dir"])
        except Exception as e:
            logger.warning("step capture stop failed: %s", e)
            _release_trace()
            return None
        _release_trace()
        try:
            timeline = parse_trace(run_dir)
            report = measured_report(timeline)
            for s in report.spans:
                if s.step is not None:
                    s.step = int(token["step"])
            cap = Capture(trace_dir=token["dir"], run_dir=run_dir,
                          timeline=timeline, report=report, seconds=dt,
                          steps=1, trigger=token["trigger"])
            path = write_snapshot(cap, token["dir"], rank=self.rank,
                                  generation=self.generation,
                                  step=token["step"],
                                  trigger=token["trigger"])
        except (OSError, ValueError) as e:
            logger.warning("step capture snapshot failed: %s", e)
            path = None
        _metrics.REGISTRY.counter(
            "prof_captures_total",
            "windowed trace captures, by trigger").inc(
                trigger=token["trigger"])
        _metrics.REGISTRY.histogram(
            "prof_capture_seconds",
            "wall clock of one traced capture window (trace overhead "
            "included)", unit="s").observe(dt)
        _events.LOG.emit("prof_capture", step=token["step"],
                         trigger=token["trigger"], seconds=round(dt, 6),
                         dir=token["dir"])
        self._sweep_retention()
        return path

    def _sweep_retention(self) -> None:
        """Bound total bytes of kept capture dirs: delete oldest
        ``prof-*`` dirs until the sum fits ``keep_bytes`` (the newest is
        never deleted — the capture that just landed must survive its
        own sweep)."""
        if self.keep_bytes <= 0:
            return
        from ..checkpoint import _dir_bytes  # shared sizing helper

        try:
            dirs = [d for d in glob.glob(os.path.join(self.out_base,
                                                      "prof-*"))
                    if os.path.isdir(d)]
            dirs.sort(key=lambda d: os.path.getmtime(d))
            sizes = {d: _dir_bytes(d) for d in dirs}
            total = sum(sizes.values())
            for d in dirs[:-1]:  # newest always kept
                if total <= self.keep_bytes:
                    break
                shutil.rmtree(d, ignore_errors=True)
                total -= sizes[d]
        except OSError:
            pass


_controller: object = None  # None = unresolved, False = disabled
_controller_lock = threading.Lock()


def _ensure_controller():
    global _controller
    with _controller_lock:
        if _controller is None:
            from .. import config as _config
            from . import telemetry_dir

            ctl = CaptureController(
                every_n=_config.get("prof_every_n_steps"),
                fleet_dir=_config.get("fleet_dir"),
                # local captures land beside the run's telemetry when it
                # is on, else under the profiler dump dir
                base_dir=telemetry_dir() or _default_dir(),
                keep_bytes=_config.get("prof_keep_bytes"),
                rank=int(os.environ.get("MXNET_TPU_PROCID", "0")),
                generation=int(os.environ.get("MXNET_TPU_GENERATION", "0")))
            _controller = ctl if ctl.armed else False
        return _controller


def _reset_controller() -> None:
    """Re-resolve the controller from config on next use (tests)."""
    global _controller
    with _controller_lock:
        _controller = None


def step_capture_begin(step: int, replay: bool = True,
                       device=None) -> Optional[dict]:
    """TrainStep's per-step probe: resolves the controller once, then
    costs one attribute read + one call per step while disarmed.
    ``replay`` says whether the step about to run replays its captured
    graph (or runs eagerly by choice): only such a step is traced."""
    c = _controller
    if c is None:
        c = _ensure_controller()
    if c is False:
        return None
    return c.begin_if_due(step, replay=replay, device=device)


def step_capture_begin_seconds(token: Optional[dict]) -> float:
    """Seconds :func:`step_capture_begin` spent opening the session (on
    the card a drained queue and :data:`QUIET_S`): the caller takes them
    out of the traced step's recorded time. 0.0 without a capture."""
    return token["begin_s"] if token is not None else 0.0


def step_capture_end(token: Optional[dict], outputs=None) -> Optional[str]:
    if token is None:
        return None
    c = _controller
    if not isinstance(c, CaptureController):
        return None
    return c.end(token, outputs)


def step_capture_abort(token: Optional[dict]) -> None:
    """Close a step capture whose traced step raised (see
    :meth:`CaptureController.abort`)."""
    if token is None:
        return
    c = _controller
    if isinstance(c, CaptureController):
        c.abort(token)
