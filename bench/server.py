"""The served path of a run: the index built from the seed, the runtime
over it, and the harness's one thread between the runtime and the load
generator's process: a receiver that submits each request.  Each reply
goes back from the runtime lane that resolved the request, in its
done-callback.  No client runs in this process.

The harness reads the runtime through its public surface only: the
futures of ``submit_search``/``submit_insert``, ``stats``/``reset_stats``
and the sampled request traces of ``traces()`` (``repro_torch.obs.trace``;
a traced run samples every request).  Which requests one dispatch served
comes from those traces: the requests of a dispatch share the time its
``batch_form`` span ends, and each request's future resolves between
the end of its ``device_wait`` span and the end of its ``ack`` span.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import socket
import threading
import time
from typing import Optional

import numpy as np
import torch

from bench import gen
from bench.loadgen import (CHECK, DONE, DRAIN_S, GO, INSERT, LEN, REP, REQ, SEARCH,
                           WINDOW)

REJECT_WAIT_S = 5.0  # the longest the receiver retries a search the slots refuse


def _read_exact(sock, n: int) -> Optional[bytes]:
    """``n`` bytes from the socket, or ``None`` at its end."""
    parts, got = [], 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            return None
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


class Stages:
    """Seconds of each set-up stage, printed as they end."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict[str, float] = {}
        self._t = time.perf_counter()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def done(self, name: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now
        print(f"[setup] {name} {self.seconds[name]:.3f} s", flush=True)


@dataclasses.dataclass
class Built:
    index: object
    corpus: torch.Tensor  # [n, D] on the device
    labels: Optional[torch.Tensor]  # generator labels of the corpus rows
    qbank: np.ndarray  # [batches * rows, D] held-out queries (host)
    ibank: np.ndarray  # [rows, D] the insert stream's rows (host)
    ilabels: Optional[torch.Tensor]
    warm_rows: int  # leading rows of ibank the warm-up inserts
    n_inserts_max: int


def _index_config(cfg: dict):
    from repro_torch.core.ivf import IVFIndexConfig

    return IVFIndexConfig(**cfg["index"])


def build(cell, seed: int, seconds: float, device: torch.device,
          stages: Stages) -> Built:
    """Draw the inputs and build the index by ``train`` and ``add``."""
    from repro_torch.core.ivf import IVFIndex

    cfg, tr = cell.config, cell.traffic
    dim, kind = cfg["dim"], cfg["corpus"]
    corpus, labels = gen.draw(kind, cfg["n_rows"], dim, seed,
                              gen.STREAM_CORPUS, device)
    search = tr["search"]
    queries, _ = gen.draw(kind, tr["query_batches"] * search["rows"], dim,
                          seed, gen.STREAM_QUERIES, device)
    ins = tr.get("insert")
    warm_rows, n_max = 0, 0
    if ins:
        warm_rows = max(ins["rows"], cfg["runtime"]["flush_min"])
        n_max = int((tr["lead_in_s"] + seconds) * ins["rate"] * 1.25) + 32
    inserts, ilabels = gen.draw(kind, warm_rows + n_max * (ins["rows"] if ins else 0),
                                dim, seed, gen.STREAM_INSERTS, device)
    qbank, ibank = queries.cpu().numpy(), inserts.cpu().numpy()
    del queries, inserts
    stages.done("draw")

    index = IVFIndex(_index_config(cfg), device=device)
    index.train(corpus[: cfg["train_rows"]])
    stages.done("train")
    step = cfg["add_batch"]
    for off in range(0, cfg["n_rows"], step):
        ids = index.add(corpus[off : off + step])
        if ids[0] != off or ids[-1] != off + len(ids) - 1:
            raise RuntimeError(f"bulk add gave ids {ids[0]}..{ids[-1]} at row {off}")
    dropped = int(index.state.num_dropped)
    if dropped:
        raise RuntimeError(f"the bulk add dropped {dropped} rows")
    stages.done("add")
    return Built(index, corpus, labels, qbank, ibank, ilabels, warm_rows, n_max)


@dataclasses.dataclass
class SearchRec:
    batch: int  # query-bank batch; -1 for the self-check searches
    t_sub: float
    t_done: float = 0.0
    result: Optional[tuple] = None  # (dists, ids) as answered
    ok: bool = False
    rows: Optional[np.ndarray] = None  # the query rows (self-check only)
    self_ids: Optional[np.ndarray] = None  # each row's own id (self-check)



@dataclasses.dataclass
class Dispatch:
    """One search dispatch, as its requests' traces show it."""

    t_start: float  # its requests' ``batch_form`` span ends
    t_device: float  # their ``device_wait`` span ends
    t_acked: float  # the last of their ``ack`` spans ends
    requests: int  # requests it served
    recs: list = dataclasses.field(default_factory=list)  # their SearchRecs


def _span_end(trace, stage: str):
    ends = [t for s, t in trace.marks if s == stage]
    return ends[-1] if ends else None


def dispatches(traces: list, kind: str) -> list:
    """The dispatches of ``kind`` requests (``search``, ``insert``) whose
    every request finished ``ok``, in order: requests are grouped by the
    time their ``batch_form`` span ended, which the lane stamps once a
    dispatch."""
    groups: dict = {}
    for tr in traces:
        if tr.kind != kind:
            continue
        t_b = _span_end(tr, "batch_form")
        if t_b is not None:
            groups.setdefault(t_b, []).append(tr)
    out = []
    for t_b, trs in sorted(groups.items()):
        if any(tr.outcome != "ok" for tr in trs):
            continue
        t_dev = [_span_end(tr, "device_wait") for tr in trs]
        t_ack = [_span_end(tr, "ack") for tr in trs]
        if None in t_dev or None in t_ack:
            continue
        out.append(Dispatch(t_b, max(t_dev), max(t_ack), len(trs)))
    return out


def attach(found: list, recs) -> None:
    """Give each dispatch of ``found`` the SearchRecs it answered: the
    done-callback that timed a request's ``t_done`` ran in the lane
    between the dispatch's ``device_wait`` and ``ack`` ends."""
    starts = np.array([d.t_device for d in found])
    for rec in recs:
        if not rec.ok:
            continue
        at = int(np.searchsorted(starts, rec.t_done, side="right")) - 1
        if at >= 0 and rec.t_done <= found[at].t_acked:
            found[at].recs.append(rec)


@dataclasses.dataclass
class InsertRec:
    first: int  # first row of ibank
    n: int
    t_sub: float
    t_ack: float = 0.0
    ids: Optional[np.ndarray] = None
    ok: bool = False


class Served:
    """The runtime over the built index, fed by the load generator."""

    def __init__(self, built: Built, cell, seed: int, seconds: float,
                 trace: bool):
        from repro_torch.core.scheduler import RuntimeConfig, ServingRuntime

        self.b, self.cell, self.seed, self.seconds = built, cell, seed, seconds
        rcfg = dict(cell.config["runtime"])
        if trace:  # traced runs keep every request's spans
            rcfg.update(trace_sample_rate=1.0, trace_buffer=1 << 18)
        self.rt = ServingRuntime(built.index, RuntimeConfig(**rcfg))
        self.rows = cell.traffic["search"]["rows"]
        self.searches: dict[int, SearchRec] = {}
        self.inserts: dict[int, InsertRec] = {}  # by the stream's number
        self.warm_inserts: list[InsertRec] = []
        self.lanes: dict[int, str] = {}  # native thread id -> lane name
        self.search_dispatches: list[Dispatch] = []  # read after the window
        self.rejected_retries = 0
        self.t0 = self.t1 = None
        self.profile: Optional[dict] = None
        self._sock = None  # the load generator's socket, while serving
        self._send_lock = threading.Lock()
        self._done: queue.Queue = queue.Queue()

    # ------------------------------------------------------------ warm-up --
    def warm(self) -> None:
        """One search at each batch bucket the traffic reaches (requests of
        ``rows`` rows, up to ``max_search_batch`` a dispatch) and, where
        the traffic inserts, one flush of inserts."""
        most = self.rows * self.cell.config["runtime"]["max_search_batch"]
        n = self.rows
        while True:
            n = min(n, most)
            fut = self.rt.submit_search(self.b.qbank[:n])
            fut.add_done_callback(lambda f: self._lane("search"))
            fut.result(timeout=600)
            if n == most:
                break
            n *= 2
        ins = self.cell.traffic.get("insert")
        if ins:
            futs = []
            for off in range(0, self.b.warm_rows, ins["rows"]):
                rec = InsertRec(off, ins["rows"], time.perf_counter())
                futs.append((rec, self.rt.submit_insert(
                    self.b.ibank[off : off + ins["rows"]])))
                futs[-1][1].add_done_callback(lambda f: self._lane("mutation"))
            for rec, f in futs:
                rec.ids = f.result(timeout=600)
                rec.t_ack, rec.ok = time.perf_counter(), True
                self.warm_inserts.append(rec)
        self.rt.reset_stats()

    def _lane(self, name: str) -> None:
        # a future's done-callback runs on the lane that resolved it
        self.lanes[threading.get_native_id()] = name

    # ----------------------------------------------------------- serving --
    def _reply(self, kind: int, ok: bool, rid: int) -> None:
        # from the lane that resolved the request (its done-callback):
        # a 10-byte send, under a lock since both lanes reply
        with self._send_lock:
            self._sock.sendall(REP.pack(kind, 0 if ok else 1, rid))

    def _on_search(self, rid: int, rec: SearchRec, fut) -> None:
        rec.t_done = time.perf_counter()
        try:
            rec.result, rec.ok = fut.result(), True
        except Exception:
            rec.ok = False
        self._reply(SEARCH, rec.ok, rid)

    def _on_insert(self, rid: int, rec: InsertRec, fut) -> None:
        rec.t_ack = time.perf_counter()
        try:
            rec.ids, rec.ok = fut.result(), True
        except Exception:
            rec.ok = False
        self._reply(INSERT, rec.ok, rid)

    def _submit_search(self, rows: np.ndarray):
        from repro_torch.core.admission import RequestRejected

        deadline = time.perf_counter() + REJECT_WAIT_S
        while True:
            try:
                return self.rt.submit_search(rows)
            except RequestRejected:
                # a slot frees once its batch's futures have all resolved,
                # a moment after the reply that let the client send again
                if time.perf_counter() > deadline:
                    raise
                self.rejected_retries += 1
                time.sleep(0.0002)

    def _receive(self, out) -> None:
        try:
            self._receive_frames(out)
        finally:
            self._done.put(None)  # unblocks serve() if no summary came

    def _search(self, rid: int, rec: SearchRec, rows: np.ndarray) -> None:
        self.searches[rid] = rec
        fut = self._submit_search(rows)
        fut.add_done_callback(
            lambda f, rid=rid, rec=rec: self._on_search(rid, rec, f))

    def _receive_frames(self, sock) -> None:
        ins_rows = (self.cell.traffic.get("insert") or {}).get("rows", 0)
        buf = b""
        while True:
            # every frame that has come, taken in one wake-up: the lanes
            # are asked for the interpreter lock once a burst, not a frame
            chunk = sock.recv(1 << 16)
            if not chunk:
                return
            buf += chunk
            at = 0
            while len(buf) - at >= REQ.size:
                kind, rid, arg, t = REQ.unpack_from(buf, at)
                at += REQ.size
                if kind == SEARCH:
                    lo = arg * self.rows
                    self._search(rid, SearchRec(arg, time.perf_counter()),
                                 self.b.qbank[lo : lo + self.rows])
                elif kind == CHECK:
                    # a search of an acknowledged insert's own rows, sent
                    # once its ack came back: each row must be found
                    ins = self.inserts[arg]
                    rows = self.b.ibank[ins.first : ins.first + ins.n]
                    self._search(rid, SearchRec(-1, time.perf_counter(), rows=rows,
                                                self_ids=ins.ids.astype(np.int64)),
                                 rows)
                elif kind == INSERT:
                    first = self.b.warm_rows + arg * ins_rows
                    rec = InsertRec(first, ins_rows, time.perf_counter())
                    self.inserts[arg] = rec
                    fut = self.rt.submit_insert(self.b.ibank[first : first + ins_rows])
                    fut.add_done_callback(
                        lambda f, rid=rid, rec=rec: self._on_insert(rid, rec, f))
                elif kind == WINDOW:
                    self.t0, self.t1 = t, t + self.seconds
                elif kind == DONE:
                    rest = buf[at:]
                    more = _read_exact(sock, rid - len(rest)) if rid > len(rest) else b""
                    self._done.put(json.loads(rest + more))
                    return
            buf = buf[at:]

    def serve(self, link, window=None) -> dict:
        """Hand the load generator (``link``, ``loadgen.start``'s process
        and socket) its parameters, let it run its lead-in and window,
        and return its summary once every request has been answered.
        ``window`` (``devtrace.Window``), when given, is armed before the
        traffic starts and run on this thread during the window; its
        result is kept as ``self.profile``."""
        tr = self.cell.traffic
        ins = tr.get("insert") or {}
        params = {
            "seed": self.seed, "seconds": self.seconds,
            "lead_in_s": tr["lead_in_s"], "clients": tr["search"]["clients"],
            "batches": tr["query_batches"],
            "max_client_rps": tr["search"]["max_client_rps"],
            "insert_rate": ins.get("rate", 0.0),
            "max_inserts": self.b.n_inserts_max,
            "search_rows": self.rows, "insert_rows": ins.get("rows", 0),
            "check_every": self.cell.config["judge"]["self_check_every"],
        }
        proc, sock = link
        self._sock = sock
        blob = json.dumps(params).encode()
        sock.sendall(LEN.pack(len(blob)) + blob)
        receiver = threading.Thread(target=self._receive, args=(sock,),
                                    name="bench-receiver", daemon=True)
        try:
            receiver.start()
            if window is not None:
                window.arm()
            with self._send_lock:
                sock.sendall(REP.pack(GO, 0, 0))
            if window is not None:
                while self.t0 is None:
                    time.sleep(0.01)
                self.profile = window.run(self)
            summary = self._done.get(timeout=tr["lead_in_s"] + self.seconds + DRAIN_S + 60)
            if summary is None:
                raise RuntimeError("the load generator ended without its summary")
            return summary
        finally:
            sock.shutdown(socket.SHUT_RDWR)  # ends the receiver's read
            receiver.join(30)
            sock.close()
            code = proc.wait(30)
            if code:
                raise RuntimeError(f"the load generator exited with {code}")

    def stop(self) -> None:
        self.rt.stop()
