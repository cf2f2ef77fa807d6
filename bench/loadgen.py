"""The load generator: a process of its own, started by ``bench/run.py``,
that submits every request of a run and times it on its own clock.

    python bench/loadgen.py <fd> [<cpu>]

``start`` runs it with one end of a socket pair as ``<fd>``, over which
it reads its parameters (a length as 8 bytes, then JSON) and talks to
the serving process.  (A child joined to the serving process by its
standard input and output pipes left the CUDA profiler in the serving
process blind, on the H100 machines this benchmark was built on; a
socket pair did not.)

It talks to the serving process over that socket in fixed-size frames
(``REQ`` out, ``REP`` in) and imports neither torch nor the program.  Search clients are closed loops: each of ``clients``
keeps one request of ``search_rows`` query rows in flight and sends the
next when the reply arrives.  The insert stream is an open loop: inserts
of ``insert_rows`` rows go out at the times of a Poisson schedule drawn
from the seed (``schedule.arrivals``: the same number in the window for
every seed), however the server keeps up, and each is timed from its
scheduled time.  Every ``check_every``-th insert, once acknowledged, is
searched for: the next client to send sends a search of that insert's
own rows (a ``CHECK`` frame) in place of its next query batch, so that
the loop keeps ``clients`` requests in flight.  The run is a lead-in of ``lead_in_s`` and then the
window of ``seconds``; at the window's close the clients stop sending,
the outstanding requests drain, and a summary goes back as JSON.

All times are ``time.perf_counter()``: CLOCK_MONOTONIC on Linux, one
clock for both processes.
"""

from __future__ import annotations

import json
import os
import select
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

# client -> server: kind, request id, argument (a query batch, an insert's
# number, or for CHECK the number of the insert searched for), time
REQ = struct.Struct("<BQQd")
# server -> client: kind, status (0 ok, 1 failed), request id
REP = struct.Struct("<BbQ")
LEN = struct.Struct("<Q")  # the parameters' length, before them
SEARCH, INSERT, CHECK, GO, WINDOW, DONE = 0, 1, 2, 7, 8, 9
DRAIN_S = 120.0  # the longest a reply may come after the window's close


def _write_all(fd: int, data: bytes) -> None:
    view = memoryview(data)
    while view:
        view = view[os.write(fd, view):]


def cores() -> list:
    """One CPU of each physical core this process may run on (by the
    kernel's topology files; each CPU alone where they are missing)."""
    seen, out = set(), []
    for cpu in sorted(os.sched_getaffinity(0)):
        path = Path(f"/sys/devices/system/cpu/cpu{cpu}/topology/core_cpus_list")
        key = path.read_text().strip() if path.exists() else str(cpu)
        if key not in seen:
            seen.add(key)
            out.append(cpu)
    return out


def pin() -> int | None:
    """Keep this process (and the threads it starts from now on) on one
    CPU of each physical core but the last, and return a CPU of the last
    core for the load generator; ``None``, and nothing pinned, with fewer
    than three cores.  A run's threads then never share a core's
    hyperthreads, nor move between cores, whichever run it is."""
    free = cores()
    if len(free) < 3:
        return None
    os.sched_setaffinity(0, free[:-1])
    return free[-1]


def start(cpu: int | None = None):
    """The load generator's process, idle until it is sent its
    parameters (on ``cpu`` where given), and this side's end of its
    socket."""
    mine, theirs = socket.socketpair()
    args = [sys.executable, str(Path(__file__).resolve()), str(theirs.fileno())]
    if cpu is not None:
        args.append(str(cpu))
    proc = subprocess.Popen(args, pass_fds=[theirs.fileno()])
    theirs.close()
    return proc, mine


def _read_exact(fd: int, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = os.read(fd, n - len(out))
        if not chunk:
            raise EOFError("the serving process closed the pipe")
        out += chunk
    return out


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from bench.schedule import arrivals, client_orders

    fin = fout = int(sys.argv[1])
    if len(sys.argv) > 2:
        os.sched_setaffinity(0, {int(sys.argv[2])})
    (size,) = LEN.unpack(_read_exact(fin, LEN.size))
    params = json.loads(_read_exact(fin, size))
    seed = params["seed"]
    clients = params["clients"]
    lead, seconds = params["lead_in_s"], params["seconds"]
    buf = b""

    def frames():
        nonlocal buf
        ready, _, _ = select.select([fin], [], [], timeout)
        if ready:
            chunk = os.read(fin, 1 << 16)
            if not chunk:
                raise EOFError("the serving process closed the pipe")
            buf += chunk
        n = len(buf) // REP.size
        out = [REP.unpack_from(buf, i * REP.size) for i in range(n)]
        buf = buf[n * REP.size:]
        return out

    # wait for the server's go
    timeout = None
    while not any(k == GO for k, _, _ in frames()):
        pass
    t_start = time.perf_counter()
    t0 = t_start + lead
    t1 = t0 + seconds
    per_client = int((lead + seconds) * params["max_client_rps"]) + 16
    orders = client_orders(clients, params["batches"], per_client, seed)
    ins_rate = params["insert_rate"]
    if ins_rate:
        t_ins = t_start + arrivals(ins_rate, lead, seconds, seed)
        n_ins = len(t_ins)
        if n_ins > params["max_inserts"]:
            raise ValueError(f"{n_ins} inserts exceed the bank's "
                             f"{params['max_inserts']}")
    else:
        t_ins, n_ins = [], 0
    _write_all(fout, REQ.pack(WINDOW, 0, 0, t0))

    next_id = 0
    pending = {}  # request id -> (kind, client, t_send, arg)
    turn = [0] * clients
    check_every = params["check_every"]
    checks_due = []  # acknowledged inserts to search for
    s_send, s_recv, s_ok, s_rows = [], [], [], []
    i_sched, i_ack, i_ok = [], [], []

    out = bytearray()  # frames to send, one write a turn of the loop

    def send_search(c: int, now: float) -> None:
        nonlocal next_id
        if checks_due:
            kind, arg = CHECK, checks_due.pop(0)
        else:
            kind, arg = SEARCH, int(orders[c][turn[c] % per_client])
            turn[c] += 1
        pending[next_id] = (kind, c, now, arg)
        out.extend(REQ.pack(kind, next_id, arg, now))
        next_id += 1

    now = time.perf_counter()
    for c in range(clients):
        send_search(c, now)
    k = 0  # next insert to send
    while True:
        now = time.perf_counter()
        while k < n_ins and t_ins[k] <= now:
            pending[next_id] = (INSERT, k, float(t_ins[k]), k)
            out += REQ.pack(INSERT, next_id, k, float(t_ins[k]))
            next_id += 1
            k += 1
        if out:
            _write_all(fout, bytes(out))
            out.clear()
        if now >= t1 and not pending:
            break
        if now > t1 + DRAIN_S:
            raise TimeoutError(f"{len(pending)} requests unanswered "
                               f"{DRAIN_S} s after the window")
        due = t_ins[k] if k < n_ins else t1 + DRAIN_S
        timeout = max(0.0, min(due, t1 if now < t1 else due) - now)
        for kind, status, rid in frames():
            now = time.perf_counter()
            what, c, t_send, arg = pending.pop(rid)
            if what == INSERT:
                i_sched.append(t_send)
                i_ack.append(now)
                i_ok.append(status == 0)
                if status == 0 and check_every and arg % check_every == check_every - 1:
                    checks_due.append(arg)
            else:
                s_send.append(t_send)
                s_recv.append(now)
                s_ok.append(status == 0)
                s_rows.append(params["insert_rows"] if what == CHECK
                              else params["search_rows"])
                if now < t1:
                    send_search(c, now)
    blob = json.dumps({
        "t0": t0, "t1": t1, "t_start": t_start,
        "search_send": s_send, "search_recv": s_recv, "search_ok": s_ok,
        "search_rows": s_rows,
        "insert_sched": i_sched, "insert_ack": i_ack, "insert_ok": i_ok,
        "inserts_sent": k,
    }).encode()
    _write_all(fout, REQ.pack(DONE, len(blob), 0, 0.0) + blob)


if __name__ == "__main__":
    try:
        main()
    except EOFError:  # the serving process ended without a run
        sys.exit(1)
