"""EASGD center server over TCP: the server/worker split across
processes.

Port of ``theanompi_tpu/parallel/center_server.py``.  Reference:
``theanompi/easgd_server.py`` — a dedicated process holds the center
parameters and serialises worker requests ('exchange',
'copy_to_local', stop); workers at different speeds reach it at
different times.

Process 0 of a multi-process EASGD run hosts the center as host numpy
arrays; a lock serialises exchanges as the reference's request loop
did, and each worker process exchanges whenever its own step counter
says so, with no barrier.

Wire format, byte for byte the JAX package's: a length-prefixed
pickled control frame, then the parameter list as a streamed sequence
of per-leaf raw byte chunks (never one whole-list pickle).  A header
entry is a tuple of plain Python values, ``(shape, wire dtype name,
original dtype name, scale)``, so either package unpickles the other's
frames.  fp32 leaves may travel as bf16 (the ``*16`` strategies' wire):
half the bytes each way, the elastic update still accumulated in fp32
on both ends.

Host leaves are numpy arrays, except bfloat16 leaves, which numpy has
no dtype for: those are CPU ``torch.bfloat16`` tensors, whose bits
travel as a 2-byte view under the name ``"bfloat16"``.  The fp32 ->
bf16 cast is torch's round-to-nearest-even, the rounding ``ml_dtypes``
gives the JAX package; the way back is exact.

The JAX package's quantized wire (``int8``/``fp8`` with a per-leaf
scale and the client's error-feedback residual) is not ported yet
(ROADMAP.md A8): asking for it raises ``NotImplementedError``.
"""

from __future__ import annotations

import pickle
import select
import socket
import struct
import threading
import time

import numpy as np
import torch

_LEN = struct.Struct(">Q")
_WIRE_CHUNK = 4 << 20  # stream granularity: bounds per-write buffers
BF16 = "bfloat16"

#: the JAX package's quantized TCP wire codecs (not ported: A8)
WIRE_CODECS = ("int8", "fp8")


def _send(sock: socket.socket, obj, timeout_s: float | None = None) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    payload = _LEN.pack(len(data)) + data
    _nb = getattr(socket, "MSG_DONTWAIT", None)
    if timeout_s is None or _nb is None:
        sock.sendall(payload)
        return
    # deadline-bounded send: a peer that stops reading would leave
    # sendall blocked on a full buffer.  select + per-call non-blocking
    # sends keep the fd itself blocking for a concurrent reader thread;
    # the caller must be the socket's only writer
    deadline = time.monotonic() + timeout_s
    mv = memoryview(payload)
    off = 0
    while off < len(mv):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise socket.timeout(
                f"send_frame: {len(mv) - off} bytes unsent "
                f"after {timeout_s}s (peer not reading)"
            )
        _, writable, _ = select.select([], [sock], [], remaining)
        if not writable:
            continue
        try:
            off += sock.send(mv[off:], _nb)
        except BlockingIOError:
            continue    # raced the buffer; select again


def _recv(sock: socket.socket):
    hdr = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(hdr)
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Exactly ``n`` bytes, received into one buffer."""
    buf = bytearray(n)
    mv = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(mv[got:], n - got)
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


#: public aliases for the length-prefixed pickle control frame, which
#: the serving fleet's replica protocol (``serving/replica.py``) rides
send_frame = _send
recv_frame = _recv


def _no_delay(sock: socket.socket) -> socket.socket:
    """Turn off Nagle's algorithm: a request is a few small frames and
    then a wait for the reply, which Nagle's hold-back and the peer's
    delayed ACK would stall by tens of ms an exchange."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


# -- host leaves and the streamed array wire ---------------------------------

def _to_host(leaves) -> list:
    """Each leaf on the host: a C-contiguous numpy array, or a CPU
    ``torch.bfloat16`` tensor for a bf16 leaf.  A tensor is copied,
    from the CPU too: a queued push must not see later in-place
    updates."""
    out = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", copy=True).contiguous()
            if x.dtype != torch.bfloat16:
                x = x.numpy()
        if not isinstance(x, torch.Tensor):
            x = np.ascontiguousarray(np.asarray(x))
        out.append(x)
    return out


def _dtype_name(a) -> str:
    return BF16 if isinstance(a, torch.Tensor) else a.dtype.name


def _wire_name(wire) -> str | None:
    """A wire spec (None, ``"bfloat16"``, ``torch.bfloat16``, a numpy
    dtype) as the dtype name the exchange frame carries."""
    if wire is None:
        return None
    if wire == BF16 or wire is torch.bfloat16:
        return BF16
    if wire in WIRE_CODECS:
        raise NotImplementedError(
            f"the {wire!r} TCP wire (per-leaf quantization with error "
            f"feedback) is not ported yet (ROADMAP.md A8)")
    return np.dtype(wire).name


def _cast(x, like):
    """``x`` in ``like``'s dtype, as ``like``'s kind (numpy array or
    bf16 tensor)."""
    if isinstance(like, torch.Tensor):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return x.to(like.dtype)
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, like.dtype)


def wire_cast(leaves: list, wire) -> tuple[list, list[str], list]:
    """Host leaves, their ORIGINAL dtype names and their wire scales
    (``None``: no quantized codec is ported), with fp32 leaves cast to
    the wire dtype; other leaves (int steps, bf16 leaves) pass through
    unchanged.  ``wire`` is None, ``"bfloat16"``/``torch.bfloat16`` (the
    ``*16`` strategies) or a numpy dtype; ``"int8"``/``"fp8"`` raise
    ``NotImplementedError`` (ROADMAP.md A8)."""
    wname = _wire_name(wire)
    out, orig = [], []
    for a in _to_host(leaves):
        orig.append(_dtype_name(a))
        if orig[-1] == "float32" and wname not in (None, "float32"):
            if wname == BF16:
                a = torch.from_numpy(a).to(torch.bfloat16)
            else:
                a = a.astype(wname)
        out.append(a)
    return out, orig, [None] * len(out)


def _bytes_view(a) -> memoryview:
    """A leaf's raw bytes, without a copy (the leaves are contiguous)."""
    if isinstance(a, torch.Tensor):
        return memoryview(a.reshape(-1).view(torch.uint8).numpy())
    return memoryview(a.reshape(-1).view(np.uint8))


def _header(arrs: list, orig_names: list[str], scales: list | None) -> list:
    """The stream header: one ``(shape, wire name, original name,
    scale)`` tuple of plain Python values per leaf."""
    scales = scales if scales is not None else [None] * len(arrs)
    return [(tuple(int(d) for d in a.shape), _dtype_name(a), o, s)
            for a, o, s in zip(arrs, orig_names, scales)]


def _stream_body(sock: socket.socket, arrs: list) -> int:
    """Stream each leaf's raw bytes in ``_WIRE_CHUNK`` pieces; returns
    the payload bytes sent."""
    total = 0
    for a in arrs:
        mv = _bytes_view(a)
        for off in range(0, len(mv), _WIRE_CHUNK):
            sock.sendall(mv[off:off + _WIRE_CHUNK])
        total += len(mv)
    return total


def _send_arrays(sock: socket.socket, arrs: list, orig_names: list[str],
                 scales: list | None = None, tag: str = "arrays") -> int:
    """Stream a leaf list: one small pickled header frame, then the
    chunked body.  Returns bytes sent (payload only)."""
    _send(sock, (tag, _header(arrs, orig_names, scales)))
    return _stream_body(sock, arrs)


def _recv_arrays_body(sock: socket.socket, header) -> tuple[list, int]:
    """Receive the leaf bytes described by ``header``, each leaf back in
    its ORIGINAL dtype (the wire dtype never reaches the math).
    Returns (leaves, bytes received)."""
    leaves, total = [], 0
    for entry in header:
        shape, wire_name, orig_name = entry[:3]
        if len(entry) > 3 and entry[3] is not None:
            raise NotImplementedError(
                "a quantized leaf (a per-leaf scale in the header) arrived: "
                "the int8/fp8 TCP wire is not ported yet (ROADMAP.md A8)")
        shape = tuple(shape)
        count = int(np.prod(shape, dtype=np.int64))
        if wire_name == BF16:
            buf = _recv_exact(sock, 2 * count)
            a = torch.frombuffer(buf, dtype=torch.bfloat16).reshape(shape) \
                if count else torch.empty(shape, dtype=torch.bfloat16)
            if orig_name != BF16:
                a = a.to(torch.float32).numpy().astype(orig_name, copy=False)
        else:
            wdt = np.dtype(wire_name)
            buf = _recv_exact(sock, count * wdt.itemsize)
            a = np.frombuffer(buf, dtype=wdt).reshape(shape)
            if orig_name == BF16:
                a = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            elif orig_name != wire_name:
                a = a.astype(orig_name)
        leaves.append(a)
        total += len(buf)
    return leaves, total


def _routable_host() -> str:
    """Best-guess address other hosts can reach.

    ``gethostbyname(gethostname())`` resolves to 127.0.x.1 on common
    /etc/hosts layouts, which would make remote workers dial their OWN
    loopback.  The UDP connect reads the outbound interface's address
    without sending a packet; loopback-looking results fall back to it
    too."""
    try:
        name_ip = socket.gethostbyname(socket.gethostname())
    except OSError:
        name_ip = ""
    if name_ip and not name_ip.startswith("127."):
        return name_ip
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))  # never sent; routing only
            ip = s.getsockname()[0]
        if ip and not ip.startswith("127."):
            return ip
    except OSError:
        pass
    return name_ip or "127.0.0.1"


def bind_host(coordinator_host: str | None) -> str:
    """The interface a run's listeners bind: the loopback when the
    run's coordinator is on it (every process on this host; nothing
    needs to reach it from elsewhere), else every interface (the
    published address is then ``_routable_host()``)."""
    if coordinator_host in ("localhost", "::1") or (
            coordinator_host or "").startswith("127."):
        return "127.0.0.1"
    return "0.0.0.0"


class EASGDCenterServer:
    """Holds the center; serialises elastic exchanges (reference:
    EASGD_Server.run request loop).

    - 'exchange': the worker streams its leaves; the server replies
      with the PRE-exchange center (Sendrecv semantics: both sides
      update against the counterpart's old value), then applies
      ``c += alpha * (w - c)``.
    - 'get': reply with the current center (the reference's
      'copy_to_local').
    - 'stats': the backpressure snapshot.
    - 'stop': count a finished worker.

    ``center`` is a flat list of tensors or arrays; ``center_tree()``
    returns copies in the same order."""

    def __init__(self, center: list, alpha: float, host: str = "0.0.0.0",
                 port: int = 0, n_workers: int = 1):
        # copies: the elastic update mutates the center in place
        self._leaves = [l.clone() if isinstance(l, torch.Tensor)
                        else np.array(l) for l in _to_host(center)]
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self.exchanges = 0
        # the lock serialises exchanges as the reference's request
        # loop did: the queue wait is the scaling signal, tracked per
        # exchange and served by 'stats'
        self._wait_s = 0.0
        self._hold_s = 0.0
        self._max_wait_s = 0.0
        self._stopped = threading.Event()
        self.n_workers = int(n_workers)
        self._stops = 0
        self._all_stopped = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address = (
            _routable_host() if host == "0.0.0.0" else host,
            self._sock.getsockname()[1],
        )
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # -- request loop -----------------------------------------------------

    def _serve(self) -> None:
        while not self._stopped.is_set():
            try:
                self._sock.settimeout(0.2)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._client, args=(_no_delay(conn),), daemon=True
            ).start()

    def _client(self, conn: socket.socket) -> None:
        try:
            with conn:
                while True:
                    cmd, payload = _recv(conn)
                    if cmd == "exchange":
                        # payload: the wire dtype name (or None); the
                        # worker's leaves follow as a streamed body
                        _tag, header = _recv(conn)
                        worker_leaves, _ = _recv_arrays_body(conn, header)
                        try:
                            pre = self._exchange(worker_leaves)
                        except ValueError as e:
                            # reply instead of dying: a dead thread
                            # would leave the worker hung in _recv
                            _send(conn, ("error", str(e)))
                            continue
                        # the reply rides the same wire dtype; the
                        # worker upcasts to fp32
                        arrs, orig, scales = wire_cast(pre, payload)
                        _send(conn, ("ok", None))
                        _send_arrays(conn, arrs, orig, scales)
                    elif cmd == "get":
                        arrs, orig, scales = wire_cast(self.center_tree(),
                                                       None)
                        _send(conn, ("ok", None))
                        _send_arrays(conn, arrs, orig, scales)
                    elif cmd == "stats":
                        _send(conn, ("ok", self.stats()))
                    elif cmd == "stop":
                        with self._lock:
                            self._stops += 1
                            if self._stops >= self.n_workers:
                                self._all_stopped.set()
                        _send(conn, "ok")
                        return
                    else:
                        _send(conn, ("error", f"unknown cmd {cmd!r}"))
        except (ConnectionError, EOFError):
            return

    def _exchange(self, worker_leaves: list) -> list:
        a = self.alpha
        t_req = time.monotonic()
        with self._lock:  # serialise: one worker at a time (reference)
            t_acq = time.monotonic()
            if len(worker_leaves) != len(self._leaves):
                raise ValueError(
                    f"exchange: worker sent {len(worker_leaves)} leaves, "
                    f"center has {len(self._leaves)} — worker model "
                    f"config drifted from the center's"
                )
            for i, (c, w) in enumerate(zip(self._leaves, worker_leaves)):
                if tuple(w.shape) != tuple(c.shape):
                    raise ValueError(
                        f"exchange: leaf {i} shape {tuple(w.shape)} != "
                        f"center {tuple(c.shape)} — worker model config "
                        f"drifted from the center's"
                    )
            pre = [l.clone() if isinstance(l, torch.Tensor) else l.copy()
                   for l in self._leaves]
            for c, w in zip(self._leaves, worker_leaves):
                diff = a * (_cast(w, c) - c)
                c += diff
            # metrics record successful exchanges only
            self.exchanges += 1
            wait = t_acq - t_req
            self._wait_s += wait
            self._max_wait_s = max(self._max_wait_s, wait)
            self._hold_s += time.monotonic() - t_acq
        return pre

    def stats(self) -> dict:
        """Backpressure snapshot: how long workers queue behind the
        serialised exchange and how long the whole-list axpy holds the
        lock."""
        with self._lock:
            n = max(self.exchanges, 1)
            return {
                "exchanges": self.exchanges,
                "mean_wait_s": self._wait_s / n,
                "max_wait_s": self._max_wait_s,
                "mean_hold_s": self._hold_s / n,
                "stopped_workers": self._stops,
                "n_workers": self.n_workers,
            }

    # -- controller-side access -------------------------------------------

    def center_tree(self) -> list:
        """Copies of the center's leaves, in order."""
        with self._lock:
            return [l.clone() if isinstance(l, torch.Tensor) else l.copy()
                    for l in self._leaves]

    def wait_all_stopped(self, timeout: float = 300.0) -> bool:
        """Block until every registered worker has sent 'stop' (or the
        timeout).  Process 0 calls this before tearing the server down:
        exiting earlier would cut slower workers' exchanges."""
        return self._all_stopped.wait(timeout)

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass


class EASGDCenterClient:
    """Worker-side channel to the center server.

    ``wire`` (``"bfloat16"``/``torch.bfloat16``, the exchange strategy's
    wire dtype for ``asa16``/``nccl16``/``ici16``) halves every
    exchange's bytes in both directions; the elastic math stays fp32 on
    each end.  ``bytes_sent``/``bytes_received`` count the streamed
    payload bytes."""

    def __init__(self, address: tuple[str, int], connect_timeout: float = 60.0,
                 wire=None):
        self.wire_name = _wire_name(wire)
        self.bytes_sent = 0
        self.bytes_received = 0
        # retry with backoff: workers race the server's start (each
        # process builds its model first, at its own pace)
        deadline = time.monotonic() + connect_timeout
        delay = 0.1
        while True:
            try:
                self._sock = _no_delay(
                    socket.create_connection(address, timeout=60.0))
                # the connect timeout must not linger as a per-recv
                # deadline: a worker legitimately waits behind its
                # peers' exchanges
                self._sock.settimeout(None)
                return
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 2.0)

    @staticmethod
    def _check(reply):
        if isinstance(reply, tuple) and len(reply) == 2 \
                and reply[0] == "error":
            raise RuntimeError(f"center server: {reply[1]}")
        return reply

    def _recv_tree_body(self) -> list:
        _tag, header = self._check(_recv(self._sock))
        leaves, n = _recv_arrays_body(self._sock, header)
        self.bytes_received += n
        return leaves

    def get(self) -> list:
        """The current center's leaves."""
        _send(self._sock, ("get", None))
        self._check(_recv(self._sock))  # ("ok", None) or error
        return self._recv_tree_body()

    def stats(self) -> dict:
        """The server's backpressure snapshot over the wire."""
        _send(self._sock, ("stats", None))
        return self._check(_recv(self._sock))[1]

    def exchange(self, params: list, alpha: float) -> list:
        """Elastic exchange: returns the updated LOCAL leaves
        ``w - alpha*(w - c_pre)`` (the server applies its side).  fp32
        leaves travel in the wire dtype both ways; the local update
        runs on the unrounded fp32 values."""
        leaves = _to_host(params)
        _send(self._sock, ("exchange", self.wire_name))
        arrs, orig, scales = wire_cast(leaves, self.wire_name)
        self.bytes_sent += _send_arrays(self._sock, arrs, orig, scales)
        self._check(_recv(self._sock))  # ("ok", None) or error
        center_pre = self._recv_tree_body()
        return [w - alpha * (w - _cast(c, w))
                for w, c in zip(leaves, center_pre)]

    def close(self) -> None:
        try:
            _send(self._sock, ("stop", None))
            _recv(self._sock)
        except (ConnectionError, EOFError, OSError):
            pass
        self._sock.close()
