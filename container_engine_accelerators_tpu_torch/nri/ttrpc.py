"""Minimal ttrpc + NRI-mux transport in pure Python: the port's copy of
the JAX package's nri/ttrpc.py, the same frames byte for byte.

Wire formats follow the public containerd specs:
  - ttrpc: 10-byte big-endian header (payload length u32, stream id u32,
    message type u8 [1=request, 2=response], flags u8) followed by a
    protobuf ttrpc.Request / ttrpc.Response.
  - NRI multiplexer: one unix socket trunk carrying logical connections,
    framed by an 8-byte big-endian header (conn id u32, payload length
    u32). Conn 1 carries the Plugin service (runtime -> plugin calls),
    conn 2 the Runtime service (plugin -> runtime calls).

Scope: unary RPCs only — everything NRI device injection needs.
"""

from __future__ import annotations

import logging
import queue
import socket
import struct
import threading

from container_engine_accelerators_tpu_torch.nri import (
    ttrpc_messages_pb2 as tpb,
)
from container_engine_accelerators_tpu_torch.utils.wakeq import WakeQueue

log = logging.getLogger(__name__)

MESSAGE_TYPE_REQUEST = 0x1
MESSAGE_TYPE_RESPONSE = 0x2

PLUGIN_SERVICE_CONN = 1
RUNTIME_SERVICE_CONN = 2

_MUX_HEADER = struct.Struct(">II")     # conn id, payload length
_TTRPC_HEADER = struct.Struct(">IIBB")  # length, stream id, type, flags


class Mux:
    """Logical connections over one stream socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._wlock = threading.Lock()
        # WakeQueue, not SimpleQueue: MuxConn.recv_exact does timed
        # gets, and SimpleQueue's lost wakeup would stall an RPC stream
        # a full timeout (or wedge it) when a frame's put races the
        # C-level timed wait. See utils/wakeq.py.
        self._queues: dict[int, WakeQueue] = {}
        self._closed = threading.Event()
        threading.Thread(target=self._read_loop, daemon=True,
                         name="nri-mux-read").start()

    def conn(self, conn_id: int) -> "MuxConn":
        q = self._queues.setdefault(conn_id, WakeQueue())
        return MuxConn(self, conn_id, q)

    def send(self, conn_id: int, payload: bytes) -> None:
        with self._wlock:
            self._sock.sendall(_MUX_HEADER.pack(conn_id, len(payload))
                               + payload)

    def _read_exact(self, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _read_loop(self) -> None:
        try:
            while True:
                header = self._read_exact(_MUX_HEADER.size)
                if header is None:
                    break
                conn_id, length = _MUX_HEADER.unpack(header)
                payload = self._read_exact(length) if length else b""
                if payload is None:
                    break
                self._queues.setdefault(
                    conn_id, WakeQueue()).put(payload)
        except OSError:
            pass
        finally:
            self._closed.set()
            for q in self._queues.values():
                q.put(None)  # wake readers with EOF

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class MuxConn:
    """One logical conn: datagram-ish send/recv of complete mux frames.

    ttrpc messages are written as one frame each, which matches how the
    Go mux's net.Conn Write calls land for header+payload pairs coalesced
    by the ttrpc channel writer (each ttrpc message is one Write)."""

    def __init__(self, mux: Mux, conn_id: int, q: WakeQueue):
        self._mux = mux
        self._conn_id = conn_id
        self._q = q
        self._buf = b""

    def send(self, data: bytes) -> None:
        self._mux.send(self._conn_id, data)

    def recv_exact(self, n: int, timeout: float | None = None
                   ) -> bytes | None:
        while len(self._buf) < n:
            try:
                frame = self._q.get(timeout=timeout)
            except queue.Empty:
                return None
            if frame is None:
                return None
            self._buf += frame
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


def read_message(conn: MuxConn, timeout: float | None = None):
    """-> (stream_id, type, payload bytes) or None on EOF/timeout."""
    header = conn.recv_exact(_TTRPC_HEADER.size, timeout)
    if header is None:
        return None
    length, stream_id, mtype, _flags = _TTRPC_HEADER.unpack(header)
    payload = conn.recv_exact(length, timeout) if length else b""
    if payload is None:
        return None
    return stream_id, mtype, payload


def write_message(conn: MuxConn, stream_id: int, mtype: int,
                  payload: bytes) -> None:
    conn.send(_TTRPC_HEADER.pack(len(payload), stream_id, mtype, 0)
              + payload)


class TtrpcServer:
    """Serve unary handlers on one mux conn.

    handlers: {"full.service.Name": {"Method": fn(payload_bytes)->bytes}}
    """

    def __init__(self, conn: MuxConn, handlers: dict):
        self.conn = conn
        self.handlers = handlers
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True,
                                       name="ttrpc-server")
        self.thread.start()

    def stop(self):
        self._stop.set()

    def _serve(self):
        while not self._stop.is_set():
            msg = read_message(self.conn, timeout=0.5)
            if msg is None:
                if self.conn._mux._closed.is_set():
                    return
                continue
            stream_id, mtype, payload = msg
            if mtype != MESSAGE_TYPE_REQUEST:
                continue
            req = tpb.Request.FromString(payload)
            resp = tpb.Response()
            try:
                method = self.handlers[req.service][req.method]
            except KeyError:
                resp.status.code = 12  # UNIMPLEMENTED
                resp.status.message = f"{req.service}/{req.method}"
            else:
                try:
                    resp.payload = method(req.payload)
                except Exception as e:  # surfaced to the runtime
                    log.exception("handler %s/%s failed",
                                  req.service, req.method)
                    resp.status.code = 13  # INTERNAL
                    resp.status.message = str(e)
            write_message(self.conn, stream_id, MESSAGE_TYPE_RESPONSE,
                          resp.SerializeToString())


class TtrpcClient:
    """Unary client on one mux conn (one outstanding call at a time —
    all the injector needs)."""

    def __init__(self, conn: MuxConn):
        self.conn = conn
        self._stream_id = 1
        self._lock = threading.Lock()

    def call(self, service: str, method: str, payload: bytes,
             timeout: float = 10.0) -> bytes:
        with self._lock:
            stream_id = self._stream_id
            self._stream_id += 2  # client streams are odd
            req = tpb.Request(service=service, method=method,
                              payload=payload,
                              timeout_nano=int(timeout * 1e9))
            write_message(self.conn, stream_id, MESSAGE_TYPE_REQUEST,
                          req.SerializeToString())
            while True:
                msg = read_message(self.conn, timeout=timeout)
                if msg is None:
                    raise TimeoutError(f"{service}/{method}: no response")
                rid, mtype, data = msg
                if mtype != MESSAGE_TYPE_RESPONSE or rid != stream_id:
                    continue
                resp = tpb.Response.FromString(data)
                if resp.status.code:
                    raise RuntimeError(
                        f"{service}/{method}: rpc error {resp.status.code}"
                        f": {resp.status.message}")
                return resp.payload
