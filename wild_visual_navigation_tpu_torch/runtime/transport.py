"""Pub/sub transport for process-separated deployment.

A copy of wild_visual_navigation_tpu/runtime/transport.py (it imports no JAX).

The reference's fabric is ROS1 TCPROS (SURVEY.md §2.4); here the
equivalent is a thin length-prefixed frame protocol over Unix-domain
sockets (cross-process) or the native SPSC ring (in-process). One
publisher, N subscribers, latest-wins semantics per the reference's
queue_size=1 camera subscriptions.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
from typing import List, Optional


_HDR = struct.Struct("<I")


class LocalTopic:
    """In-process topic over the native ring buffer (variable-size
    records are framed into a fixed-record ring by chunking is overkill
    here — we keep a python-side latest-slot with the ring for
    fixed-size payloads and a lock for variable ones)."""

    def __init__(self, maxlen: int = 8):
        self._lock = threading.Lock()
        self._buf: List[bytes] = []
        self._maxlen = maxlen

    def publish(self, payload: bytes):
        with self._lock:
            self._buf.append(payload)
            if len(self._buf) > self._maxlen:
                self._buf.pop(0)

    def poll(self) -> Optional[bytes]:
        with self._lock:
            if not self._buf:
                return None
            return self._buf.pop(0)


class SocketPublisher:
    """Unix-domain-socket publisher: accepts subscribers on `path` and
    pushes length-prefixed frames to each."""

    def __init__(self, path: str):
        self._path = path
        if os.path.exists(path):
            os.unlink(path)
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(path)
        self._srv.listen(8)
        self._srv.settimeout(0.05)
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        self._accepting = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while self._accepting:
            try:
                conn, _ = self._srv.accept()
                # bounded send: a subscriber that stops draining must
                # not block publish() (and, through the shared lock,
                # this accept loop) forever — on timeout the frame is
                # dropped for that subscriber (latest-wins semantics)
                conn.settimeout(0.2)
                with self._lock:
                    self._conns.append(conn)
            except socket.timeout:
                continue
            except OSError:
                break

    def publish(self, payload: bytes):
        dead = []
        with self._lock:
            for c in self._conns:
                try:
                    c.sendall(_HDR.pack(len(payload)) + payload)
                except socket.timeout:
                    # stalled subscriber: drop this frame for it; a
                    # partial write corrupts its stream framing, so
                    # disconnect it entirely rather than desync
                    dead.append(c)
                except OSError:
                    dead.append(c)
            for c in dead:
                self._conns.remove(c)
                try:
                    c.close()
                except OSError:
                    pass

    def close(self):
        self._accepting = False
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            for c in self._conns:
                try:
                    c.close()
                except OSError:
                    pass
        if os.path.exists(self._path):
            os.unlink(self._path)


class SocketSubscriber:
    """Blocking-read subscriber with an internal drain thread and a
    bounded latest-wins queue."""

    def __init__(self, path: str, maxlen: int = 8, connect_timeout: float = 10.0):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        deadline = connect_timeout
        import time

        t0 = time.time()
        while True:
            try:
                self._sock.connect(path)
                break
            except (FileNotFoundError, ConnectionRefusedError):
                if time.time() - t0 > deadline:
                    raise
                time.sleep(0.05)
        self._topic = LocalTopic(maxlen=maxlen)
        self._running = True
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def _read_all(self, n: int) -> Optional[bytes]:
        chunks = []
        while n > 0:
            try:
                b = self._sock.recv(n)
            except OSError:
                return None
            if not b:
                return None
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def _read_loop(self):
        while self._running:
            hdr = self._read_all(_HDR.size)
            if hdr is None:
                break
            (size,) = _HDR.unpack(hdr)
            payload = self._read_all(size)
            if payload is None:
                break
            self._topic.publish(payload)

    def poll(self) -> Optional[bytes]:
        return self._topic.poll()

    def close(self):
        self._running = False
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
