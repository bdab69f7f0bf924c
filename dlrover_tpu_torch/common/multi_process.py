"""Trainer<->agent IPC backbone: posix shared memory + unix-socket primitives.

Capability parity with the reference's shared-memory layer
(ref ``dlrover/python/common/multi_process.py:162-607``: ``SharedLock``,
``SharedQueue``, ``SharedDict``, ``SharedMemory``), redesigned rather than
translated: one generic request/response unix-socket server hosts all three
named primitives, and the shm wrapper detaches from CPython's resource tracker
so the *agent* (not the creating trainer) controls buffer lifetime — the
property Flash Checkpoint needs when a trainer dies mid-save.

This IPC stays entirely on the host and never touches the device:
the trainer drops device->host checkpoint bytes into shm, the agent persists
them; locks/queues carry only tiny control messages.
"""

from __future__ import annotations

import os
import pickle
import socket
import socketserver
import tempfile
import threading
import time
import queue as _queue
from multiprocessing import shared_memory as _mp_shm
from typing import Dict, Optional

from dlrover_tpu_torch.common.log import default_logger as logger

_SOCKET_DIR_ENV = "DLROVER_TPU_SOCKET_DIR"


def socket_dir() -> str:
    d = os.environ.get(
        _SOCKET_DIR_ENV,
        os.path.join(tempfile.gettempdir(), "dlrover_tpu", "sockets"),
    )
    os.makedirs(d, exist_ok=True)
    return d


def _socket_path(kind: str, name: str) -> str:
    # Unix socket paths are limited to ~107 chars; keep names short.
    return os.path.join(socket_dir(), f"{kind}_{name}.sock")


def retry_socket(func):
    """Retry transient connection failures (server mid-restart).

    Rides the shared RetryPolicy (flat 0.1s ticks — the server is on the
    same host, exponential backoff buys nothing here) and keeps the
    historical ``TimeoutError`` contract for callers.
    """

    def wrapped(self, *args, **kwargs):
        from dlrover_tpu_torch.common.retry import RetryError, RetryPolicy

        policy = RetryPolicy(
            max_attempts=self._retries,
            base_delay_s=0.1,
            max_delay_s=0.1,
            jitter=False,
            retryable=(ConnectionError, FileNotFoundError, socket.timeout),
            name=f"ipc:{os.path.basename(self._path)}",
            quiet=True,
        )
        try:
            return policy.call(func, self, *args, **kwargs)
        except RetryError as e:
            raise TimeoutError(
                f"cannot reach {self._path} after {self._retries} tries: "
                f"{e.last_error}"
            ) from e

    return wrapped


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        try:
            header = self.rfile.read(8)
            if len(header) < 8:
                return
            (length,) = __import__("struct").unpack("<Q", header)
            payload = self.rfile.read(length)
            method, args, kwargs = pickle.loads(payload)
            try:
                result = self.server.dispatch(method, *args, **kwargs)  # type: ignore[attr-defined]
                response = (True, result)
            except Exception as e:  # surfaced to the client
                response = (False, e)
            data = pickle.dumps(response)
            self.wfile.write(
                __import__("struct").pack("<Q", len(data)) + data
            )
        except (BrokenPipeError, ConnectionResetError):
            pass


class LocalSocketComm:
    """Base for the named primitives.

    The owner process (``create=True``, normally the agent) runs a threaded
    unix-socket server; other processes are clients of the same name.  Both
    sides expose an identical API, so callers never care which side they are.
    """

    def __init__(self, kind: str, name: str, create: bool, retries: int = 30):
        self._name = name
        self._path = _socket_path(kind, name)
        self._retries = retries
        self._server: Optional[socketserver.ThreadingUnixStreamServer] = None
        self._is_server = create
        if create:
            self._start_server()

    def _start_server(self):
        if os.path.exists(self._path):
            os.unlink(self._path)
        server = socketserver.ThreadingUnixStreamServer(self._path, _Handler)
        server.daemon_threads = True
        server.dispatch = self._dispatch  # type: ignore[attr-defined]
        self._server = server
        thread = threading.Thread(
            target=server.serve_forever, name=f"ipc-{self._name}", daemon=True
        )
        thread.start()

    def _dispatch(self, method: str, *args, **kwargs):
        return getattr(self, "_srv_" + method)(*args, **kwargs)

    @retry_socket
    def _call(self, method: str, *args, **kwargs):
        if self._is_server:
            return self._dispatch(method, *args, **kwargs)
        import struct

        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
            sock.settimeout(60.0)
            sock.connect(self._path)
            data = pickle.dumps((method, args, kwargs))
            sock.sendall(struct.pack("<Q", len(data)) + data)
            header = recv_exact(sock, 8)
            (length,) = struct.unpack("<Q", header)
            ok, result = pickle.loads(recv_exact(sock, length))
        if not ok:
            raise result
        return result

    def close(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            if os.path.exists(self._path):
                os.unlink(self._path)
            self._server = None

    def is_available(self) -> bool:
        return os.path.exists(self._path)


def _pid_alive(owner: str) -> bool:
    """Owner tokens are ``pid:thread_ident`` — check the pid still exists."""
    try:
        pid = int(owner.split(":", 1)[0])
        os.kill(pid, 0)
        return True
    except (ValueError, ProcessLookupError):
        return False
    except PermissionError:
        return True


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionResetError("ipc peer closed")
        buf += chunk
    return buf


class SharedLock(LocalSocketComm):
    """Cross-process lock, reentrant per owner.

    Every RPC is non-blocking at the server; client-side blocking acquire is
    a poll loop.  This keeps each socket round-trip instant (no server thread
    parked inside ``Lock.acquire`` racing the client's socket timeout) and
    makes a lost response harmless: the retry from the same owner just
    re-confirms ownership instead of deadlocking.
    """

    def __init__(self, name: str, create: bool = False):
        self._lock = threading.Lock() if create else None
        # Serializes the acquire/steal/release state machine: RPC handler
        # threads and the server process's own local calls run concurrently,
        # and an unguarded check-then-steal could grant two owners at once.
        self._state_guard = threading.Lock() if create else None
        self._owner: Optional[str] = None
        super().__init__("lock", name, create)

    def _srv_acquire(self, owner: str) -> bool:
        with self._state_guard:
            got = self._lock.acquire(blocking=False)
            if got:
                self._owner = owner
                return True
            if self._owner == owner:  # reentrant / lost-response retry
                return True
            if self._owner is not None and not _pid_alive(self._owner):
                # Owner died mid-critical-section (e.g. trainer SIGKILLed
                # during a shm save); the section's invariants are void
                # anyway, so hand the lock over rather than deadlocking
                # every future waiter.
                logger.warning(
                    "lock %s: stealing from dead owner %s",
                    self._name, self._owner,
                )
                self._owner = owner
                return True
            return False

    def _srv_release(self, owner: str) -> bool:
        # Only the tracked owner may release: a stale release from another
        # process must not break mutual exclusion mid-critical-section
        # (e.g. while the saver is persisting the shm arena).
        with self._state_guard:
            if self._lock.locked() and self._owner == owner:
                self._owner = None
                self._lock.release()
                return True
            return False

    def _srv_locked(self) -> bool:
        return self._lock.locked()

    def acquire(
        self, blocking: bool = True, timeout: float = 600.0
    ) -> bool:
        owner = f"{os.getpid()}:{threading.get_ident()}"
        if not blocking:
            return self._call("acquire", owner)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._call("acquire", owner):
                return True
            time.sleep(0.05)
        logger.warning("lock %s: blocking acquire timed out", self._name)
        return False

    def release(self) -> bool:
        return self._call("release", f"{os.getpid()}:{threading.get_ident()}")

    def locked(self) -> bool:
        return self._call("locked")


class SharedQueue(LocalSocketComm):
    """Cross-process FIFO (ref SharedQueue semantics)."""

    def __init__(self, name: str, create: bool = False, maxsize: int = 0):
        self._q: Optional[_queue.Queue] = (
            _queue.Queue(maxsize) if create else None
        )
        super().__init__("queue", name, create)

    def _srv_put(self, item, timeout: Optional[float]):
        self._q.put(item, timeout=timeout)

    def _srv_get(self, timeout: Optional[float]):
        try:
            return True, self._q.get(timeout=timeout)
        except _queue.Empty:
            return False, None

    def _srv_qsize(self) -> int:
        return self._q.qsize()

    def put(self, item, timeout: Optional[float] = None):
        self._call("put", item, timeout)

    def get(self, timeout: Optional[float] = None, default=None):
        ok, item = self._call("get", timeout)
        return item if ok else default

    def qsize(self) -> int:
        return self._call("qsize")

    def empty(self) -> bool:
        return self.qsize() == 0


class SharedDict(LocalSocketComm):
    """Cross-process dict (ref SharedDict semantics)."""

    def __init__(self, name: str, create: bool = False):
        self._d: Dict = {} if create else None
        self._cv = threading.Condition() if create else None
        super().__init__("dict", name, create)

    def _srv_set(self, key, value):
        with self._cv:
            self._d[key] = value
            self._cv.notify_all()

    def _srv_update(self, other: Dict):
        with self._cv:
            self._d.update(other)
            self._cv.notify_all()

    def _srv_get(self, key, default):
        with self._cv:
            return self._d.get(key, default)

    def _srv_snapshot(self) -> Dict:
        with self._cv:
            return dict(self._d)

    def set(self, key, value):
        self._call("set", key, value)

    def update(self, other: Dict):
        self._call("update", other)

    def get(self, key, default=None):
        return self._call("get", key, default)

    def snapshot(self) -> Dict:
        return self._call("snapshot")


class SharedMemory:
    """Posix shared memory detached from the resource tracker.

    CPython's ``multiprocessing.shared_memory`` registers every attach with the
    resource tracker, which unlinks segments when *any* attaching process exits
    — fatal for Flash Checkpoint, where the trainer that wrote the bytes may be
    SIGKILLed while the agent still needs them (ref motivation:
    ``dlrover/python/common/multi_process.py:537-607``).  We unregister after
    create/attach and make unlinking an explicit owner decision.
    """

    def __init__(self, name: str, create: bool = False, size: int = 0):
        self.name = name
        self._shm = _mp_shm.SharedMemory(
            name=name, create=create, size=size if create else 0
        )
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(self._shm._name, "shared_memory")
        except Exception:  # pragma: no cover - tracker internals moved
            pass

    @property
    def buf(self) -> memoryview:
        return self._shm.buf

    @property
    def size(self) -> int:
        return self._shm.size

    def close(self):
        try:
            self._shm.close()
        except BufferError:
            # Outstanding memoryview exports (numpy views); drop on GC.
            logger.warning("shm %s close deferred: buffers exported", self.name)

    def unlink(self):
        try:
            # Re-register first: unlink() internally unregisters, and we
            # already unregistered at attach — avoids tracker KeyError noise.
            from multiprocessing import resource_tracker

            resource_tracker.register(self._shm._name, "shared_memory")
        except Exception:
            pass
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass


def attach_or_none(name: str) -> Optional[SharedMemory]:
    try:
        return SharedMemory(name)
    except FileNotFoundError:
        return None
