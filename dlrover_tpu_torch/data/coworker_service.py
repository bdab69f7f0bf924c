"""Cross-host coworker data service: prepared batches over the master's
wire format (port of ``dlrover_tpu/data/coworker_service.py``).

Capability ref: ``atorch/atorch/service/coworker_data_service.py`` +
``atorch/protos/coworker.proto`` (GetBatchData): coworker machines run the
CPU-heavy preprocessing and ship collated batches to the training hosts,
so trainer host CPUs drive the device instead of tokenizing.

The serving host runs a :class:`CoworkerDataLoader` (its worker processes
fill the shared-memory ring locally) and a ``CoworkerDataServer`` that
drains the ring into a bounded outbox.  The reference serves the outbox
over gRPC; the port carries the same ``BatchFetch``/``BatchPayload``
messages over the control plane's standard-library transport
(``master/servicer.py``: a threaded TCP server, ``<Q``-length frames of
``(FETCH, Envelope)`` read only through the restricted unpickler, one
``BatchPayload`` frame back).  Training hosts iterate a
:class:`RemoteBatchIterator`, which prefetches on a background thread.
Delivery is pull-based work-sharing: each batch goes to exactly one
consumer, whichever asks first — the same semantics as the reference's
shared batch pool.
"""

from __future__ import annotations

import pickle
import queue
import socket
import socketserver
import threading
from typing import Dict, Iterable, Iterator

import numpy as np

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master import messages as msg
from dlrover_tpu_torch.master.servicer import recv_frame, send_frame

SERVICE = "dlrover_tpu.CoworkerData"
FETCH = f"/{SERVICE}/fetch"


def encode_batch(seq: int, batch: Dict[str, np.ndarray]) -> msg.BatchPayload:
    meta: Dict = {}
    parts = []
    offset = 0
    for key, arr in batch.items():
        arr = np.ascontiguousarray(arr)
        meta[key] = (tuple(arr.shape), arr.dtype.str, offset)
        parts.append(arr.tobytes())
        offset += arr.nbytes
    return msg.BatchPayload(seq=seq, meta=meta, data=b"".join(parts))


def decode_batch(payload: msg.BatchPayload) -> Dict[str, np.ndarray]:
    out = {}
    for key, (shape, dtype, offset) in payload.meta.items():
        size = int(np.prod(shape)) if shape else 1
        out[key] = np.frombuffer(
            payload.data, np.dtype(dtype), count=size, offset=offset
        ).reshape(shape).copy()
    return out


class _FetchHandler(socketserver.BaseRequestHandler):
    """One connection: fetch frames in, batch frames out, until the peer
    closes.  A frame that is not a ``BatchFetch`` on ``FETCH`` closes the
    connection (the client retries it as a transport failure, as it
    would an unknown gRPC method)."""

    def handle(self):
        data_server: CoworkerDataServer = self.server.data_server  # type: ignore[attr-defined]
        sock = self.request
        while True:
            try:
                data = recv_frame(sock)
            except (ConnectionError, OSError):
                return
            try:
                method, envelope = msg.safe_loads(data)
                if method != FETCH or not isinstance(
                        getattr(envelope, "payload", None), msg.BatchFetch):
                    raise pickle.UnpicklingError(f"not a fetch: {method!r}")
            except Exception as e:  # noqa: BLE001 - refused, not raised
                logger.warning("coworker server refused a request: %s", e)
                return
            try:
                send_frame(sock, pickle.dumps(data_server.fetch(envelope)))
            except (ConnectionError, OSError):
                return


class _FetchServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class CoworkerDataServer:
    """Serves batches from a local iterator to remote training hosts.

    ``source`` is any iterator of ``dict[str, np.ndarray]`` — typically a
    started :class:`CoworkerDataLoader` (whose shm ring is the local
    buffer between ITS preprocessing workers and this server).  The
    outbox is bounded: when no trainer is fetching, the producer thread
    blocks and backpressure reaches the preprocessing workers through the
    loader's own ring.
    """

    def __init__(self, source: Iterable[Dict[str, np.ndarray]],
                 port: int = 0, outbox: int = 8):
        self._source = source
        self._outbox: "queue.Queue[msg.BatchPayload]" = queue.Queue(
            maxsize=outbox
        )
        self._stop = threading.Event()
        self._seq = 0
        self._producer = threading.Thread(
            target=self._produce, name="coworker-producer", daemon=True
        )
        self._server = _FetchServer(("", port), _FetchHandler)
        self._server.data_server = self
        self.port = self._server.server_address[1]
        self._serving = threading.Thread(
            target=self._server.serve_forever, name="coworker-rpc",
            daemon=True,
        )
        self._serving.start()
        self._producer.start()
        logger.info("coworker data server on port %d", self.port)

    def _produce(self):
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                payload = encode_batch(self._seq, batch)
                self._seq += 1
                while not self._stop.is_set():
                    try:
                        self._outbox.put(payload, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # noqa: BLE001 - ship the failure to consumers
            logger.error("coworker producer failed: %s", e)
            self._put_sentinel(msg.BatchPayload(end=True, error=repr(e)))
            return
        # Exhausted: every waiting/future consumer must learn the stream
        # ended; the sentinel is re-enqueued on delivery (see fetch).
        self._put_sentinel(msg.BatchPayload(end=True))

    def _put_sentinel(self, payload: msg.BatchPayload):
        # Stop-aware: a full outbox with no consumers must not wedge the
        # producer thread forever holding an undeliverable sentinel.
        while not self._stop.is_set():
            try:
                self._outbox.put(payload, timeout=0.2)
                return
            except queue.Full:
                continue

    def fetch(self, env: msg.Envelope) -> msg.BatchPayload:
        req: msg.BatchFetch = env.payload
        try:
            payload = self._outbox.get(
                timeout=min(max(req.timeout_s, 0.1), 60.0)
            )
        except queue.Empty:
            return msg.BatchPayload(retry=True)
        if payload.end:
            # Terminal: keep the sentinel available for every consumer.
            self._outbox.put(payload)
        return payload

    def close(self):
        self._stop.set()
        self._server.shutdown()
        self._server.server_close()
        self._serving.join(timeout=5)


class RemoteBatchIterator:
    """Training-host side: iterate batches served by a CoworkerDataServer.

    A prefetch thread keeps ``prefetch`` decoded batches ready so the
    network round-trip hides behind the training step.  Raises on a
    producer error shipped in-band; ends cleanly on the server's
    end-of-stream.  Each fetch opens its own connection (as the master's
    client does), so a restarted server is reached without a reconnect
    protocol.
    """

    def __init__(self, address: str, consumer: str = "",
                 prefetch: int = 2, fetch_timeout_s: float = 5.0,
                 total_timeout_s: float = 120.0):
        self.address = address
        host, _, port = address.rpartition(":")
        self._host, self._port = (host.strip("[]") or "localhost"), int(port)
        self.consumer = consumer
        self.fetch_timeout_s = fetch_timeout_s
        self.total_timeout_s = total_timeout_s
        self._buffer: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._prefetch_loop, name="remote-batch-prefetch",
            daemon=True,
        )
        self._thread.start()

    def _request(self) -> msg.BatchPayload:
        env = msg.Envelope(payload=msg.BatchFetch(
            consumer=self.consumer, timeout_s=self.fetch_timeout_s,
        ))
        timeout = self.fetch_timeout_s + 10.0
        with socket.create_connection((self._host, self._port),
                                      timeout=timeout) as sock:
            sock.settimeout(timeout)
            send_frame(sock, pickle.dumps((FETCH, env)))
            payload = msg.safe_loads(recv_frame(sock))
        if not isinstance(payload, msg.BatchPayload):
            raise ConnectionError(
                f"not a batch: {type(payload).__name__}")
        return payload

    def _prefetch_loop(self):
        import time as _time

        try:
            idle_since = _time.monotonic()
            while not self._stop.is_set():
                try:
                    payload = self._request()
                except (ConnectionError, OSError) as e:
                    if _time.monotonic() - idle_since > self.total_timeout_s:
                        self._buffer.put(ConnectionError(
                            f"coworker service unreachable at "
                            f"{self.address}: {e}"
                        ))
                        return
                    self._stop.wait(1.0)
                    continue
                # ANY successful fetch — including a "nothing ready yet"
                # retry — proves the server alive: a slow-to-produce but
                # healthy coworker must not count toward the timeout.
                idle_since = _time.monotonic()
                if payload.retry:
                    continue
                if payload.error:
                    self._buffer.put(RuntimeError(
                        f"coworker producer failed: {payload.error}"
                    ))
                    return
                if payload.end:
                    self._buffer.put(None)
                    return
                self._buffer.put(decode_batch(payload))
        except Exception as e:  # noqa: BLE001 - a dead prefetch thread must
            # surface, not leave __iter__ blocked on the buffer forever.
            self._buffer.put(RuntimeError(
                f"coworker prefetch failed: {e!r}"
            ))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            item = self._buffer.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        self._stop.set()
