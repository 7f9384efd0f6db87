"""Remote result channel: the reference's RMI collector as TCP JSON lines.

A consumer process runs ``CollectorServer`` and the driver streams every CIND
to it as one JSON line over TCP (``--collector host:port``).

Framing: newline-delimited JSON objects, UTF-8.  Each result line is
``{"kind": "cind", "text": <pretty form>}``; the stream ends with
``{"kind": "end", "count": N}`` so the consumer can detect truncation.

The JAX package's ``runtime/collector.py``, copied.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading


class CollectorServer:
    """Accepts result streams; invokes ``consumer(record)`` per JSON line.

    The bind address is ``addr`` (host, port) — port 0 picks a free port,
    mirroring the reference's random RMI port probe
    (RemoteCollectorUtils.java:60-76).
    """

    def __init__(self, consumer, host: str = "127.0.0.1", port: int = 0):
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        rec = json.loads(raw.decode("utf-8"))
                    except (UnicodeDecodeError, json.JSONDecodeError):
                        rec = {"kind": "garbled", "raw": raw[:200].decode(
                            "utf-8", errors="replace")}
                    consumer(rec)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.addr = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RemoteSink:
    """Driver-side client: streams result records to a CollectorServer."""

    def __init__(self, addr: str | tuple, timeout: float = 10.0):
        if isinstance(addr, str):
            host, _, port = addr.rpartition(":")
            addr = (host or "127.0.0.1", int(port))
        self._sock = socket.create_connection(addr, timeout=timeout)
        self._file = self._sock.makefile("wb")
        self._count = 0

    def send(self, record: dict) -> None:
        self._file.write(json.dumps(record).encode("utf-8") + b"\n")
        self._count += 1

    def send_cind(self, text: str) -> None:
        self.send({"kind": "cind", "text": text})

    def close(self) -> None:
        try:
            self.send({"kind": "end", "count": self._count})
            self._file.flush()
        finally:
            self._file.close()
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
