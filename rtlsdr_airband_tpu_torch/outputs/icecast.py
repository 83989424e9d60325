"""Icecast source client over a plain socket (reference: src/output.cpp's
libshout usage, output.cpp:56-146 connect/retry, :467-497 send + backlog).

Speaks the Icecast2 HTTP source protocol (PUT with Basic auth, the modern
equivalent of libshout's default); maintains the reference's failure
semantics: non-blocking connect with retry handled by the app's
output-check cadence, disconnect when the kernel send buffer backs up past
MAX_SHOUT_QUEUELEN bytes, and in-band metadata updates for scan-mode
frequency tags via the admin endpoint.
"""

from __future__ import annotations

import base64
import socket
import threading
import time
from urllib.parse import quote

MAX_QUEUELEN = 32768  # reference: rtl_airband.h MAX_SHOUT_QUEUELEN


class IcecastOutput:
    def __init__(
        self,
        server: str,
        port: int,
        mountpoint: str,
        username: str = "source",
        password: str = "",
        name: str = "",
        genre: str = "",
        description: str = "",
        content_type: str = "audio/mpeg",
        send_scan_freq_tags: bool = False,
        tls: str = "disabled",
    ):
        # TLS modes mirror the reference's libshout mapping
        # (config.cpp:59-93): disabled | auto (try TLS, fall back to plain) |
        # auto_no_plain (TLS only) | transport (TLS-on-connect, RFC2818) |
        # upgrade (RFC2817: plain connect, in-band Upgrade: TLS/1.0 to 101
        # Switching Protocols, then handshake on the same socket)
        self.tls = tls
        self.server = server
        self.port = port
        self.mountpoint = mountpoint if mountpoint.startswith("/") else "/" + mountpoint
        self.username = username
        self.password = password
        self.name = name
        self.genre = genre
        self.description = description
        self.content_type = content_type
        self.send_scan_freq_tags = send_scan_freq_tags
        self.sock: socket.socket | None = None
        self.last_attempt = 0.0
        # unsent bytes (partial writes never drop mid-frame data); capped at
        # MAX_QUEUELEN like libshout's queue (reference: output.cpp:467-479)
        self._queue = bytearray()
        # single-flight background metadata sender state (see send_metadata)
        self._meta_lock = threading.Lock()
        self._meta_pending: str | None = None
        self._meta_thread: threading.Thread | None = None

    # ---------------------------------------------------------- connection

    @property
    def connected(self) -> bool:
        return self.sock is not None

    def connect(self, timeout: float = 5.0) -> bool:
        """One connect attempt (the reference retries from
        output_check_thread every 10 s; the app layer calls this on that
        cadence)."""
        self.last_attempt = time.time()
        try:
            s = self._open_socket(timeout)
        except OSError:
            return False
        if s is None:
            return False
        auth = base64.b64encode(f"{self.username}:{self.password}".encode()).decode()
        headers = [
            f"PUT {quote(self.mountpoint)} HTTP/1.1",
            f"Host: {self.server}:{self.port}",
            f"Authorization: Basic {auth}",
            "User-Agent: rtlsdr-airband-tpu",
            f"Content-Type: {self.content_type}",
            "Ice-Public: 0",
            "Expect: 100-continue",
        ]
        if self.name:
            headers.append(f"Ice-Name: {self.name}")
        if self.genre:
            headers.append(f"Ice-Genre: {self.genre}")
        if self.description:
            headers.append(f"Ice-Description: {self.description}")
        try:
            s.sendall(("\r\n".join(headers) + "\r\n\r\n").encode())
            s.settimeout(timeout)
            resp = s.recv(4096).decode(errors="replace")
            if " 100 " not in resp.split("\r\n")[0] and " 200 " not in resp.split("\r\n")[0]:
                s.close()
                return False
        except OSError:
            s.close()
            return False
        s.setblocking(False)
        self.sock = s
        self._queue.clear()
        return True

    def _open_socket(self, timeout: float):
        """Plain or TLS transport per the configured mode."""
        plain = socket.create_connection((self.server, self.port), timeout=timeout)
        if self.tls in ("", "disabled", None):
            return plain
        import ssl

        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE  # reference: shout TLS without CA config
        if self.tls == "upgrade":
            return self._rfc2817_upgrade(plain, ctx, timeout)
        try:
            return ctx.wrap_socket(plain, server_hostname=self.server)
        except (OSError, ssl.SSLError):
            plain.close()
            if self.tls == "auto":  # fall back to plaintext
                try:
                    return socket.create_connection((self.server, self.port), timeout=timeout)
                except OSError:
                    return None
            return None

    def _rfc2817_upgrade(self, plain: socket.socket, ctx, timeout: float):
        """RFC2817 plain->TLS upgrade (libshout SHOUT_TLS_RFC2817; reference
        mode mapping config.cpp:59-93): OPTIONS * with ``Upgrade: TLS/1.0``
        on the plaintext connection, require ``101 Switching Protocols``,
        then run the TLS handshake on the SAME socket."""
        import ssl

        try:
            plain.settimeout(timeout)
            plain.sendall(
                (
                    f"OPTIONS * HTTP/1.1\r\nHost: {self.server}:{self.port}\r\n"
                    "Upgrade: TLS/1.0\r\nConnection: Upgrade\r\n\r\n"
                ).encode()
            )
            # read exactly through the end of the 101 header block; anything
            # after \r\n\r\n belongs to the TLS handshake
            resp = b""
            while b"\r\n\r\n" not in resp:
                chunk = plain.recv(1)
                if not chunk:
                    raise OSError("connection closed during TLS upgrade")
                resp += chunk
                if len(resp) > 8192:
                    raise OSError("oversized TLS upgrade response")
            status = resp.split(b"\r\n", 1)[0].decode(errors="replace")
            if " 101 " not in f"{status} ":
                raise OSError(f"TLS upgrade refused: {status!r}")
            return ctx.wrap_socket(plain, server_hostname=self.server)
        except (OSError, ssl.SSLError):
            plain.close()
            return None

    def disconnect(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    # ---------------------------------------------------------------- data

    def send(self, data: bytes) -> bool:
        """Queue + send encoded audio without ever truncating a frame: bytes
        the non-blocking socket can't take stay in a bounded in-process queue
        and are retried on the next call; when the backlog exceeds
        MAX_QUEUELEN, disconnect (the app's check cadence reconnects) —
        reference: libshout's queue + MAX_SHOUT_QUEUELEN disconnect,
        output.cpp:467-479."""
        if self.sock is None:
            return False
        self._queue.extend(data)
        try:
            while self._queue:
                n = self.sock.send(self._queue)
                if n <= 0:
                    break
                del self._queue[:n]
        except BlockingIOError:
            pass  # kernel buffer full; remainder stays queued
        except OSError:
            self.disconnect()
            return False
        if len(self._queue) > MAX_QUEUELEN:
            self.disconnect()
            return False
        return True

    def send_metadata(self, song: str, timeout: float = 3.0) -> bool:
        """Queue a scan-frequency 'song' tag for the background single-flight
        sender and return immediately.

        The admin metadata request needs its own connection; doing that
        synchronously would stall the audio block cadence for up to the
        connect timeout when the server is unreachable (the reference reuses
        its nonblocking shout handle instead, output.cpp:480-497).  A lone
        daemon thread drains the latest pending tag; newer tags replace
        unsent older ones (only the current frequency matters)."""
        with self._meta_lock:
            self._meta_pending = song
            if self._meta_thread is None or not self._meta_thread.is_alive():
                self._meta_thread = threading.Thread(
                    target=self._meta_worker, args=(timeout,), daemon=True, name="icecast-meta"
                )
                self._meta_thread.start()
        return True

    def _meta_worker(self, timeout: float) -> None:
        while True:
            with self._meta_lock:
                song = self._meta_pending
                self._meta_pending = None
                if song is None:
                    self._meta_thread = None
                    return
            self.send_metadata_now(song, timeout)

    def send_metadata_now(self, song: str, timeout: float = 3.0) -> bool:
        """Synchronous tag send (reference: shout_set_metadata,
        output.cpp:480-497)."""
        try:
            s = self._open_socket(timeout)  # same transport (TLS mode) as the stream
            if s is None:
                return False
            auth = base64.b64encode(f"{self.username}:{self.password}".encode()).decode()
            path = f"/admin/metadata?mode=updinfo&mount={quote(self.mountpoint)}&song={quote(song)}"
            s.sendall(
                (f"GET {path} HTTP/1.0\r\nHost: {self.server}\r\nAuthorization: Basic {auth}\r\nUser-Agent: rtlsdr-airband-tpu\r\n\r\n").encode()
            )
            s.settimeout(timeout)
            s.recv(1024)
            s.close()
            return True
        except OSError:
            return False
