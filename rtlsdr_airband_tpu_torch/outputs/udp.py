"""UDP float32 audio streamer (reference: src/udp_stream.cpp).

Sends raw little-endian float32 samples — mono, or interleaved stereo —
over a non-blocking UDP socket; send errors are deliberately ignored
(reference: udp_stream.cpp:68-84 "no error checking").
"""

from __future__ import annotations

import socket

import numpy as np


class UdpStreamOutput:
    def __init__(self, dest_address: str, dest_port: int, stereo: bool = False):
        self.dest = (dest_address, dest_port)
        self.stereo = stereo
        self.sock: socket.socket | None = None
        try:
            infos = socket.getaddrinfo(dest_address, dest_port, proto=socket.IPPROTO_UDP)
            family, type_, proto, _, addr = infos[0]
            self.sock = socket.socket(family, type_, proto)
            self.sock.setblocking(False)
            self.dest = addr
        except OSError:
            self.sock = None

    def write(self, left: np.ndarray, right: np.ndarray | None = None) -> None:
        if self.sock is None:
            return
        left = np.asarray(left, np.float32)
        if self.stereo:
            r = np.asarray(right, np.float32) if right is not None else left
            buf = np.empty(left.size * 2, np.float32)
            buf[0::2] = left
            buf[1::2] = r
        else:
            buf = left
        data = buf.tobytes()
        # UDP datagrams should stay under typical MTU-ish chunks; the
        # reference sends the whole batch at once, but localhost sockets
        # reject >64 KiB datagrams — chunk at 32768 samples' worth max.
        MAX = 32768
        try:
            for i in range(0, len(data), MAX):
                self.sock.sendto(data[i : i + MAX], self.dest)
        except OSError:
            pass

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
            self.sock = None
