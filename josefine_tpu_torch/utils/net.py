"""Small networking helpers shared by harnesses and tests."""

from __future__ import annotations

import socket


def bound_sockets(n: int) -> tuple[list[socket.socket], list[int]]:
    """``n`` listening-ready sockets bound to port 0, KEPT OPEN.

    The pick-a-free-port-then-close-then-rebind probe races every other
    process on the box (the recorded tier-1 flake class); handing the
    still-bound socket to the server (``asyncio.start_server(sock=...)``)
    closes the window entirely. Returns (sockets, ports)."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    return socks, [s.getsockname()[1] for s in socks]
