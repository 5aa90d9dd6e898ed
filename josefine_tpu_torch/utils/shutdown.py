"""Clonable broadcast shutdown signal.

Parity: reference ``src/util.rs:1-27`` (``Shutdown`` wrapping a tokio
broadcast channel). Here an ``asyncio.Event`` gives the same semantics:
any holder may trigger; all waiters wake; late waiters return immediately.
"""

from __future__ import annotations

import asyncio


class Shutdown:
    def __init__(self, event: asyncio.Event | None = None):
        self._event = event or asyncio.Event()

    def shutdown(self) -> None:
        """Signal shutdown to every holder (reference ``src/util.rs:17-20``)."""
        self._event.set()

    @property
    def is_shutdown(self) -> bool:
        return self._event.is_set()

    async def wait(self) -> None:
        """Block until shutdown is signalled (reference ``src/util.rs:22-26``)."""
        await self._event.wait()

    def clone(self) -> "Shutdown":
        return Shutdown(self._event)
