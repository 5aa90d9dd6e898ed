"""CLI: ``python -m josefine_tpu_torch <config.toml>``.

Parity: reference ``src/main.rs:10-52`` — positional config path, tracing
subscriber, ctrl-c wired to the Shutdown broadcast.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from josefine_tpu_torch import josefine
from josefine_tpu_torch.utils.shutdown import Shutdown
from josefine_tpu_torch.utils.tracing import get_logger, setup_tracing

log = get_logger("main")


def get_args() -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="josefine-tpu-torch",
        description="Distributed event stream (Kafka wire protocol, batched "
        "Chained-Raft consensus on an NVIDIA card through PyTorch)",
    )
    p.add_argument("config", help="path to the node's TOML config file")
    p.add_argument("--log", default=None, help="log level (TRACE/DEBUG/INFO/...)")
    return p.parse_args()


async def amain() -> None:
    args = get_args()
    setup_tracing(args.log)
    shutdown = Shutdown()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, shutdown.shutdown)
    log.info("starting node from %s", args.config)
    await josefine(args.config, shutdown)


def main() -> None:
    asyncio.run(amain())


if __name__ == "__main__":
    main()
