"""PyTorch/CUDA port of josefine-tpu.

The same system as the JAX package, ``josefine_tpu``: a Kafka-speaking
event stream whose cluster metadata and partitions are replicated through
batched Chained-Raft consensus, here with the (partitions x nodes) state
tensor stepped by PyTorch programs and a hand-written CUDA kernel on an
NVIDIA card. The package imports nothing of JAX or of the JAX package.

* ``josefine_tpu_torch.models`` and ``ops``: the consensus step and its
  kernel.
* ``josefine_tpu_torch.raft``: the engine bridge, the route fabric and the
  raft runtime (``JosefineRaft``).
* ``josefine_tpu_torch.broker``, ``kafka`` and ``node``: the Kafka surface,
  the partition logs and the composition root.

Start a node with ``python -m josefine_tpu_torch <config.toml>``; the
engine runs on the card unless ``[engine] device = "cpu"``.
"""

__version__ = "0.1.0"

from josefine_tpu_torch.config import JosefineConfig, load_config
from josefine_tpu_torch.utils.shutdown import Shutdown

__all__ = [
    "JosefineConfig",
    "load_config",
    "Shutdown",
    "josefine",
    "josefine_with_config",
    "run",
    "__version__",
]


async def josefine(config_path, shutdown):
    """Run a node from a TOML config file path.

    Parity: ``josefine()`` in reference ``src/lib.rs:19-28``.
    """
    return await josefine_with_config(load_config(config_path), shutdown)


async def josefine_with_config(config, shutdown):
    """Run a node from an in-memory config.

    Parity: ``josefine_with_config()`` in reference ``src/lib.rs:24-28``.
    """
    return await run(config, shutdown)


async def run(config, shutdown):
    """Wire store -> broker task -> raft task and join both.

    Parity: ``run()`` in reference ``src/lib.rs:31-56``.
    """
    from josefine_tpu_torch.node import run_node

    return await run_node(config, shutdown)
