"""Tests of the benchmark itself, on the CPU at toy sizes.

Run from the repository root: ``python -m pytest benchmark/tests -q``.
Tests marked ``gpu`` need a CUDA card and skip without one; on the card:
``python -m pytest benchmark/tests -q -m gpu``.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Toy sizes of each configuration and traffic mix, for runs on the host.
TOY = {
    "benchmark/configs/raft100k-rf5.json": {"groups": 256, "sparse_io": True},
    "benchmark/traffic/omb_topic100_1kb.json": {"topic_partitions": 16, "warmup_rounds": 8,
                                                "trace_rounds": 2, "answer_wait_s": 3},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def copy_benchmark(dst: Path) -> Path:
    """``BENCHMARK.json`` and ``benchmark/`` copied under ``dst``."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    return dst


@pytest.fixture
def toy_root(tmp_path) -> Path:
    """A copy of the benchmark with every configuration and mix at toy
    size."""
    root = copy_benchmark(tmp_path)
    for rel, edits in TOY.items():
        path = root / rel
        data = json.loads(path.read_text())
        data.update(edits)
        path.write_text(json.dumps(data))
    return root
