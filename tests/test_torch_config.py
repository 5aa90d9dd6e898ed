"""PyTorch port, configuration: the cases of ``tests/test_config.py`` run
against the port's ``config.py``, then the port's own ``[engine]`` rules:
the ``"torch"`` backend by default, the ``device`` setting (the card unless
asked), ``"jax"`` rejected with the accepted values named (the shipped TOML
files still say ``backend = "jax"``), ``mesh_shards > 0`` refused until the
engine shards, and the TOML file and environment layers over both."""

import pathlib

import pytest

from josefine_tpu_torch.config import EngineConfig, JosefineConfig, load_config

from torch_parity import repointed

globals().update(repointed("test_config"))


def test_engine_defaults_to_torch_on_the_card():
    cfg = JosefineConfig().validate()
    assert (cfg.engine.backend, cfg.engine.device) == ("torch", "cuda")


@pytest.mark.parametrize("backend", ["torch", "python"])
@pytest.mark.parametrize("device", ["cuda", "cuda:1", "cpu"])
def test_engine_accepts_torch_and_python_on_any_device(backend, device):
    EngineConfig(backend=backend, device=device).validate()


def test_engine_rejects_jax_naming_the_accepted_backends():
    with pytest.raises(ValueError, match="engine.backend must be 'torch' or 'python', "
                                         "got 'jax'"):
        EngineConfig(backend="jax").validate()


def test_engine_rejects_an_unknown_device():
    with pytest.raises(ValueError, match="engine.device"):
        EngineConfig(device="tpu").validate()


def test_mesh_shards_raise_until_the_engine_shards():
    """The engine shards now: ``mesh_shards`` validates when it divides the
    partitions, and a count that does not divide them still raises."""
    EngineConfig(mesh_shards=0).validate()
    EngineConfig(partitions=8, mesh_shards=2).validate()
    EngineConfig(partitions=8, mesh_shards=8, device="cpu").validate()
    with pytest.raises(ValueError, match="divisible"):
        EngineConfig(partitions=7, mesh_shards=2).validate()
    with pytest.raises(ValueError, match=">= 0"):
        EngineConfig(partitions=8, mesh_shards=-1).validate()


def test_toml_and_environment_set_backend_and_device(tmp_path):
    path = tmp_path / "node.toml"
    path.write_text('[engine]\nbackend = "python"\ndevice = "cpu"\npartitions = 4\n')
    cfg = load_config(path, environ={})
    assert (cfg.engine.backend, cfg.engine.device, cfg.engine.partitions) == \
        ("python", "cpu", 4)
    cfg = load_config(path, environ={"JOSEFINE_ENGINE_BACKEND": "torch",
                                     "JOSEFINE_ENGINE_DEVICE": "cuda:0"})
    assert (cfg.engine.backend, cfg.engine.device) == ("torch", "cuda:0")
    with pytest.raises(ValueError, match="got 'jax'"):
        load_config(path, environ={"JOSEFINE_ENGINE_BACKEND": "jax"})


REPO = pathlib.Path(__file__).resolve().parent.parent
SHIPPED = ["Config.toml", *sorted(str(p.relative_to(REPO))
                                  for p in (REPO / "examples").rglob("*.toml"))]


@pytest.mark.parametrize("name", SHIPPED)
def test_the_shipped_configs_say_jax_and_are_refused(name):
    """The TOML files in the repository are the JAX package's and name its
    backend: the port refuses them rather than reading "jax" as "torch"."""
    with pytest.raises(ValueError, match="'torch' or 'python', got 'jax'"):
        load_config(REPO / name, environ={})
