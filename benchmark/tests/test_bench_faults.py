"""Each cell's comparison against a broken program: a whole run on the host
at toy size, past the harness's look for a card, with the timed path
broken underneath as the window opens. Every fault and the control read
``correct: false``; the sound run reads true."""

import time

import pytest
import torch

from benchmark import harness


def _frozen_step(monkeypatch):
    """The engines' window step returns the state it was given and
    reports no row changed."""
    from josefine_tpu_torch.raft import engine as engine_mod

    real = engine_mod._sparse_window_fn

    def frozen(k_out, window):
        fn = real(k_out, window)

        def step(params, member, me, state, *rest):
            _, flat, sv, ov = fn(params, member, me, state, *rest)
            return state, torch.zeros_like(flat), sv, ov

        return step

    monkeypatch.setattr(engine_mod, "_sparse_window_fn", frozen)


def _flip(b: bytes, i: int) -> bytes:
    x = bytearray(b)
    x[i] ^= 0xFF
    return bytes(x)


def _raft_fault(kind, monkeypatch):
    def apply(cl):
        if kind == "frozen_step":
            _frozen_step(monkeypatch)
        for e in cl.engines:
            if kind == "no_exchange":
                monkeypatch.setattr(e, "receive", lambda m: None)
            elif kind == "half_dropped":
                real = e.propose
                count = [0]

                def propose(g, p, real=real, count=count):
                    count[0] += 1
                    if count[0] % 2:
                        return real(g, p)
                    fut = __import__("asyncio").get_running_loop().create_future()
                    fut.set_result(b"")
                    return fut

                monkeypatch.setattr(e, "propose", propose)
            elif kind == "altered":
                real = e.propose
                monkeypatch.setattr(e, "propose",
                                    lambda g, p, real=real: real(g, _flip(p, -1)))
    return apply


def _run(root, cell, fault=None, control=False, trace=False):
    line, _ = harness.execute(cell, 20260418, 1.5, trace, torch.device("cpu"),
                              time.perf_counter(), root=root, control=control, fault=fault)
    return line


CELL = "raft100k5.omb_topic100"


def test_sound_run_is_correct(toy_root):
    line = _run(toy_root, CELL, trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def test_control_is_not_correct(toy_root):
    line = _run(toy_root, CELL, control=True)
    assert not line["correct"]
    assert line["checks"]["missing"]["value"] > 0


FAULTS = ["frozen_step", "half_dropped", "no_exchange", "altered"]


@pytest.mark.parametrize("kind", FAULTS)
def test_raft_fault_is_not_correct(toy_root, kind, monkeypatch):
    line = _run(toy_root, CELL, fault=_raft_fault(kind, monkeypatch))
    assert not line["correct"], (kind, line["checks"])
