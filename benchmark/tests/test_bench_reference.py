"""The plain references: sound inputs read 0, a dropped record or one
flipped byte does not."""

import copy

import pytest

from benchmark.reference import replicated_log as rl


def _flip(b: bytes, i: int = -1) -> bytes:
    x = bytearray(b)
    x[i] ^= 0x01
    return bytes(x)


@pytest.fixture
def sound():
    """Two groups, three replicas, every proposal acknowledged."""
    proposals, chains = [], {}
    for g in (3, 9):
        chain, prev = [], 0
        for k in range(1, 5):
            p = rl.make_payload(g, len(proposals), bytes([k]) * 8)
            proposals.append((g, p, "acked"))
            bid = (1 << 32) | k
            chain.append((bid, prev, p))
            prev = bid
        chains[g] = chain
    applied = [d for g in (3, 9) for _, _, d in chains[g]]
    return proposals, [{"chains": copy.deepcopy(chains), "applied": list(applied)}
                       for _ in range(3)]


def test_sound_replicas_read_zero(sound):
    assert set(rl.compare(*sound).values()) == {0}


def test_a_dropped_acknowledged_entry_is_missing(sound):
    proposals, replicas = sound
    del replicas[1]["chains"][3][-1]
    n = rl.compare(proposals, replicas)
    assert n["missing"] == 1 and n["divergent"] == 1 and n["misapplied"] == 1


def test_a_flipped_byte_in_a_chain_is_altered(sound):
    proposals, replicas = sound
    bid, parent, d = replicas[2]["chains"][9][1]
    replicas[2]["chains"][9][1] = (bid, parent, _flip(d))
    n = rl.compare(proposals, replicas)
    assert n["altered"] == 1 and n["missing"] == 1 and n["divergent"] == 1


def test_a_flipped_byte_in_an_apply_is_misapplied(sound):
    proposals, replicas = sound
    replicas[0]["applied"][2] = _flip(replicas[0]["applied"][2])
    assert rl.compare(proposals, replicas)["misapplied"] >= 1


@pytest.mark.parametrize("fault", ["link", "duplicate", "order", "open"])
def test_other_faults(sound, fault):
    proposals, replicas = sound
    chain = replicas[0]["chains"][3]
    if fault == "link":
        chain[2] = (chain[2][0], 7, chain[2][2])
        key = "broken_links"
    elif fault == "duplicate":
        bid = chain[-1][0] + 1
        chain.append((bid, chain[-1][0], chain[0][2]))
        key = "duplicated"
    elif fault == "order":
        chain[1], chain[2] = (chain[1][0], chain[1][1], chain[2][2]), \
            (chain[2][0], chain[2][1], chain[1][2])
        key = "out_of_order"
    else:
        proposals.append((3, rl.make_payload(3, 99, b""), "open"))
        key = "unanswered"
    assert rl.compare(proposals, replicas)[key] >= 1

