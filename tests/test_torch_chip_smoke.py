"""The tick-loop instruction count behind ``chip_smoke.py``'s kernel bound,
on a small hand-written SASS listing in ``cuobjdump`` format; and phases 6a,
7a, 8, 9 and 10 rehearsed on the host."""

import types

import pytest
import torch

import chip_smoke

_SASS = """
\t\tFunction : _ZN8josefine19fused_window_kernelILi{n}EEEvNS_10WindowArgsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
.L_x_1:
        /*0010*/              @P0 BRA `(.L_x_3) ;
        /*0020*/                   ISETP.GE.AND P1, PT, R2, R5, PT ;
        /*0030*/              @!P1 BRA 0x60 ;
        /*0040*/                   IMAD.MOV.U32 R3, RZ, RZ, R4 ;
        /*0050*/                   I2F R7, R3 ;
        /*0060*/                   SEL R3, R3, R4, P1 ;
        /*0070*/                   STS [R6], R3 ;
.L_x_3:
        /*0080*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0090*/                   LDS R3, [R6] ;
        /*00a0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00b0*/                   UIADD3 UR4, UR4, 0x1, URZ ;
        /*00c0*/              @P2 BRA `(.L_x_1) ;
        /*00d0*/                   EXIT ;
"""


@pytest.mark.parametrize("n", [3, 5])
def test_tick_loop_count_skips_nested_parts_only(monkeypatch, n):
    listing = _SASS.format(n=9) + _SASS.format(n=n)
    monkeypatch.setattr(chip_smoke, "subprocess", types.SimpleNamespace(
        run=lambda *a, **k: types.SimpleNamespace(stdout=listing)))
    got = chip_smoke.tick_loop_sass("lib.so", n)
    # Shortest path: the active guard's body is kept, the nested IMAD/I2F
    # part is skipped. ALU: ISETP, SEL. Issued: 10 of the 12 loop lines.
    assert got == {"ticks_per_body": 1.0, "issued": 10.0, "alu": 2.0, "imad": 0.0,
                   "issued_all": 12.0, "alu_all": 2.0, "skippable_parts": 1}


def test_tick_loop_count_needs_the_barriers(monkeypatch):
    """Without block barriers and without the shared-memory delivery a loop
    is not a tick loop."""
    listing = _SASS.format(n=5).replace("BAR.SYNC", "NOP").replace("STS [R6], R3", "LDS R3, [R6]")
    monkeypatch.setattr(chip_smoke, "subprocess", types.SimpleNamespace(
        run=lambda *a, **k: types.SimpleNamespace(stdout=listing)))
    with pytest.raises(AssertionError, match="no tick loop"):
        chip_smoke.tick_loop_sass("lib.so", 5)


def test_tick_loop_count_one_warp_barrier_per_tick(monkeypatch):
    """A kernel that delivers within the warp: no barrier instruction left
    (the __syncwarp of a reconverged warp is a NOP), one tick per body."""
    listing = _SASS.format(n=5).replace(
        "LDS R3, [R6] ;\n        /*00a0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;",
        "LDS R3, [R6] ;\n        /*00a0*/                   IADD3 R8, R8, 0x1, RZ ;").replace(
        "BAR.SYNC.DEFER_BLOCKING 0x0", "NOP")
    monkeypatch.setattr(chip_smoke, "subprocess", types.SimpleNamespace(
        run=lambda *a, **k: types.SimpleNamespace(stdout=listing)))
    got = chip_smoke.tick_loop_sass("lib.so", 5)
    # As above, with the second barrier now an IADD3 on the ALU pipe.
    assert got == {"ticks_per_body": 1.0, "issued": 10.0, "alu": 3.0, "imad": 0.0,
                   "issued_all": 12.0, "alu_all": 3.0, "skippable_parts": 1}


def test_scale_parity_runs_on_the_host(capsys):
    """Phase 6a's twin run with both clusters on the host at a tiny size: it
    compares every tick and its gates hold (a capacity overflow; fallback
    and compacted ticks and a refetch with the active set)."""
    chip_smoke.engine_parity_scale(torch.device("cpu"), P=256, ticks=60)
    out = capsys.readouterr().out
    assert out.count("scale parity ok") == 2 and "refetches" in out


def test_route_parity_runs_on_the_host(capsys):
    """Phase 7a with every side on the host at a tiny size: the fabric runs
    compare every tick (exact, routed == host-only, leases on == off on the
    wire) and their gates hold (rows routed, payload AEs from the ring, the
    scatter source checked, lease credits)."""
    chip_smoke.route_parity(torch.device("cpu"), P_dense=32, P_scale=64, ticks=50)
    out = capsys.readouterr().out
    assert out.count("route parity ok") == 3 and "host-only" in out


def test_server_parity_runs_on_the_host(capsys):
    """Phase 8a with both clusters of servers on the host at a small size:
    it compares every advance, both runs, and its gates hold (64 forwarded
    proposals, the leader stop, multi-tick advances in the windowed run)."""
    chip_smoke.server_parity(torch.device("cpu"), P=64)
    assert capsys.readouterr().out.count("server parity ok") == 2


def test_server_bench_runs_on_the_host():
    """Phase 8b's bench at a toy size on the host: the gates hold and the
    row carries the numbers phase 8 prints."""
    from josefine_tpu_torch import bench_server

    row = bench_server.run(P=64, rounds=4, warmup=2, device="cpu")
    assert row["leaders_per_group"] == {"min": 1, "max": 1} and row["dropped"] == 0
    assert row["proposals_per_round"] == 64 and row["acked"] == (2 + 4 + 0) * 64
    assert row["acked_in_timed_rounds"] > 0 and 0 < row["forwarded_frac"] < 1
    assert row["frames_per_tick"] > 0 and row["bytes_per_tick"] > 0
    assert {"dispatch", "apply", "decode"} <= set(row["profile_phases"])
    assert row["device"] == "cpu" and row["device_busy"] is None
    assert row["client_requests"]["resent"] == 0 and row["slowdown"]["max"] >= 1.0
    assert 0 < row["queue_peak"] < 1000


def test_node_parity_runs_on_the_host(capsys):
    """Phase 9a with both clusters of nodes on the host at a small size: it
    compares every advance, both runs, and its gates hold (the metadata
    leader's stop, every batch acknowledged, multi-tick advances in the
    windowed run)."""
    chip_smoke.node_parity(torch.device("cpu"), P=16, partitions=2)
    assert capsys.readouterr().out.count("node parity ok") == 2


def test_node_bench_runs_on_the_host():
    """Phase 9b's bench at a toy size on the host: three nodes started
    through ``josefine_with_config``, every acknowledged batch read back from
    all three, and the row carries the numbers phase 9 prints."""
    from josefine_tpu_torch import bench_node

    row = bench_node.run(partitions=4, batches=3, traced=1, device="cpu")
    assert row["batches_acked"] == 12 and row["records_acked"] == 12 * 16
    assert row["timed_batches"] == 8 and row["records_per_sec"] > 0 and row["mb_per_sec"] > 0
    assert row["produce_latency_ms"]["n"] == 8 and row["fetch_latency_ms"]["n"] == 12
    assert len(row["ms_per_tick"]) == 3 and row["frames_per_tick"] > 0
    assert {"dispatch", "apply", "decode"} <= set(row["profile_phases"])
    assert row["engine_partitions"] == 128 and row["device_busy"] is None


def test_chaos_parity_runs_on_the_host(capsys):
    """Phase 10a's first soak (the chaos smoke: seed 7, leader-partition,
    horizon 200, flight_wire) with both sides on the host: every field of
    the two results equal, invariants ok, coverage with the path mix."""
    chip_smoke.chaos_parity(torch.device("cpu"), smokes=chip_smoke.CHAOS_SMOKES[:1],
                            wire=False)
    assert capsys.readouterr().out.count("chaos parity ok (chaos smoke)") == 1


def test_traffic_parity_runs_on_the_host(capsys):
    """Phase 10b's twin at a small size with both sides on the host: the
    same trace and summary, and 10b's gates on both."""
    chip_smoke.traffic_parity(torch.device("cpu"), tenants=20, partitions=100, ticks=40)
    assert capsys.readouterr().out.count("traffic parity ok") == 1


def test_traffic_bench_runs_on_the_host():
    """Phase 10b's bench at a toy size on the host: the gates hold and the
    row carries the numbers phase 10 prints."""
    row = chip_smoke.traffic_bench("cpu", tenants=20, partitions=100, ticks=20, device="cpu")
    assert row["engine_rows"] == 101 and row["committed"] > 0
    assert row["timed_ticks"] >= 15 and row["ms_per_tick"] > 0
    assert {"dispatch", "apply", "decode"} <= set(row["profile_ms_per_tick"])
    assert row["device_busy"] is None and row["card_ticks_begun"] == 0
    assert row["backpressure"]["errors"] == 0


def test_sharded_step_parity_runs_on_the_host(capsys):
    """Phase 11a's simulation check on meshes of host shards at a tiny
    size: the sharded cluster step at (8, 1) and (2, 4) equals the
    unsharded one every tick, and every group elects and commits."""
    chip_smoke.sharded_step_parity(torch.device("cpu"), P=64, ticks=40)
    assert capsys.readouterr().out.count("sharded step parity ok") == 2


def test_engine_mesh_parity_runs_on_the_host(capsys):
    """Phase 11a's engine twins with both sides on 8 host shards at a tiny
    size: every tick compared exactly (mirrors, state, chains, wire, the
    fabric), both meshes, and the gates hold (compacted ticks, routed rows,
    one leader per group, the per-shard wake split equal to the
    schedule)."""
    chip_smoke.engine_mesh_parity(torch.device("cpu"), P=64, ticks=60)
    assert capsys.readouterr().out.count("engine mesh parity ok") == 2


def test_podsim_bench_runs_on_the_host():
    """Phase 11b at a toy size on the host: both rows, their gates (every
    group elects and commits; the engine row's fallback rounds only at the
    heartbeat horizon) and the fields phase 11 prints."""
    rows = chip_smoke.podsim_bench("cpu", per_device=256, devices=8, engine_per_device=256,
                                   device="cpu", tenants=20, offered=16)
    sim, eng = rows["simulation"], rows["engine"]
    assert sim["P"] == 2048 and sim["mesh"] == "cpu x8" and sim["ms_per_tick"] > 0
    assert eng["leaders_after_settle"] == 2048 and eng["committed_group_advances"] > 0
    assert eng["ticks"] == 160 and len(eng["shard_wake_frac"]) == 8
    assert eng["fallback_at_ticks"] == [256]
