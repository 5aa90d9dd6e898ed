"""The tick-loop instruction count behind ``chip_smoke.py``'s kernel bound,
on a small hand-written SASS listing in ``cuobjdump`` format; phases 5c,
6a, 7a, 8, 9 and 10 rehearsed on the host; and the runner that puts the
untimed checks side by side and 10b's boot apart."""

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


def test_engine_kernel_bench_runs_on_the_host(capsys):
    """Phase 5c on the host, 3 steps a size: the integer gate holds at
    1,000 groups (a size of ``KERNEL_JAX``), each line shows 5b's window
    step, and the trace of the first size holds the host's ops."""
    from josefine_tpu_torch import bench_engine

    card = bench_engine.device_label(torch.device("cpu"))
    beside = {"P": 4096, "window_step": {"1": {"events_ms": 1.5}}}
    rows = chip_smoke.engine_kernel_bench(card, beside, sizes=(1000, 64), iters=3,
                                          device="cpu")
    assert [r["P"] for r in rows] == [1000, 64]
    out = capsys.readouterr().out
    assert out.count("every integer == the JAX package's") == 1
    assert out.count("window step (1 tick): 1.500 ms by CUDA events at P=4096") == 2
    assert "cpu_op events" in out


def test_engine_kernel_gate_holds_the_jax_values():
    """5c's exact gate: the pinned JAX integers pass, one changed count
    fails, a size without constants is not gated."""
    row = {"P": 10_000, "iters": 60, **chip_smoke.KERNEL_JAX[10_000]}
    assert chip_smoke.check_kernel_row(row)
    with pytest.raises(AssertionError, match="the JAX package's"):
        chip_smoke.check_kernel_row({**row, "sparse_idle_k_out": 8192})
    assert not chip_smoke.check_kernel_row({"P": 64})


def test_scale_parity_runs_on_the_host(capsys):
    """Phase 6a's twin run with both clusters on the host at a tiny size: it
    compares every tick and its gates hold (a capacity overflow; fallback
    and compacted ticks and a refetch with the active set)."""
    chip_smoke.engine_parity_scale(torch.device("cpu"), P=256, ticks=60)
    out = capsys.readouterr().out
    assert out.count("scale parity ok") == 2 and "refetches" in out


def test_pipelined_parity_runs_on_the_host(capsys):
    """Phase 6a's pipelined twin run with both clusters on the host at a
    tiny size: every tick and the drain compared, window-4 ticks reached."""
    chip_smoke.engine_parity_pipelined(torch.device("cpu"), P=256, ticks=100)
    assert "pipelined parity ok" in capsys.readouterr().out


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


def test_churn_parity_runs_on_the_host(capsys):
    """Phase 12a with both sides on the host at a tiny size: the churn round
    compared exactly after the warmup and after each round."""
    chip_smoke.churn_parity(torch.device("cpu"), P=256)
    assert "churn parity ok: P=256 x 5" in capsys.readouterr().out


def test_churn_bench_runs_on_the_host(capsys):
    """Phase 12b at a toy size on the host: its gates hold and it prints the
    churn wall time and ms per churn tick (no exact gate below the spec)."""
    row = chip_smoke.churn_bench("cpu", P=256, rounds=2, device="cpu")
    assert row["extra"]["unconverged"] == 0 and row["extra"]["rounds"] == 2
    out = capsys.readouterr().out
    assert "ms per churn tick [cpu]" in out and "the JAX package's" not in out


def test_churn_bench_holds_the_full_spec_to_the_jax_values(monkeypatch):
    """At the full spec phase 12b requires every integer of CHURN_JAX: one
    changed digest fails it, the recorded values pass."""
    from josefine_tpu_torch import bench_churn

    row = {"value": chip_smoke.CHURN_JAX["value"], "extra": {
        **{k: v for k, v in chip_smoke.CHURN_JAX.items() if k != "value"},
        "nodes_per_partition": 5, "elections_measured": 2_000_000, "churn_wall_s": 1.0,
        "ms_per_churn_tick": 1.0}}
    monkeypatch.setattr(bench_churn, "run", lambda P, rounds, device: row)
    chip_smoke.churn_bench("card", device="cpu")
    row["extra"] = {**row["extra"], "conv_sha256": "0" * 64}
    with pytest.raises(AssertionError, match="the JAX package's"):
        chip_smoke.churn_bench("card", device="cpu")


def test_cli_smokes_run_on_the_host(capsys):
    """Phase 12c's runner with every CLI on the host, split as ``main`` runs
    it (started beside phase 10, joined, checked in phase 12): each exits 0,
    the two chaos soaks' results equal in every field and the two wire
    artifacts equal."""
    started = chip_smoke.cli_smokes_start(device="cpu")
    chip_smoke.cli_smokes_join(started)
    seconds = chip_smoke.cli_smokes(started=started)
    assert len(seconds) == 6 and "podsim_smoke" in seconds and "obs_smoke" in seconds
    assert "CLI smokes ok" in capsys.readouterr().out


def test_headline_latency_bench_runs_on_the_host(capsys):
    """Phase 6b at a toy size on the host: the row comes from
    ``headline_latency`` (with its drain rounds) and passes 5b's gates."""
    row = chip_smoke.headline_latency_bench("cpu", P=64, warmup=20, ticks=3, device="cpu")
    assert row["P"] == 64 and row["commit_latency_ticks"]["n"] > 0
    out = capsys.readouterr().out
    assert "headline latency: P=64" in out and "the JAX package's" not in out


def test_headline_latency_gate_holds_the_jax_values():
    """6b's exact gate: the pinned JAX row passes, one changed count fails."""
    chip_smoke.check_headline_latency({**chip_smoke.HEADLINE_LAT_JAX, "source": "x"})
    with pytest.raises(AssertionError, match="the JAX package's"):
        chip_smoke.check_headline_latency({**chip_smoke.HEADLINE_LAT_JAX, "n": 5364})


def test_tune_sweep_runs_on_the_host(capsys):
    """Phase 13a's runner with ``bench_tune`` on the host's plain path at a
    toy size: every point equal to stage 1's, tagged, and a winner printed."""
    summary = chip_smoke.tune_sweep("cpu", device="cpu",
                                    args=("--partitions", "12", "--windows", "8,16"))
    assert summary["extra"]["partitions"] == 12 and summary["extra"]["launches"] == 0
    out = capsys.readouterr().out
    assert out.count("tune tile:") == 6 and "tune: winner tile" in out


def test_tune_gate_fails_a_tile_that_moves_the_result():
    """13a's equality gate on a sweep taken in process: a forged digest at
    one tile fails it, a forged card tag fails it, the sweep passes."""
    from josefine_tpu_torch import bench_tune

    rows, out = bench_tune.sweep(12, (8, 16), device="cpu", emit=lambda r: None)
    data = {"card": "cpu", "summary": out, "points": rows}
    chip_smoke.check_tune(data, "cpu")
    forged = [dict(r) for r in rows]
    forged[3]["digests"] = forged[3]["digests"][:1] + ["f" * 64]
    with pytest.raises(AssertionError, match=f"tile {forged[3]['tile']}, .* differs"):
        chip_smoke.check_tune({**data, "points": forged}, "cpu")
    with pytest.raises(AssertionError, match="tagged"):
        chip_smoke.check_tune(data, "NVIDIA H100 80GB HBM3, 700.00 W")


def test_demo_gate_fails_a_refused_produce():
    demo = chip_smoke.parse_demo(
        "create: [{'name': 'demo-topic', 'error_code': 0, 'error_message': None}]\n"
        "produce: [{'index': 0, 'error_code': 6, 'base_offset': -1, 'log_append_time_ms': -1}]\n"
        "fetch hw: 0 records tail: b''\n")
    with pytest.raises(AssertionError, match="produce"):
        chip_smoke.check_demo(demo, "single-node")


def test_examples_and_drivers_run_on_the_host(capsys):
    """Phase 13b and 13c's runner with everything on the host: both
    examples with the demo (free ports), the parole driver and
    ``repro_chaos`` seed 11, each exiting 0."""
    from test_torch_examples import free_ports

    started = chip_smoke.examples_start(device="cpu", ports=free_ports())
    seconds = chip_smoke.examples_join(started)
    assert len(seconds) == 2
    out = capsys.readouterr().out
    assert "example single-node" in out and "example multi-node" in out


class _Named(Exception):
    pass


def test_checks_make_every_run_of_every_check_once(monkeypatch):
    """``CHECKS`` splits the untimed checks of phases 5a-12a over processes:
    every run of every check function is made by exactly one entry, and
    every function it names is a check."""
    names: dict = {}

    def picked(only, runs):
        names[fn] = tuple(runs)
        raise _Named

    monkeypatch.setattr(chip_smoke, "_picked", picked)
    made: dict = {}
    for _, calls in chip_smoke.CHECKS:
        for fn, kw in calls:
            assert fn in chip_smoke._CHECK_FUNCTIONS
            made.setdefault(fn, []).extend(kw.get("only") or [None])
    assert set(made) == chip_smoke._CHECK_FUNCTIONS
    for fn in ("route_parity", "server_parity", "node_parity", "engine_mesh_parity",
               "chaos_parity"):
        with pytest.raises(_Named):
            getattr(chip_smoke, fn)(torch.device("cpu"))
        assert sorted(made[fn]) == sorted(names[fn]) or made[fn] == [None], fn
    for fn, runs in made.items():
        assert len(runs) == len(set(runs)), fn


def test_a_check_names_known_runs_only():
    with pytest.raises(ValueError, match="no run named"):
        chip_smoke.route_parity(torch.device("cpu"), only=["dense"])


def test_checks_run_side_by_side_on_the_host(capsys):
    """The runner of the untimed checks, on the host at tiny sizes: each
    entry a process of its own, its output printed when it ends."""
    checks = (("12a", [("churn_parity", {"P": 64})]),
              ("7a", [("route_parity", {"P_dense": 32, "P_scale": 64, "ticks": 50,
                                        "only": ["sparse"]})]))
    seconds = chip_smoke.SideBySide(checks, device="cpu", workers=2).join()
    assert set(seconds) == {"12a", "7a"}
    out = capsys.readouterr().out
    assert "churn parity ok" in out and "route parity ok (sparse)" in out
    assert "check 12a ok in" in out and "check 7a ok in" in out


def test_a_failing_check_stops_the_rest():
    checks = (("bad", [("route_parity", {"only": ["dense"]})]),
              ("never", [("churn_parity", {"P": 64})]))
    runner = chip_smoke.SideBySide(checks, device="cpu", workers=1)
    with pytest.raises(AssertionError, match="(?s)bad exited 1.*no run named"):
        runner.join()
    assert [d[0] for d in runner.done] == ["bad"]


def test_traffic_bench_boots_apart_then_runs_on_go(capsys):
    """10b in a process of its own on the host: it waits after its boot
    until it is told to go, then runs its ticks with 10b's gates."""
    proc = chip_smoke.traffic_bench_start("cpu", tenants=20, partitions=100, ticks=20,
                                          device="cpu")
    try:
        chip_smoke.traffic_bench_booted(proc)
        assert proc.poll() is None
        row = chip_smoke.traffic_bench_finish(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert row["engine_rows"] == 101 and row["committed"] > 0 and row["timed_ticks"] >= 15
    assert "(beside the untimed checks)" in capsys.readouterr().out


def test_a_traffic_bench_that_fails_before_its_boot_ends_raises():
    proc = chip_smoke.traffic_bench_start("cpu", tenants=20, partitions=100, device="cpu",
                                          no_such_argument=1)
    with pytest.raises(AssertionError,
                       match="(?s)before its boot ended exited 1.*no_such_argument"):
        chip_smoke.traffic_bench_booted(proc)
