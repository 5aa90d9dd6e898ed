"""The tick-loop instruction count behind ``chip_smoke.py``'s kernel bound,
on a small hand-written SASS listing in ``cuobjdump`` format; and phase 6a's
twin run rehearsed on the host."""

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
