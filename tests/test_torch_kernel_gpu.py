"""The fused-window CUDA kernel against its plain PyTorch version, on the card.

Skips without an NVIDIA card. The machine with the card has no JAX, so this
file imports only torch and the port, and runs without the suite's
conftest (which configures JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py
"""

import pytest
import torch

from josefine_tpu_torch.models import chained_raft as tcr
from josefine_tpu_torch.models.types import LEADER, step_params
from josefine_tpu_torch.ops import fused_step


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("P,N,kw,pf", [
    (4096, 5, {}, None),
    (1003, 3, {"prevote": 0}, None),
    (4096, 3, {"hb_ticks": 32, "auto_proposals": 0}, (1, 0, 1)),
    # The edges of the kernel's 32 // N groups per warp, and a last warp that
    # holds 1 of its 6 groups.
    (4096, 1, {}, None),
    (4096, 4, {}, None),
    (4096, 7, {"prevote": 0}, None),
    (4096, 16, {}, None),
    (100_003, 5, {}, None),
])
def test_kernel_matches_plain_on_card(cuda_device, P, N, kw, pf):
    params = step_params(**{"timeout_min": 5, "timeout_max": 10, "hb_ticks": 1,
                            "auto_proposals": 4, **kw}, device=cuda_device)
    st, member = tcr.init_state(P, N, base_seed=P + N, params=params, device=cuda_device)
    ib = tcr.empty_inbox(P, N, device=cuda_device)
    props = torch.zeros((P, N), dtype=torch.int32, device=cuda_device)
    st, ib, _ = fused_step.run_ticks_fused_ref(params, member, st, ib, props, 30)
    pf = None if pf is None else torch.tensor(pf, dtype=torch.int32, device=cuda_device)
    launches = fused_step.launches
    got = fused_step.run_ticks_fused(params, member, st, ib, props, 50, peer_fresh=pf)
    torch.cuda.synchronize()
    assert fused_step.launches == launches + 1
    want = fused_step.run_ticks_fused_ref(params, member, st, ib, props, 50, peer_fresh=pf)
    for a, b in zip(got[0].leaves() + got[1].leaves(), want[0].leaves() + want[1].leaves()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[2] == want[2]
    # Election safety: at most one live leader per term in each group (a
    # deposed leader of an older term may linger until it hears the new one).
    st = got[0]
    lead = (st.role == LEADER) & st.alive
    same_term = st.term[:, :, None] == st.term[:, None, :]
    other = ~torch.eye(N, dtype=torch.bool, device=cuda_device)
    assert not bool((lead[:, :, None] & lead[:, None, :] & same_term & other).any())
