"""PyTorch port, the double-buffered tick: the cases of
``tests/test_tick_pipeline.py`` (``tick_pipelined``: elections, exactly-once
commits under load, mixing modes only after ``tick_drain``, leader
failover) run against the port's engine (``device="cpu"``)."""

from torch_parity import repointed

globals().update(repointed("test_tick_pipeline", edits=[
    ("PARAMS = step_params(timeout_min=3, timeout_max=8, hb_ticks=1)",
     'PARAMS = step_params(timeout_min=3, timeout_max=8, hb_ticks=1, device="cpu")'),
    ("sparse_io=sparse))", 'sparse_io=sparse, device="cpu"))'),
]))
