"""PyTorch port, multi-tick windows: the cases of ``tests/test_window.py``
run against the port's engine (``device="cpu"``), its ``"torch"`` backend
in the place of ``"jax"``: the windowed differential against the python
backend, term stability across long windows, commit and re-election at
window 2, the window's clamps, and the port's ``ChaosCluster`` stepping
windows under crashes and the fault model.
"""

from torch_parity import repointed

globals().update(repointed("test_window", edits=[
    ("""                   params=step_params(timeout_min=3, timeout_max=8,
                                      hb_ticks=hb_ticks),
                   base_seed=i, backend=backend, sparse_io=sparse)""",
     """                   params=step_params(timeout_min=3, timeout_max=8,
                                      hb_ticks=hb_ticks, device="cpu"),
                   base_seed=i, backend=backend, sparse_io=sparse, device="cpu")"""),
    ('jx, jfsms = make_cluster("jax", sparse)', 'jx, jfsms = make_cluster("torch", sparse)'),
    ('engines, _ = make_cluster("jax", sparse=False, hb_ticks=8)',
     'engines, _ = make_cluster("torch", sparse=False, hb_ticks=8)'),
    ('engines, fsms = make_cluster("jax", sparse=False)',
     'engines, fsms = make_cluster("torch", sparse=False)'),
    ('engines, _ = make_cluster("jax", sparse=False, hb_ticks=4)',
     'engines, _ = make_cluster("torch", sparse=False, hb_ticks=4)'),
], everywhere=[
    ("from josefine_tpu_torch.chaos.harness import ChaosCluster\n",
     "from torch_parity import HostChaosCluster as ChaosCluster\n"),
    ("hb_ticks=8))", 'hb_ticks=8, device="cpu"))'),
]))
