"""PyTorch port, outbox decoding: the cases of
``tests/test_decode_differential.py`` run against the port's engine
(``device="cpu"``). On every decode of a live cluster the port's columnar
``_decode_outbox`` must give the wire bytes and send-pointer fixups of its
scalar ``_decode_outbox_reference``, also with synthetic skip rows,
device-routed cells and payload-routed AppendEntries masks."""

from torch_parity import repointed

globals().update(repointed("test_decode_differential", edits=[
    ("PARAMS = step_params(timeout_min=3, timeout_max=8, hb_ticks=1)",
     'PARAMS = step_params(timeout_min=3, timeout_max=8, hb_ticks=1, device="cpu")'),
    ("params=PARAMS, base_seed=i, sparse_io=sparse, **kw)",
     'params=PARAMS, base_seed=i, sparse_io=sparse, device="cpu", **kw)'),
    ("fsms={0: SnapFsm()})", 'fsms={0: SnapFsm()}, device="cpu")'),
]))
