"""PyTorch port, the consumer-group coordinator
(``josefine_tpu_torch/broker/groups.py``): the cases of
``tests/test_groups.py`` run against the port's broker."""

from torch_parity import repointed

globals().update(repointed("test_groups"))
