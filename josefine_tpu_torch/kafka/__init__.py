"""Kafka protocol layer: native wire codec + internal client.

Parity: reference ``src/kafka/`` (SURVEY.md §2 components 26-28).
"""

from josefine_tpu_torch.kafka.codec import (  # noqa: F401
    ApiKey,
    ErrorCode,
    decode_request,
    decode_response,
    encode_request,
    encode_response,
    supported_apis,
)
