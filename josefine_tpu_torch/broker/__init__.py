"""Broker layer: Kafka-facing API surface over the Raft-replicated store.

Parity: reference ``src/broker/`` (SURVEY.md §2 components 17-25).
"""
