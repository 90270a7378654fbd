"""Kafka wire protocol server + embedded client (parity with src/v/kafka)."""
