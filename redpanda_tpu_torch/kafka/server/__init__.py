"""Kafka protocol server (parity with src/v/kafka/server).

Only the broker aggregate's storage half (``broker.py``) is here so far;
``KafkaServer`` comes with the protocol layer.
"""
