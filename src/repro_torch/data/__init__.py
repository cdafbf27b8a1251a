"""Messaging layer and trajectory source (paper §3.2.1)."""

from repro_torch.data.topics import Topic, Partition, MessageLog, ConsumerGroup, PartitionConsumer
