"""Tensor ops: rope, attention, keep policy, compaction, KV cache."""
