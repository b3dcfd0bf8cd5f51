"""Qwen2.5-VL with GlimpsePrune."""
