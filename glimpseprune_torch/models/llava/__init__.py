"""LLaVA-1.5 with GlimpsePrune."""
